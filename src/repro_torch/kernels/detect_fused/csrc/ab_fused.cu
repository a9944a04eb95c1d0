// Abnormal detection over a (P, V) time matrix: step time, masked
// per-column median, abnormal flags and an exact top-k, for Hopper.
//
// Replaces the JAX package's Pallas kernel ``ab_fused_kernel``
// (src/repro/kernels/detect_fused/kernel.py:399, bodies ``_ab_kernel``,
// ``_select_rank``, ``_extract_topk``).
//
// What bounds it on an H100: the bytes of t.  The function must read the
// (P, V) matrix once (P * V * 8 bytes in f64: 29 MB at 65536 x 56, about
// 9 us at 3.35 TB/s) and writes O(V + k).  The arithmetic is a handful of
// operations per element, but a column's selection makes several passes
// over it: read down the columns of the row-major matrix (one useful word
// per 32-byte sector) by one block per column (56 blocks on 132 SMs), the
// passes, not the bytes, would set the time.
//
// Design: every SM, coalesced reads, each column split over a cluster.
//
//   1. ab_keys — one block per 64 rows, all V columns.  It reads row tiles
//      coalesced, turns each reading into its order-preserving integer key
//      (dead rows take the +inf key) and writes the keys TRANSPOSED into a
//      (V, P) scratch buffer through a shared-memory tile, so every later
//      pass reads one column contiguously.  The same block sums each of its
//      rows' step time over the root-child columns in ``top`` order (read
//      back from the transposed keys, coalesced: from_key(to_key(x)) is x
//      bit for bit) and writes the block's max over live rows and its live
//      count.  t is read once and never again.
//   2. ab_column — one thread-block cluster of CL = 8 blocks per column
//      (__cluster_dims__), 448 blocks of 256 threads at V = 56, all on the
//      card at once.  Each block owns a slab of P / CL consecutive rows of
//      its column, read in place from the scratch buffer (contiguous; the
//      50 MB L2 holds all 29 MB of keys at the fleet shape).  Copying the
//      slabs into shared memory (64 KB each at the fleet shape) fit only
//      about half the blocks at a time, and two waves cost more than the
//      L2 reads.
//      * What bounds this kernel is instructions and barriers, not bytes:
//        a pass costs a few tens of instructions per key it scans and a
//        cluster barrier, so the design scans as few keys, and crosses as
//        few cluster barriers, as it can.
//      * Median: the mean of the ranks (n-1)/2 and n/2 by MSB-first radix
//        selection with 8-bit digits (8 digits in f64, 4 in f32).  Each
//        pass builds a 256-bin histogram per block (one atomic per warp
//        when the warp's keys share a bin, as the first digits of a column
//        mostly do); the cluster's histograms are summed through
//        distributed shared memory, in rank order, after a cluster barrier
//        (double-buffered, so one barrier a pass).  Integer sums are exact
//        in any order, so every block takes the same digit and the result
//        never changes from run to run.  8-bit digits keep the exchange at
//        8 x 1 KB a pass; 11-bit digits would save 2 of 8 passes for an 8x
//        larger exchange and a 2048-bin scan.
//      * Once a block's keys under the decided prefix number at most CAP =
//        1024 (after two or three digits of a column), the next pass
//        copies them to a list in shared memory and later passes scan only
//        that; once the cluster's keys under the prefix number at most GCAP
//        = 2048, every block copies all of them from the other blocks'
//        lists (distributed shared memory) and finishes the selection alone,
//        with no cluster barrier.  At the fleet shape that leaves a few
//        passes over the slab for the median and none for the k-th flagged
//        score.
//      * The smallest key above the lower middle one (the upper middle one
//        when the lower is not repeated past rank n/2) comes from that
//        finished list when it holds one, else from one more pass.  One
//        pass counts the flags, overwrites each slab entry with its score
//        key (0, a negative NaN that no flagged score can be, marks an
//        unflagged row), lists the flagged rows (about 2% of them) and takes
//        the column max of the live readings (``active``); when more than k
//        are flagged, the k-th best flagged score by the same selection over
//        the lists.
//      * Collect, in row order: each block counts its "above k*", "equal to
//        k*" and unflagged rows; an exclusive scan over the cluster's ranks
//        gives each block its offsets, so the column's candidates come out in
//        row order within each group.  The listed rows give the first two
//        groups (the eq rows ranked by slab row among the listed ones); the
//        slab is swept again (with block scans for the row order) only for
//        unflagged rows, when the column has fewer than k flags, or when a
//        block's flags did not fit the list.  The cluster's blocks then
//        rank-sort the list by (key desc, index asc) together.
//   3. ab_rank — the global top-k of the V sorted lists: one thread per
//      candidate counts the candidates ranked before it, list by list from
//      each list's head (the lists are sorted, so it stops at the first that
//      is not, and gives up at k), and a candidate below k is written at its
//      place: a few dozen steps per thread, where a merge of the lists is k
//      dependent steps.
//
// Exactness: keys compare exactly, the median and flags use the same
// IEEE operations as the reference (compiled with -fmad=false), and the
// ranking is total, so order, scores, count and typical match the plain
// version bit for bit.

#include <cstdint>
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int KR = 64;                // rows per ab_keys block
constexpr int KC = 32;                // columns per transposed tile
constexpr int NTK = 256;              // threads per ab_keys block
constexpr int CL = 8;                 // blocks per column (cluster size)
constexpr int NT = 256;               // threads per ab_column block
constexpr int CAP = 1024;             // keys a block lists in shared memory
constexpr int GCAP = 2048;            // cluster keys a block finishes alone
constexpr unsigned FULL = 0xffffffffu;
static_assert(NT >= 256, "ab_column's threads cover a histogram");

__device__ __forceinline__ unsigned long long to_key(double x) {
  unsigned long long b = (unsigned long long)__double_as_longlong(x);
  return (b >> 63) ? ~b : (b | (1ULL << 63));
}
__device__ __forceinline__ unsigned int to_key(float x) {
  unsigned int b = __float_as_uint(x);
  return (b >> 31) ? ~b : (b | (1u << 31));
}
__device__ __forceinline__ double from_key(unsigned long long k) {
  unsigned long long b = (k >> 63) ? (k & ~(1ULL << 63)) : ~k;
  return __longlong_as_double((long long)b);
}
__device__ __forceinline__ float from_key(unsigned int k) {
  unsigned int b = (k >> 31) ? (k & ~(1u << 31)) : ~k;
  return __uint_as_float(b);
}

template <typename T> struct Traits;
template <> struct Traits<double> {
  typedef unsigned long long K;
  __device__ static double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
};
template <> struct Traits<float> {
  typedef unsigned int K;
  __device__ static float inf() { return __int_as_float(0x7f800000); }
};

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return b > a ? b : a; }
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return b < a ? b : a; }

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}
__device__ __forceinline__ int warp_incl_scan(int x) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Block-wide reductions; every thread gets the result.  ``sh`` holds 33
// slots and is free again when the call returns.
template <typename T, typename Op>
__device__ T block_reduce(T x, T* sh, T identity, Op op) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o; o >>= 1) x = op(x, __shfl_xor_sync(FULL, x, o));
  if (lane == 0) sh[wid] = x;
  __syncthreads();
  if (wid == 0) {
    T y = lane < nw ? sh[lane] : identity;
    for (int o = 16; o; o >>= 1) y = op(y, __shfl_xor_sync(FULL, y, o));
    if (lane == 0) sh[32] = y;
  }
  __syncthreads();
  const T r = sh[32];
  __syncthreads();
  return r;
}
struct MaxOp {
  template <typename T> __device__ T operator()(T a, T b) const {
    return tmax(a, b);
  }
};
struct MinOp {
  template <typename T> __device__ T operator()(T a, T b) const {
    return tmin(a, b);
  }
};
struct SumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// Exclusive block scan of ints; *total gets the block sum.
__device__ int block_exscan(int x, int* total, int* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int inc = warp_incl_scan(x);
  if (lane == 31) sh[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    const int y = lane < nw ? sh[lane] : 0;
    const int yi = warp_incl_scan(y);
    sh[lane] = yi - y;                       // exclusive warp offsets
    if (lane == 31) sh[32] = yi;             // block total
  }
  __syncthreads();
  const int r = sh[wid] + inc - x;
  *total = sh[32];
  __syncthreads();
  return r;
}

// Add one to hist[bin] for every lane with bin >= 0.  A warp whose lanes
// all share one bin (the first digits of a column, where most keys agree)
// adds once; otherwise each lane adds its own (lanes past the decided
// prefix have bin -1 and add nothing).  All 32 lanes must call it.
__device__ __forceinline__ void hist_add(int* hist, int bin) {
  const int b0 = __shfl_sync(FULL, bin, 0);
  if (__all_sync(FULL, bin == b0)) {
    if ((threadIdx.x & 31) == 0 && b0 >= 0) atomicAdd(&hist[b0], 32);
  } else if (bin >= 0) {
    atomicAdd(&hist[bin], 1);
  }
}

template <typename K>
__device__ __forceinline__ bool better(K ka, int ia, K kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// 1. Transposed keys, per-block step-time maxima and live counts.
template <typename T>
__global__ void __launch_bounds__(NTK)
ab_keys(const T* __restrict__ t, const unsigned char* __restrict__ valid,
        const int* __restrict__ top, int ntop, int P, int V,
        typename Traits<T>::K* __restrict__ keys, T* __restrict__ part_step,
        int* __restrict__ part_live) {
  typedef typename Traits<T>::K K;
  __shared__ K tile[KC][KR + 1];
  __shared__ T vals[16][KR];
  __shared__ unsigned char live[KR];
  __shared__ T sh_t[33];
  __shared__ int sh_i[33];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * KR;
  const int nrows = min(KR, P - r0);
  const K KEY_INF = to_key(Traits<T>::inf());
  if (tid < KR)
    live[tid] = tid < nrows && (valid == nullptr || valid[r0 + tid] != 0);
  __syncthreads();

  for (int c0 = 0; c0 < V; c0 += KC) {
    const int ncols = min(KC, V - c0);
    // rows are contiguous in t: consecutive threads, consecutive columns
    for (int i = tid; i < nrows * ncols; i += NTK) {
      const int r = i / ncols, cc = i - r * ncols;
      const T x = t[(size_t)(r0 + r) * V + c0 + cc];
      tile[cc][r] = live[r] ? to_key(x) : KEY_INF;
    }
    __syncthreads();
    // columns are contiguous in keys: consecutive threads, consecutive rows
    for (int i = tid; i < ncols * KR; i += NTK) {
      const int cc = i / KR, r = i - cc * KR;
      if (r < nrows) keys[(size_t)(c0 + cc) * P + r0 + r] = tile[cc][r];
    }
    __syncthreads();
  }

  // step time: each row's root-child columns, summed one by one in ``top``
  // order, read back from the keys this block wrote (16 at a time, four
  // loaders a row)
  const int r = tid % KR, g = tid / KR;
  T acc = T(0);
  for (int j0 = 0; j0 < ntop; j0 += 16) {
    for (int jj = g; jj < 16 && j0 + jj < ntop; jj += NTK / KR) {
      const int c = top[j0 + jj];
      vals[jj][r] = (r < nrows && c >= 0 && c < V)
                        ? from_key(keys[(size_t)c * P + r0 + r]) : T(0);
    }
    __syncthreads();
    if (g == 0)
      for (int jj = 0; jj < 16 && j0 + jj < ntop; ++jj) {
        const int c = top[j0 + jj];
        if (c >= 0 && c < V) acc += vals[jj][r];
      }
    __syncthreads();
  }
  const T NEG_INF = -Traits<T>::inf();
  T s = NEG_INF;
  int nl = 0;
  if (g == 0 && r < nrows) {
    s = live[r] ? acc : T(0);
    nl = live[r];
  }
  s = block_reduce(s, sh_t, NEG_INF, MaxOp());
  nl = block_reduce(nl, sh_i, 0, SumOp());
  if (tid == 0) {
    part_step[blockIdx.x] = s;
    part_live[blockIdx.x] = nl;
  }
}

// Shared state of an ab_column block.  ``hist`` and ``xk`` are read by
// the cluster's other blocks; each is double-buffered, so a block may
// write one half while the others still read the half it wrote last.  A
// histogram half also carries, in slots 256-258, whether the block's list
// holds all its keys under the pass's prefix, the list's place in the
// block's shared memory and its length.
template <typename T>
struct ColShared {
  typedef typename Traits<T>::K K;
  int hist[2][260];
  int gh[256];
  unsigned long long xk[2][2];        // per-block values to exchange
  int nlist[CL];                      // the blocks' flagged-list lengths
  int sh_i[33];
  T sh_t[33];
  K sh_k[33];
  int cnt;                            // slots taken in a list being filled
};
constexpr int H_LISTED = 256, H_OFF = 257, H_LEN = 258;

// The cluster's exchange of two 64-bit words per block: write this
// block's words, wait for the cluster, then f(r, words of block r) for
// every block in rank order.  Every block of the cluster makes the same
// sequence of calls.
template <typename T, typename F>
__device__ void exchange(cg::cluster_group& cluster, ColShared<T>& sh,
                         int& phase, unsigned long long w0,
                         unsigned long long w1, F f) {
  unsigned long long* slot = sh.xk[phase & 1];
  ++phase;
  if (threadIdx.x == 0) {
    slot[0] = w0;
    slot[1] = w1;
  }
  cluster.sync();
  for (int r = 0; r < CL; ++r) f(r, cluster.map_shared_rank(slot, r));
}

// Slots in a shared list for the lanes of a warp with take true, in any
// order: one atomic on *counter per warp.  All 32 lanes must call it.
__device__ __forceinline__ int warp_slot(bool take, int* counter) {
  const unsigned m = __ballot_sync(FULL, take);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && m) base = atomicAdd(counter, __popc(m));
  base = __shfl_sync(FULL, base, 0);
  return base + __popc(m & ((1u << lane) - 1));
}

// The digit whose bin of the 256-bin histogram h holds ``rank``; *cum
// gets the count in the bins below it.  Every warp computes it (the same).
__device__ __forceinline__ int pick_digit(const int* h, int rank, int* cum) {
  const int lane = threadIdx.x & 31;
  int c[8], s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = h[lane * 8 + j];
    s += c[j];
  }
  const int inc = warp_incl_scan(s), exc = inc - s;
  const unsigned hit = __ballot_sync(FULL, exc <= rank && rank < inc);
  const int src_lane = __ffs(hit) - 1;
  int cu = exc, b = lane * 8 + 7;
  bool found = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (!found && rank < cu + c[j]) {
      b = lane * 8 + j;
      found = true;
    }
    if (!found) cu += c[j];
  }
  *cum = __shfl_sync(FULL, cu, src_lane);
  return __shfl_sync(FULL, b, src_lane);
}

// Copy the cluster's keys under (prefix, mask) (non-zero ones only with
// FLAGGED) from every block's list into this block's ubuf, in any order;
// list(r) gives block r's list in its own shared memory (distributed
// shared memory) and its length.  Returns how many were copied.
template <bool FLAGGED, typename T, typename K, typename L>
__device__ int gather(cg::cluster_group& cluster, ColShared<T>& sh, K* ubuf,
                      K prefix, K mask, L list) {
  constexpr int WPR = NT / 32 / CL;   // warps reading each block's list
  static_assert(WPR >= 1, "a warp for every block of the cluster");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) sh.cnt = 0;
  __syncthreads();
  const K* lst;
  int nr;
  list(warp % CL, lst, nr);
  for (int i0 = (warp / CL) * 32; i0 < nr; i0 += WPR * 32) {
    const int i = i0 + lane;
    const K key = i < nr ? lst[i] : K(0);
    const bool take =
        i < nr && (!FLAGGED || key != 0) && (key & mask) == prefix;
    const int slot = warp_slot(take, &sh.cnt);
    if (take) ubuf[slot] = key;
  }
  __syncthreads();
  const int un = sh.cnt;
  __syncthreads();
  return un;
}

// The rank-``rank`` (0-based, ascending) key among the cluster's keys:
// this block's are the ns keys of ``src`` (all of them, or with FLAGGED
// only the non-zero ones; ``lc`` of them), in its shared memory at ``base``
// or in device memory.  MSB-first radix selection with 8-bit digits, one
// pass over the block's keys per digit, the cluster's histograms summed in
// rank order.
//
// Passes cost a few tens of instructions per key scanned and a cluster
// barrier, so the keys scanned shrink as the prefix grows: a block whose
// keys under the decided prefix number at most CAP copies them to ``cbuf``
// during the next pass (when ``may_copy``) and scans only those after it;
// and once the cluster's keys under the prefix number at most GCAP and
// every block has them listed, each block copies all of them to its own
// ``ubuf`` and finishes the selection there with no cluster barrier.  With
// ``nu`` >= 0 the caller has done that copy already (nu keys in ubuf).
// *n_below gets the number of the cluster's keys strictly below the
// result, *n_equal the number equal to it, and, when the selection ended
// in ubuf and a key above the result is there, *above the smallest one
// (else ~0).  ``rank`` must be below the number of keys.
template <bool FLAGGED, typename T, typename K>
__device__ K cluster_select(cg::cluster_group& cluster, ColShared<T>& sh,
                            int& hphase, K* base, const K* src, int ns,
                            int lc, K* cbuf, bool may_copy, bool listed,
                            K* ubuf, int nu, int rank, int* n_below,
                            int* n_equal, K* above) {
  constexpr int BITS = 8 * (int)sizeof(K);
  const int tid = threadIdx.x;
  K prefix = 0, mask = 0;
  int below = 0, equal = 0;
  bool local = nu >= 0;
  int un = nu;
  if (tid == 0) sh.cnt = 0;
  __syncthreads();
  for (int shift = BITS - 8; shift >= 0; shift -= 8) {
    int b, cum;
    if (!local) {
      const int cur = hphase & 1;
      int* hist = sh.hist[cur];
      ++hphase;
      const bool copy = may_copy && lc <= CAP;
      for (int i0 = 0; i0 < ns; i0 += NT) {
        const int row = i0 + tid;
        int bin = -1;
        K key = 0;
        if (row < ns) {
          key = src[row];
          if ((!FLAGGED || key != 0) && (key & mask) == prefix)
            bin = (int)((key >> shift) & (K)0xFF);
        }
        hist_add(hist, bin);
        if (copy) {
          const int slot = warp_slot(bin >= 0, &sh.cnt);
          if (bin >= 0) cbuf[slot] = key;
        }
      }
      if (copy) {                     // the lc keys under the prefix
        src = cbuf;
        ns = lc;
        may_copy = false;
        listed = true;
      }
      if (tid == 0) {
        hist[H_LISTED] = listed;
        hist[H_OFF] = listed ? (int)(src - base) : 0;
        hist[H_LEN] = ns;
      }
      cluster.sync();
      // the cluster's histogram, summed in rank order; meanwhile the other
      // half, which no block reads any more, is cleared for the next pass
      if (tid < 256) {
        int s = 0;
        for (int r = 0; r < CL; ++r)
          s += cluster.map_shared_rank(hist, r)[tid];
        sh.gh[tid] = s;
        sh.hist[cur ^ 1][tid] = 0;
      }
      __syncthreads();
      b = pick_digit(sh.gh, rank, &cum);
      equal = sh.gh[b];
      lc = hist[b];                   // this block's keys under the prefix
    } else {
      if (tid < 256) sh.gh[tid] = 0;
      __syncthreads();
      for (int i0 = 0; i0 < un; i0 += NT) {
        const int row = i0 + tid;
        int bin = -1;
        if (row < un) {
          const K key = ubuf[row];
          if ((key & mask) == prefix) bin = (int)((key >> shift) & (K)0xFF);
        }
        hist_add(sh.gh, bin);
      }
      __syncthreads();
      b = pick_digit(sh.gh, rank, &cum);
      equal = sh.gh[b];
      __syncthreads();
    }
    rank -= cum;
    below += cum;
    prefix |= (K)b << shift;
    mask |= (K)0xFF << shift;
    if (!local && shift > 0 && equal <= GCAP) {
      const int cur = (hphase - 1) & 1;
      bool all = true;
      for (int r = 0; r < CL; ++r)
        all = all && cluster.map_shared_rank(sh.hist[cur], r)[H_LISTED];
      if (all) {
        un = gather<FLAGGED>(cluster, sh, ubuf, prefix, mask,
                             [&](int r, const K*& lst, int& nr) {
          const int* h = cluster.map_shared_rank(sh.hist[cur], r);
          lst = cluster.map_shared_rank(base + h[H_OFF], r);
          nr = h[H_LEN];
        });
        local = true;
      }
    }
  }
  // the smallest key above the result, when ubuf holds the cluster's keys
  // under a prefix of it
  K ab = ~K(0);
  if (local)
    for (int i = tid; i < un; i += NT)
      if (ubuf[i] > prefix) ab = tmin(ab, ubuf[i]);
  *above = block_reduce(ab, sh.sh_k, ~K(0), MinOp());
  *n_below = below;
  *n_equal = equal;
  return prefix;
}

// 2. One cluster per column: median, flags, the column's kc best (kc =
// min(k, P), the most a column can give).  cand_key / cand_idx hold 2V
// lists of kc slots: column c collects into list c and writes its sorted
// list to list V + c.
template <typename T>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 4)
ab_column(typename Traits<T>::K* __restrict__ keys,
          const unsigned char* __restrict__ valid, int P, int V,
          const T* __restrict__ part_step, const int* __restrict__ part_live,
          int nblk, T thd, T min_share, T step_param, int use_step, int kc,
          typename Traits<T>::K* __restrict__ cand_key,
          int* __restrict__ cand_idx, int* __restrict__ col_count,
          T* __restrict__ typical) {
  typedef typename Traits<T>::K K;
  typedef unsigned long long U;
  __shared__ ColShared<T> sh;
  extern __shared__ unsigned long long col_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.y;
  const T INF = Traits<T>::inf();
  const K KEY_INF = to_key(INF), KEY_NEG_INF = to_key(-INF);
  int hphase = 0, xphase = 0;
  for (int i = tid; i < 2 * 256; i += NT) sh.hist[i >> 8][i & 255] = 0;

  // this block's slab: rows [r0, r0 + n) of the column's keys, read and
  // rewritten in place; in shared memory the lists: cbuf (keys under a
  // radix prefix), fkey / frow (the flagged rows' score keys and slab
  // rows), ubuf (the cluster's keys under a prefix)
  const int per = (P + CL - 1) / CL;
  const int r0 = min(rank * per, P);
  const int n = min(per, P - r0);
  K* slab = keys + (size_t)c * P + r0;
  K* base = reinterpret_cast<K*>(col_smem);
  K* cbuf = base;
  K* fkey = cbuf + CAP;
  int* frow = reinterpret_cast<int*>(fkey + CAP);
  K* ubuf = reinterpret_cast<K*>(frow + CAP);

  // step time and live count from ab_keys' partials
  T sv = -INF;
  int nl = 0;
  for (int i = tid; i < nblk; i += NT) {
    sv = tmax(sv, part_step[i]);
    nl += part_live[i];
  }
  sv = block_reduce(sv, sh.sh_t, -INF, MaxOp());
  nl = block_reduce(nl, sh.sh_i, 0, SumOp());
  const T step = use_step ? step_param : (sv > T(0) ? sv : T(1e-12));
  const int n_live = nl > 1 ? nl : 1;
  const int lo_rank = (n_live - 1) / 2, hi_rank = n_live / 2;
  // a +inf key is a dead row unless the mask says the row is live
  auto live_at = [&](int i, K key) -> bool {
    return key != KEY_INF || valid == nullptr || valid[r0 + i] != 0;
  };

  // lower middle order statistic (dead rows sort last as +inf), and the
  // smallest key above it when the selection found it
  int below, equal;
  K above;
  const K lo_key = cluster_select<false>(cluster, sh, hphase, base, slab, n,
                                         n, cbuf, true, false, ubuf, -1,
                                         lo_rank, &below, &equal, &above);
  // the upper middle one: the lower one again when it is repeated past
  // rank n/2, else the smallest key above it, found in a pass over the
  // slab only when the selection did not see it
  if (hi_rank >= below + equal && above == ~K(0)) {
    for (int i = tid; i < n; i += NT) {
      const K key = slab[i];
      if (key > lo_key) above = tmin(above, key);
    }
    above = block_reduce(above, sh.sh_k, ~K(0), MinOp());
    exchange(cluster, sh, xphase, (U)above, 0,
             [&](int, const U* w) { above = tmin(above, (K)w[0]); });
  }
  const K hi_key = hi_rank < below + equal ? lo_key : above;
  const T typ = T(0.5) * (from_key(lo_key) + from_key(hi_key));
  if (rank == 0 && tid == 0) typical[c] = typ;

  // flags (as if the column were active); each slab entry becomes its
  // score key, 0 when unflagged, and the flagged ones are also listed in
  // fkey / frow (in any order) while they fit; the column max of the live
  // readings on the way
  if (tid == 0) sh.cnt = 0;
  __syncthreads();
  T cmax = -INF;
  for (int i0 = 0; i0 < n; i0 += NT) {
    const int i = i0 + tid;
    bool flagged = false;
    K score = 0;
    if (i < n) {
      const K key = slab[i];
      const bool ok = live_at(i, key);
      const T tm = ok ? from_key(key) : T(0);
      cmax = tmax(cmax, tm);
      const bool over = (tm > thd * typ) && (typ > T(0)) &&
                        ((tm - typ) / step >= min_share);
      const bool dead = (typ == T(0)) && (tm / step >= min_share);
      flagged = (over || dead) && ok;
      score = flagged ? to_key(tm - typ) : K(0);
      slab[i] = score;
    }
    const int slot = warp_slot(flagged, &sh.cnt);
    if (flagged && slot < CAP) {
      fkey[slot] = score;
      frow[slot] = i;
    }
  }
  cmax = block_reduce(cmax, sh.sh_t, -INF, MaxOp());
  int nf = sh.cnt;                    // this block's flagged rows
  int fc = 0;
  bool all_listed = true;
  {
    exchange(cluster, sh, xphase, (U)to_key(cmax), (U)nf,
             [&](int r, const U* w) {
      cmax = tmax(cmax, from_key((K)w[0]));
      fc += (int)w[1];
      all_listed = all_listed && (int)w[1] <= CAP;
      if (tid == 0) sh.nlist[r] = (int)w[1];
    });
  }
  if (!(cmax > T(0))) {               // an inactive column flags nothing
    for (int i = tid; i < n; i += NT) slab[i] = 0;
    nf = fc = 0;
    all_listed = true;
    if (tid < CL) sh.nlist[tid] = 0;
  }
  __syncthreads();
  const bool listed = nf <= CAP;      // all of them in fkey / frow
  if (rank == 0 && tid == 0) col_count[c] = fc;

  // the kc best flagged keys: those above kstar, plus the first need_eq
  // rows (ascending) whose key equals kstar
  const int m_flag = fc < kc ? fc : kc;
  K kstar = 0;
  int need_eq = 0;
  if (fc > kc) {
    int b2, e2, nu = -1;
    K unused;
    if (all_listed && fc <= GCAP)     // the column's flags in every block
      nu = gather<true>(cluster, sh, ubuf, K(0), K(0),
                        [&](int r, const K*& lst, int& nr) {
                          lst = cluster.map_shared_rank(fkey, r);
                          nr = sh.nlist[r];
                        });
    kstar = listed
        ? cluster_select<true>(cluster, sh, hphase, base, fkey, nf, nf, cbuf,
                               false, true, ubuf, nu, fc - kc, &b2, &e2,
                               &unused)
        : cluster_select<true>(cluster, sh, hphase, base, slab, n, nf, cbuf,
                               true, false, ubuf, nu, fc - kc, &b2, &e2,
                               &unused);
    need_eq = kc - (fc - b2 - e2);
  }
  const int gt_cap = m_flag - need_eq;
  const int tail_need = (kc - m_flag) < (P - fc) ? (kc - m_flag) : (P - fc);

  // this block's offsets in the column's three groups: the counts of the
  // blocks before it
  const K* gkey = listed ? fkey : slab;
  const int ng = listed ? nf : n;
  int n_gt = 0, n_eq = 0;
  for (int i = tid; i < ng; i += NT) {
    const K key = gkey[i];
    n_gt += key > kstar ? 1 : 0;
    n_eq += (need_eq > 0 && key == kstar) ? 1 : 0;
  }
  n_gt = block_reduce(n_gt, sh.sh_i, 0, SumOp());
  n_eq = block_reduce(n_eq, sh.sh_i, 0, SumOp());
  const int n_tail = n - nf;
  int gt_base = 0, eq_base = 0, tail_base = 0;
  {
    exchange(cluster, sh, xphase, (U)(unsigned)n_gt,
             (U)(unsigned)n_eq | ((U)(unsigned)n_tail << 32),
             [&](int r, const U* w) {
      if (r < rank) {
        gt_base += (int)w[0];
        eq_base += (int)(w[1] & 0xffffffffu);
        tail_base += (int)(w[1] >> 32);
      }
    });
  }

  K* ck = cand_key + (size_t)c * kc;
  int* ci = cand_idx + (size_t)c * kc;
  K* sk = cand_key + (size_t)(V + c) * kc;
  int* si = cand_idx + (size_t)(V + c) * kc;
  if (tid == 0) sh.cnt = 0;
  __syncthreads();
  if (listed) {
    // the listed rows: gt in any order; eq rows into a list of their slab
    // rows (over cbuf, free now), where a row's place among the column's
    // eq rows is eq_base plus the listed rows below it
    int* eqrow = reinterpret_cast<int*>(cbuf);
    __shared__ int n_eqrow;
    if (tid == 0) n_eqrow = 0;
    __syncthreads();
    for (int base = 0; base < nf; base += NT) {
      const int j = base + tid;
      const K key = j < nf ? fkey[j] : K(0);
      const bool is_gt = j < nf && key > kstar;
      const bool is_eq = j < nf && need_eq > 0 && key == kstar;
      const int slot = gt_base + warp_slot(is_gt, &sh.cnt);
      if (is_gt) {
        ck[slot] = key;
        ci[slot] = c * P + r0 + frow[j];
      }
      const int eslot = warp_slot(is_eq, &n_eqrow);
      if (is_eq) eqrow[eslot] = frow[j];
    }
    __syncthreads();
    const int ne = n_eqrow;
    for (int j = tid; j < ne; j += NT) {
      const int row = eqrow[j];
      int before = 0;
      for (int x = 0; x < ne; ++x) before += eqrow[x] < row ? 1 : 0;
      const int eq_rank = eq_base + before;
      if (eq_rank < need_eq) {
        ck[gt_cap + eq_rank] = kstar;
        ci[gt_cap + eq_rank] = c * P + r0 + row;
      }
    }
  }
  // a sweep of the slab in row order: the gt and eq rows when they are not
  // listed, the unflagged (tail) rows when the column needs some
  if (!listed || tail_need > 0) {
    for (int base = 0; base < n; base += NT) {
      const int i = base + tid;
      const K key = i < n ? slab[i] : K(0);
      const bool is_gt = !listed && i < n && key > kstar;
      const bool is_eq = !listed && i < n && need_eq > 0 && key == kstar;
      const bool is_tail = tail_need > 0 && i < n && key == 0;
      const int flat = c * P + r0 + i;
      const int slot = gt_base + warp_slot(is_gt, &sh.cnt);
      if (is_gt) {
        ck[slot] = key;
        ci[slot] = flat;
      }
      int tot;
      const int packed = block_exscan(
          (is_eq ? 1 : 0) | (is_tail ? (1 << 16) : 0), &tot, sh.sh_i);
      const int eq_rank = eq_base + (packed & 0xFFFF);
      const int tail_rank = tail_base + (packed >> 16);
      if (is_eq && eq_rank < need_eq) {
        ck[gt_cap + eq_rank] = key;
        ci[gt_cap + eq_rank] = flat;
      }
      if (is_tail && tail_rank < tail_need) {
        ck[m_flag + tail_rank] = KEY_NEG_INF;
        ci[m_flag + tail_rank] = flat;
      }
      eq_base += tot & 0xFFFF;
      tail_base += tot >> 16;
    }
  }
  cluster.sync();                     // orders the lists' writes too

  // rank-sort the flagged candidates by (key desc, index asc) into the
  // sorted list, the cluster's blocks together; the -inf tail is already
  // in ascending row order
  for (int i = rank * NT + tid; i < m_flag; i += CL * NT) {
    const K mk = __ldcg(ck + i);
    const int mi = __ldcg(ci + i);
    int pos = 0;
    for (int j = 0; j < m_flag; ++j)
      pos += better(__ldcg(ck + j), __ldcg(ci + j), mk, mi);
    sk[pos] = mk;
    si[pos] = mi;
  }
  for (int j = m_flag + rank * NT + tid; j < kc; j += CL * NT) {
    const bool tail = j < m_flag + tail_need;
    sk[j] = tail ? __ldcg(ck + j) : K(0);      // 0: below every real key
    si[j] = tail ? __ldcg(ci + j) : INT_MAX;
  }
}

// 3. The global top-k of the V sorted lists of kc candidates, in the
// ranking's total order: one thread per candidate counts the candidates
// ranked before it, list by list from each list's head up to the first
// that is not (the lists are sorted), and gives up once the count reaches
// k; a candidate whose count stays below k is written at that place.  The
// lists are staged in each block's shared memory when they fit (3584
// candidates at the fleet shape), read from device memory otherwise.
constexpr int NTM = 256;              // threads per ab_rank block
constexpr int RANK_SMEM_MAX = 96 * 1024;

template <typename T>
__global__ void __launch_bounds__(NTM)
ab_rank(const typename Traits<T>::K* __restrict__ cand_key,
        const int* __restrict__ cand_idx, const int* __restrict__ col_count,
        int V, int kc, int k, int staged, int* __restrict__ order,
        T* __restrict__ scores, int* __restrict__ count) {
  typedef typename Traits<T>::K K;
  extern __shared__ unsigned long long rank_smem[];
  const int tid = threadIdx.x;
  const int n = V * kc;
  const K* keys = cand_key;
  const int* idx = cand_idx;
  if (staged) {
    K* sk = reinterpret_cast<K*>(rank_smem);
    int* si = reinterpret_cast<int*>(sk + n);
    for (int i = tid; i < n; i += NTM) {
      sk[i] = cand_key[i];
      si[i] = cand_idx[i];
    }
    __syncthreads();
    keys = sk;
    idx = si;
  }
  if (blockIdx.x == 0 && tid < 32) {
    int cnt = 0;
    for (int j = tid; j < V; j += 32) cnt += col_count[j];
    cnt = warp_sum(cnt);
    if (tid == 0) *count = cnt;
  }
  const int x = blockIdx.x * NTM + tid;
  if (x >= n) return;
  const int j = x / kc;
  const K xk = keys[x];
  const int xi = idx[x];
  int r = x - j * kc;                 // the list's own entries before it
  for (int l = 0; l < V && r < k; ++l) {
    if (l == j) continue;
    const K* lk = keys + (size_t)l * kc;
    const int* li = idx + (size_t)l * kc;
    for (int q = 0; q < kc && r < k && better(lk[q], li[q], xk, xi); ++q) ++r;
  }
  if (r < k) {
    order[r] = xi;
    scores[r] = from_key(xk);
  }
}

template <typename T>
int ab_fused_impl(const T* t, const unsigned char* valid, const int* top,
                  int ntop, int P, int V, double thd, double min_share,
                  double step_time, int use_step, int k,
                  typename Traits<T>::K* keys, T* part_step, int* part_live,
                  typename Traits<T>::K* cand_key, int* cand_idx,
                  int* col_count, int* order, T* scores, int* count,
                  T* typical, cudaStream_t s) {
  typedef typename Traits<T>::K K;
  const int nblk = (P + KR - 1) / KR;
  const int kc = k < P ? k : P;
  ab_keys<T><<<nblk, NTK, 0, s>>>(t, valid, top, ntop, P, V, keys,
                                  part_step, part_live);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem =
      (size_t)CAP * (2 * sizeof(K) + sizeof(int)) + (size_t)GCAP * sizeof(K);
  // the shared-memory limits, raised once per device
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  static unsigned limits_set = 0;
  if (!(limits_set >> dev & 1u)) {
    e = cudaFuncSetAttribute(ab_column<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ab_rank<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               RANK_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    limits_set |= 1u << dev;
  }
  ab_column<T><<<dim3(CL, V), NT, smem, s>>>(
      keys, valid, P, V, part_step, part_live, nblk, (T)thd, (T)min_share,
      (T)step_time, use_step, kc, cand_key, cand_idx, col_count, typical);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = V * kc;
  const size_t rank_bytes = (size_t)n * (sizeof(K) + sizeof(int));
  const int staged = rank_bytes <= (size_t)RANK_SMEM_MAX;
  ab_rank<T><<<(n + NTM - 1) / NTM, NTM, staged ? rank_bytes : 0, s>>>(
      cand_key + (size_t)V * kc, cand_idx + (size_t)V * kc, col_count, V, kc,
      k, staged, order, scores, count);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* scalana_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#define AB_ARGS(T, K)                                                       \
  const T *t, const unsigned char *valid, const int *top, int ntop, int P, \
      int V, double thd, double min_share, double step_time, int use_step,  \
      int k, K *keys, T *part_step, int *part_live, K *cand_key,            \
      int *cand_idx, int *col_count, int *order, T *scores, int *count,     \
      T *typical, void *stream

int ab_fused_f64(AB_ARGS(double, unsigned long long)) {
  return ab_fused_impl<double>(t, valid, top, ntop, P, V, thd, min_share,
                               step_time, use_step, k, keys, part_step,
                               part_live, cand_key, cand_idx, col_count,
                               order, scores, count, typical,
                               (cudaStream_t)stream);
}

int ab_fused_f32(AB_ARGS(float, unsigned int)) {
  return ab_fused_impl<float>(t, valid, top, ntop, P, V, thd, min_share,
                              step_time, use_step, k, keys, part_step,
                              part_live, cand_key, cand_idx, col_count,
                              order, scores, count, typical,
                              (cudaStream_t)stream);
}

}  // extern "C"
