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
// operations per element.
//
// Design.  The TPU kernel holds a whole (P, 128) column tile in VMEM; at
// 65536 rows in f64 that is 64 MB, far beyond the 227 KB of shared memory
// a Hopper block can use, so this kernel tiles over rows and keeps
// nothing of the column in fast memory:
//
//   1. ab_step_partial — one block per 1024 rows: each row's step time
//      (its root-child columns summed one by one in ``top`` order), the
//      block's max over live rows and its live count.  Blocks run in no
//      order, so these are per-block partials; the max is exact in any
//      order and the counts are integers, so the result never changes
//      from run to run.
//   2. ab_column — one block of 1024 threads per vertex column.  It
//      reduces the partials (step time, live count), then finds the
//      median as the mean of the ranks (n-1)/2 and n/2 by MSB-first radix
//      selection with 8-bit digits on order-preserving integer keys: one
//      pass over the column per digit (8 in f64, 4 in f32), counting the
//      rows that still match the decided prefix in a 256-bin shared
//      histogram (warp-aggregated atomics: most rows of a column share
//      their top digits).  Dead rows take the +inf key.  The upper middle
//      rank comes from one more pass (the smallest key above the lower).
//      Then it counts the flags, selects the k-th best flagged score key
//      the same way when more than k are flagged, and collects the
//      column's k best (flagged by score, then the -inf tail of
//      unflagged rows by ascending row) in row order with block scans.
//      The column's candidates are rank-sorted by (key desc, index asc).
//   3. ab_merge — one warp merges the V sorted candidate lists into the
//      global top-k, in fixed order, and sums the flag counts.
//
// Reading a column of the row-major matrix is strided (one 8-byte word
// per 32-byte sector); the matrix fits in the 50 MB L2, so the repeated
// passes mostly hit L2.  Coalescing the reads is later work.
//
// Exactness: keys compare exactly, the median and flags use the same
// IEEE operations as the reference (compiled with -fmad=false), and the
// ranking is total, so order, scores, count and typical match the plain
// version bit for bit.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 1024;              // threads per block (step, column)
constexpr unsigned FULL = 0xffffffffu;

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
template <typename T>
__device__ __forceinline__ T warp_max(T x) {
  for (int o = 16; o; o >>= 1) x = tmax(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
template <typename T>
__device__ __forceinline__ T warp_min(T x) {
  for (int o = 16; o; o >>= 1) x = tmin(x, __shfl_xor_sync(FULL, x, o));
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
__device__ int block_sum(int x, int* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  x = warp_sum(x);
  if (lane == 0) sh[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int y = lane < nw ? sh[lane] : 0;
    y = warp_sum(y);
    if (lane == 0) sh[32] = y;
  }
  __syncthreads();
  const int r = sh[32];
  __syncthreads();
  return r;
}

template <typename T>
__device__ T block_max(T x, T* sh, T identity) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  x = warp_max(x);
  if (lane == 0) sh[wid] = x;
  __syncthreads();
  if (wid == 0) {
    T y = lane < nw ? sh[lane] : identity;
    y = warp_max(y);
    if (lane == 0) sh[32] = y;
  }
  __syncthreads();
  const T r = sh[32];
  __syncthreads();
  return r;
}

template <typename T>
__device__ T block_min(T x, T* sh, T identity) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  x = warp_min(x);
  if (lane == 0) sh[wid] = x;
  __syncthreads();
  if (wid == 0) {
    T y = lane < nw ? sh[lane] : identity;
    y = warp_min(y);
    if (lane == 0) sh[32] = y;
  }
  __syncthreads();
  const T r = sh[32];
  __syncthreads();
  return r;
}

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

// Add one to hist[bin] for every lane with bin >= 0; lanes of a warp that
// share a bin add once, together.  All 32 lanes must call it.
__device__ __forceinline__ void hist_add(int* hist, int bin) {
  const unsigned peers = __match_any_sync(FULL, bin);
  if (bin >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[bin], __popc(peers));
}

// The rank-``rank`` (0-based, ascending) key among the rows r in [0, P)
// for which key_at(r, key) returns true.  MSB-first radix selection with
// 8-bit digits: one pass over the rows per digit.  *n_below gets the
// number of those keys strictly below the result, *n_equal the number
// equal to it.  ``rank`` must be below the number of keys.
template <typename K, typename KeyAt>
__device__ K radix_select(const KeyAt& key_at, int P, int rank, int* hist,
                          int* misc, int* n_below, int* n_equal) {
  constexpr int BITS = 8 * (int)sizeof(K);
  K prefix = 0, mask = 0;
  int below = 0, equal = 0;
  for (int shift = BITS - 8; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < P; base += blockDim.x) {
      const int row = base + threadIdx.x;
      int bin = -1;
      K key;
      if (row < P && key_at(row, key) && (key & mask) == prefix)
        bin = (int)((key >> shift) & (K)0xFF);
      hist_add(hist, bin);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int c[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[lane * 8 + j];
        s += c[j];
      }
      const int inc = warp_incl_scan(s), exc = inc - s;
      const unsigned hit = __ballot_sync(FULL, exc <= rank && rank < inc);
      const int src = hit ? __ffs(hit) - 1 : 31;
      if (lane == src) {
        int cum = exc, b = lane * 8 + 7;
        for (int j = 0; j < 8; ++j) {
          if (rank < cum + c[j]) {
            b = lane * 8 + j;
            break;
          }
          cum += c[j];
        }
        misc[0] = b;
        misc[1] = cum;
        misc[2] = hist[b];
      }
    }
    __syncthreads();
    const int b = misc[0];
    rank -= misc[1];
    below += misc[1];
    equal = misc[2];
    prefix |= (K)b << shift;
    mask |= (K)0xFF << shift;
    __syncthreads();                          // hist and misc are reused
  }
  *n_below = below;
  *n_equal = equal;
  return prefix;
}

template <typename K>
__device__ __forceinline__ bool better(K ka, int ia, K kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// 1. Per-block step-time maxima and live counts.
template <typename T>
__global__ void __launch_bounds__(NT)
ab_step_partial(const T* __restrict__ t, const unsigned char* __restrict__ valid,
                const int* __restrict__ top, int ntop, int P, int V,
                T* __restrict__ part_step, int* __restrict__ part_live) {
  __shared__ T sh_t[33];
  __shared__ int sh_i[33];
  const T NEG_INF = -Traits<T>::inf();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  T s = NEG_INF;
  int live = 0;
  if (row < P) {
    const bool ok = valid == nullptr || valid[row] != 0;
    const T* r = t + (size_t)row * V;
    T acc = T(0);
    for (int j = 0; j < ntop; ++j) {
      const int c = top[j];
      if (c >= 0 && c < V) acc += r[c];
    }
    s = ok ? acc : T(0);
    live = ok ? 1 : 0;
  }
  s = block_max(s, sh_t, NEG_INF);
  live = block_sum(live, sh_i);
  if (threadIdx.x == 0) {
    part_step[blockIdx.x] = s;
    part_live[blockIdx.x] = live;
  }
}

// 2. One block per column: median, flags, the column's kc best (kc =
// min(k, P), the most a column can give).  cand_key / cand_idx hold 2V
// lists of kc slots: column c collects into list c and writes its
// sorted list to list V + c.
template <typename T>
__global__ void __launch_bounds__(NT)
ab_column(const T* __restrict__ t, const unsigned char* __restrict__ valid,
          int P, int V, const T* __restrict__ part_step,
          const int* __restrict__ part_live, int nblk, T thd, T min_share,
          T step_param, int use_step, int kc,
          typename Traits<T>::K* __restrict__ cand_key,
          int* __restrict__ cand_idx, int* __restrict__ col_count,
          T* __restrict__ typical) {
  typedef typename Traits<T>::K K;
  __shared__ int hist[256];
  __shared__ int sh_i[33];
  __shared__ T sh_t[33];
  __shared__ K sh_k[33];
  __shared__ int misc[4];
  __shared__ int n_gt_slot;
  const int c = blockIdx.x;
  const T INF = Traits<T>::inf();
  const K KEY_INF = to_key(INF), KEY_NEG_INF = to_key(-INF);

  // step time and live count from the partials
  T sv = -INF;
  int nl = 0;
  for (int i = threadIdx.x; i < nblk; i += blockDim.x) {
    sv = tmax(sv, part_step[i]);
    nl += part_live[i];
  }
  sv = block_max(sv, sh_t, -INF);
  nl = block_sum(nl, sh_i);
  const T step = use_step ? step_param : (sv > T(0) ? sv : T(1e-12));
  const int n_live = nl > 1 ? nl : 1;
  const int lo_rank = (n_live - 1) / 2, hi_rank = n_live / 2;

  const T* col = t + c;
  auto live_at = [&](int row) -> bool {
    return valid == nullptr || valid[row] != 0;
  };

  // lower middle order statistic (dead rows sort last as +inf)
  int below, equal;
  const K lo_key = radix_select<K>(
      [&](int row, K& key) -> bool {
        key = live_at(row) ? to_key(col[(size_t)row * V]) : KEY_INF;
        return true;
      },
      P, lo_rank, hist, misc, &below, &equal);

  // one pass: the column max of the live readings (``active``) and the
  // smallest key above the lower middle one (the upper middle one when
  // the lower is not repeated past rank n/2)
  T cmax = -INF;
  K above = ~K(0);
  for (int row = threadIdx.x; row < P; row += blockDim.x) {
    const bool ok = live_at(row);
    const T x = col[(size_t)row * V];
    cmax = tmax(cmax, ok ? x : T(0));
    const K key = ok ? to_key(x) : KEY_INF;
    if (key > lo_key) above = tmin(above, key);
  }
  cmax = block_max(cmax, sh_t, -INF);
  above = block_min(above, sh_k, ~K(0));
  const K hi_key = hi_rank < below + equal ? lo_key : above;
  const T typ = T(0.5) * (from_key(lo_key) + from_key(hi_key));
  if (threadIdx.x == 0) typical[c] = typ;
  const bool active = cmax > T(0);

  // flags and score keys (unflagged: -inf)
  auto score_key = [&](int row, bool& flagged) -> K {
    const bool ok = live_at(row);
    const T x = col[(size_t)row * V];
    const T tm = ok ? x : T(0);
    const bool over = (tm > thd * typ) && (typ > T(0)) &&
                      ((tm - typ) / step >= min_share);
    const bool dead = (typ == T(0)) && (tm / step >= min_share);
    flagged = (over || dead) && active && ok;
    return flagged ? to_key(tm - typ) : KEY_NEG_INF;
  };
  int fc = 0;
  for (int row = threadIdx.x; row < P; row += blockDim.x) {
    bool f;
    score_key(row, f);
    fc += f ? 1 : 0;
  }
  fc = block_sum(fc, sh_i);
  if (threadIdx.x == 0) col_count[c] = fc;

  // the kc best flagged keys: those above kstar, plus the first need_eq
  // rows (ascending) whose key equals kstar
  const int m_flag = fc < kc ? fc : kc;
  K kstar = 0;
  int need_eq = 0;
  if (fc > kc) {
    int b2, e2;
    kstar = radix_select<K>(
        [&](int row, K& key) -> bool {
          bool f;
          key = score_key(row, f);
          return f;
        },
        P, fc - kc, hist, misc, &b2, &e2);
    need_eq = kc - (fc - b2 - e2);
  }
  const int gt_cap = m_flag - need_eq;
  const int tail_need = (kc - m_flag) < (P - fc) ? (kc - m_flag) : (P - fc);

  K* ck = cand_key + (size_t)c * kc;
  int* ci = cand_idx + (size_t)c * kc;
  K* sk = cand_key + (size_t)(V + c) * kc;
  int* si = cand_idx + (size_t)(V + c) * kc;
  if (threadIdx.x == 0) n_gt_slot = 0;
  __syncthreads();
  int eq_base = 0, tail_base = 0;
  for (int base = 0; base < P; base += blockDim.x) {
    const int row = base + threadIdx.x;
    bool f = false;
    K key = 0;
    if (row < P) key = score_key(row, f);
    const bool is_gt = row < P && f && key > kstar;
    const bool is_eq = row < P && f && need_eq > 0 && key == kstar;
    const bool is_tail = row < P && !f;
    if (is_gt) {
      const int s = atomicAdd(&n_gt_slot, 1);
      ck[s] = key;
      ci[s] = c * P + row;
    }
    int tot;
    const int packed =
        block_exscan((is_eq ? 1 : 0) | (is_tail ? (1 << 16) : 0), &tot, sh_i);
    const int eq_rank = eq_base + (packed & 0xFFFF);
    const int tail_rank = tail_base + (packed >> 16);
    if (is_eq && eq_rank < need_eq) {
      ck[gt_cap + eq_rank] = key;
      ci[gt_cap + eq_rank] = c * P + row;
    }
    if (is_tail && tail_rank < tail_need) {
      ck[m_flag + tail_rank] = KEY_NEG_INF;
      ci[m_flag + tail_rank] = c * P + row;
    }
    eq_base += tot & 0xFFFF;
    tail_base += tot >> 16;
  }
  __syncthreads();

  // rank-sort the flagged candidates by (key desc, index asc) into the
  // sorted list; the -inf tail is already in ascending row order
  for (int i = threadIdx.x; i < m_flag; i += blockDim.x) {
    const K mk = ck[i];
    const int mi = ci[i];
    int rank = 0;
    for (int j = 0; j < m_flag; ++j) rank += better(ck[j], ci[j], mk, mi);
    sk[rank] = mk;
    si[rank] = mi;
  }
  for (int j = m_flag + threadIdx.x; j < kc; j += blockDim.x) {
    const bool tail = j < m_flag + tail_need;
    sk[j] = tail ? ck[j] : K(0);               // 0: below every real key
    si[j] = tail ? ci[j] : INT_MAX;
  }
}

// 3. One warp: merge the V sorted lists of kc candidates into the global
// top-k.
template <typename T>
__global__ void ab_merge(const typename Traits<T>::K* __restrict__ cand_key,
                         const int* __restrict__ cand_idx,
                         const int* __restrict__ col_count, int* heads,
                         int V, int kc, int k, int* __restrict__ order,
                         T* __restrict__ scores, int* __restrict__ count) {
  typedef typename Traits<T>::K K;
  const int lane = threadIdx.x;
  int n = 0;
  for (int j = lane; j < V; j += 32) {
    heads[j] = 0;
    n += col_count[j];
  }
  n = warp_sum(n);
  if (lane == 0) *count = n;
  __syncwarp();
  for (int i = 0; i < k; ++i) {
    K bk = 0;
    int bi = INT_MAX, bc = -1;
    for (int j = lane; j < V; j += 32) {
      const int h = heads[j];
      if (h < kc) {
        const K kk = cand_key[(size_t)j * kc + h];
        const int ii = cand_idx[(size_t)j * kc + h];
        if (bc < 0 || better(kk, ii, bk, bi)) {
          bk = kk;
          bi = ii;
          bc = j;
        }
      }
    }
    for (int o = 16; o; o >>= 1) {
      const K ok = __shfl_xor_sync(FULL, bk, o);
      const int oi = __shfl_xor_sync(FULL, bi, o);
      const int oc = __shfl_xor_sync(FULL, bc, o);
      if (oc >= 0 && (bc < 0 || better(ok, oi, bk, bi))) {
        bk = ok;
        bi = oi;
        bc = oc;
      }
    }
    if (lane == 0) {
      order[i] = bi;
      scores[i] = from_key(bk);
      if (bc >= 0) heads[bc] += 1;
    }
    __syncwarp();
  }
}

template <typename T>
int ab_fused_impl(const T* t, const unsigned char* valid, const int* top,
                  int ntop, int P, int V, double thd, double min_share,
                  double step_time, int use_step, int k, T* part_step,
                  int* part_live, typename Traits<T>::K* cand_key,
                  int* cand_idx, int* col_count, int* heads, int* order,
                  T* scores, int* count, T* typical, cudaStream_t s) {
  const int nblk = (P + NT - 1) / NT;
  const int kc = k < P ? k : P;
  ab_step_partial<T><<<nblk, NT, 0, s>>>(t, valid, top, ntop, P, V,
                                         part_step, part_live);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ab_column<T><<<V, NT, 0, s>>>(t, valid, P, V, part_step, part_live, nblk,
                                (T)thd, (T)min_share, (T)step_time, use_step,
                                kc, cand_key, cand_idx, col_count, typical);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ab_merge<T><<<1, 32, 0, s>>>(cand_key + (size_t)V * kc,
                               cand_idx + (size_t)V * kc, col_count, heads, V,
                               kc, k, order, scores, count);
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
      int k, T *part_step, int *part_live, K *cand_key, int *cand_idx,      \
      int *col_count, int *heads, int *order, T *scores, int *count,        \
      T *typical, void *stream

int ab_fused_f64(AB_ARGS(double, unsigned long long)) {
  return ab_fused_impl<double>(t, valid, top, ntop, P, V, thd, min_share,
                               step_time, use_step, k, part_step, part_live,
                               cand_key, cand_idx, col_count, heads, order,
                               scores, count, typical, (cudaStream_t)stream);
}

int ab_fused_f32(AB_ARGS(float, unsigned int)) {
  return ab_fused_impl<float>(t, valid, top, ntop, P, V, thd, min_share,
                              step_time, use_step, k, part_step, part_live,
                              cand_key, cand_idx, col_count, heads, order,
                              scores, count, typical, (cudaStream_t)stream);
}

}  // extern "C"
