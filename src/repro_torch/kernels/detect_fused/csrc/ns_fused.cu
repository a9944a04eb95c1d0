// Non-scalable detection: per-scale merges over rows, historical-column
// splice, closed-form log-log slope fit, share and flags, for Hopper, in
// one launch.
//
// Replaces the JAX package's Pallas kernel ``ns_fused_kernel``
// (src/repro/kernels/detect_fused/kernel.py:227, body ``_ns_kernel`` at
// :170), and, run without its tail, the jitted ``merge_scale_column``
// (src/repro/kernels/detect_fused/ops.py:334).
//
// What bounds it on an H100: the bytes of t and var.  The function reads
// the (S_d, P, V) time and variance stacks once (2 * S_d * P * V * 8 bytes
// in f64: 58.7 MB for one 65536 x 56 scale, 17.5 us at 3.35 TB/s) and
// writes O(S * V); a few operations per element.
//
// Design: one launch over every SM, a fixed-order two-stage reduction.
//   1. Every block takes one tile of TP = 256 rows of one scale (a grid of
//      (ceil(P / TP), S_d) blocks: 256 at the fleet's P = 65536, all
//      resident at once).  Its 256 threads stay on one column each: with V
//      <= 256, ``256 / V`` row groups of V threads, so that a warp reads
//      neighbouring columns of neighbouring rows, a contiguous span, and
//      each thread keeps U = 16 rows of t and var in flight.  Each thread
//      folds its rows in order (the same rows and order whichever shard
//      blocks hold them); the row groups are then summed in order
//      through shared memory into the tile's partial count, sum, max,
//      inverse-variance weight sum and weighted sum per column, written
//      to a scratch buffer.  Wider V takes 256 columns a pass.
//   2. Each block then takes an integer ticket (no float atomics); the
//      last block to arrive folds the tiles' partials in tile order (the
//      tiles split over up to 256 / (S_d V) thread groups whose results
//      are summed in group order) into each scale's (4, V) merged column
//      (mean, max, p0, inverse-variance), then, with the tail, splices
//      the historical columns in front, takes the reference step time
//      from the "max" row at the last scale (summed over the root-child
//      columns in order, unless given), fits the slopes over the scales
//      in order and writes share (0 where the step time is not positive)
//      and flags.  It resets the ticket for the next launch.  Every sum
//      is taken in the same order on every run, so the result is too.
//   * The rows come from a table of up to NB = 16 shard blocks (pointers
//     and first rows, passed by value in the launch's parameters), so
//     the live op reads the fleet's shard blocks in place; a stacked
//     (S_d, P, V) tensor is one block, each scale a fixed stride apart.
//
// Known limits: at V between 129 and 255 a pass leaves 256 - V threads
// idle; the last block's fold is one block's work (a few microseconds);
// the ticket is a counter the wrapper keeps per device and stream.
//
// merge_scale_column is this kernel without the tail.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;               // threads per block
constexpr int TP = 256;               // rows per tile (kernel.py NS_ROW_TILE)
constexpr int NB = 16;                // shard blocks (kernel.py NS_MAX_BLOCKS)
constexpr int U = 16;                 // rows a thread keeps in flight
constexpr int FU = 8;                 // tiles' partials in flight, stage 2
constexpr double VAR_EPS = 1e-18;     // inverse-variance weight 1/(var+eps)
constexpr int IMAX = 1;               // "max" row of the merged stack

template <typename T>
__device__ __forceinline__ T neg_inf();
template <>
__device__ __forceinline__ double neg_inf<double>() {
  return __longlong_as_double((long long)0xfff0000000000000ULL);
}
template <>
__device__ __forceinline__ float neg_inf<float>() {
  return __int_as_float((int)0xff800000u);
}

// The rows of one scale: block k holds rows [row0[k], row0[k + 1]) as a
// contiguous (rows, V) array; scale s of a stacked tensor lies
// ``scale_stride`` elements after scale 0.
template <typename T> struct Blocks {
  const T* t[NB];
  const T* v[NB];
  int row0[NB + 1];
  int nb;
};

template <typename T> struct Acc {
  int cnt;
  T total, wsum, wt, mx;
  __device__ __forceinline__ Acc()
      : cnt(0), total(T(0)), wsum(T(0)), wt(T(0)), mx(neg_inf<T>()) {}
  __device__ __forceinline__ void add(T x, T var) {
    mx = x > mx ? x : mx;
    if (x > T(0)) {
      const T w = T(1) / (var + T(VAR_EPS));
      cnt += 1;
      total += x;
      wsum += w;
      wt += w * x;
    }
  }
  __device__ __forceinline__ void add(int c, T f0, T f1, T f2, T f3) {
    cnt += c;
    total += f0;
    wsum += f1;
    wt += f2;
    mx = f3 > mx ? f3 : mx;
  }
};

template <typename T> struct Shared {
  int cnt[NT];
  T f[4][NT];
  bool last;
};

template <typename T>
__device__ __forceinline__ void put(Shared<T>& sh, int i, const Acc<T>& a) {
  sh.cnt[i] = a.cnt;
  sh.f[0][i] = a.total;
  sh.f[1][i] = a.wsum;
  sh.f[2][i] = a.wt;
  sh.f[3][i] = a.mx;
}
template <typename T>
__device__ __forceinline__ void take(Acc<T>& a, const Shared<T>& sh, int i) {
  a.add(sh.cnt[i], sh.f[0][i], sh.f[1][i], sh.f[2][i], sh.f[3][i]);
}

// Stage 1: one tile's per-column partials.
template <typename T>
__device__ void tile_partials(const Blocks<T>& in, long long scale_stride,
                              int P, int V, int ntiles, int tile, int s,
                              Shared<T>& sh, int* __restrict__ part_cnt,
                              T* __restrict__ part_f) {
  const int tid = threadIdx.x;
  const int CP = V < NT ? V : NT;         // columns a pass
  const int G = NT / CP;                  // row groups
  const int grp = tid / CP, cl = tid % CP;
  const int r0 = tile * TP;
  const int r1 = r0 + TP < P ? r0 + TP : P;
  const size_t o = (size_t)s * ntiles + tile;
  for (int c0 = 0; c0 < V; c0 += CP) {
    const int c = c0 + cl;
    Acc<T> a;
    if (grp < G && c < V) {
      for (int k = 0; k < in.nb; ++k) {
        const int lo = r0 > in.row0[k] ? r0 : in.row0[k];
        const int hi = r1 < in.row0[k + 1] ? r1 : in.row0[k + 1];
        if (lo >= hi) continue;
        const T* tb = in.t[k] + s * scale_stride + c;
        const T* vb = in.v[k] + s * scale_stride + c;
        // the rows r0 + grp + G i of the tile, as one stacked block would
        // give them: the same order of sums however the rows are cut
        int r = lo + ((r0 + grp - lo) % G + G) % G - in.row0[k];
        const int end = hi - in.row0[k];
        for (; r + (U - 1) * G < end; r += U * G) {
          T xv[U], vv[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            xv[u] = tb[(size_t)(r + u * G) * V];
            vv[u] = vb[(size_t)(r + u * G) * V];
          }
#pragma unroll
          for (int u = 0; u < U; ++u) a.add(xv[u], vv[u]);
        }
        for (; r < end; r += G) a.add(tb[(size_t)r * V], vb[(size_t)r * V]);
      }
    }
    put(sh, tid, a);
    __syncthreads();
    if (grp == 0 && c < V) {
      for (int y = 1; y < G; ++y) take(a, sh, y * CP + cl);
      part_cnt[o * V + c] = a.cnt;
      part_f[(o * 4 + 0) * V + c] = a.total;
      part_f[(o * 4 + 1) * V + c] = a.wsum;
      part_f[(o * 4 + 2) * V + c] = a.wt;
      part_f[(o * 4 + 3) * V + c] = a.mx;
    }
    __syncthreads();
  }
}

// Stage 2 (the last block): the tiles' partials -> each scale's (4, V)
// merged column, written to M at scale offset H + s of an S_t-scale stack.
template <typename T>
__device__ void merge_columns(const Blocks<T>& in, long long scale_stride,
                              int P, int V, int ntiles, int S_d,
                              Shared<T>& sh, const int* __restrict__ part_cnt,
                              const T* __restrict__ part_f, T* __restrict__ M,
                              int S_t, int H) {
  const int tid = threadIdx.x;
  const int I = S_d * V;                  // (scale, column) items
  const int G = I < NT ? NT / I : 1;      // tile groups an item
  const int slots = NT / G;
  const int grp = tid / slots;
  for (int it0 = 0; it0 < I; it0 += slots) {
    const int it = it0 + tid % slots;
    const bool mine = it < I && grp < G;
    const int s = mine ? it / V : 0, c = mine ? it % V : 0;
    Acc<T> a;
    if (mine) {
      const int k0 = (int)((long long)grp * ntiles / G);
      const int k1 = (int)((long long)(grp + 1) * ntiles / G);
#pragma unroll FU
      for (int k = k0; k < k1; ++k) {
        const size_t o = (size_t)s * ntiles + k;
        a.add(__ldcg(part_cnt + o * V + c),
              __ldcg(part_f + (o * 4 + 0) * V + c),
              __ldcg(part_f + (o * 4 + 1) * V + c),
              __ldcg(part_f + (o * 4 + 2) * V + c),
              __ldcg(part_f + (o * 4 + 3) * V + c));
      }
    }
    put(sh, tid, a);
    __syncthreads();
    if (mine && grp == 0) {
      for (int y = 1; y < G; ++y) take(a, sh, y * slots + tid % slots);
      const bool any = a.cnt > 0;
      const T mean = any ? a.total / T(a.cnt) : T(0);
      const T p0raw = P > 0 ? in.t[0][s * scale_stride + c] : T(0);
      const T col[4] = {mean, any ? a.mx : T(0), p0raw > T(0) ? p0raw : mean,
                        a.wsum > T(0) ? a.wt / a.wsum : T(0)};
      for (int j = 0; j < 4; ++j)
        M[((size_t)j * S_t + H + s) * V + c] = col[j];
    }
    __syncthreads();
  }
}

// The tail: splice, reference step time, slope fit, share, flags.
template <typename T>
__device__ void tail_fit(const T* __restrict__ hist, int H, T* __restrict__ M,
                         int S_t, int V, const T* __restrict__ logp,
                         const unsigned char* __restrict__ present,
                         const int* __restrict__ top, int ntop, T ideal,
                         T margin, T min_share, T total_param, int use_total,
                         T* __restrict__ slope, T* __restrict__ share,
                         unsigned char* __restrict__ flag) {
  for (int i = threadIdx.x; i < 4 * H * V; i += blockDim.x) {
    const int j = i / (H * V), rem = i % (H * V);
    M[(size_t)j * S_t * V + rem] = hist[i];
  }
  __syncthreads();
  T total = total_param;
  if (!use_total) {
    total = T(0);
    const T* last_max = M + ((size_t)IMAX * S_t + S_t - 1) * V;
    for (int i = 0; i < ntop; ++i) {
      const int c = top[i];
      if (c >= 0 && c < V) total += last_max[c];
    }
  }
  for (int i = threadIdx.x; i < 4 * V; i += blockDim.x) {
    const int j = i / V, c = i % V;
    int n = 0;
    T Sx = T(0), Sy = T(0), Sxx = T(0), Sxy = T(0), msum = T(0);
    for (int s = 0; s < S_t; ++s) {
      const T m = M[((size_t)j * S_t + s) * V + c];
      msum += m;
      if (m > T(0) && present[(size_t)s * V + c]) {
        const T x = logp[s], y = log(m);
        n += 1;
        Sx += x;
        Sy += y;
        Sxx += x * x;
        Sxy += x * y;
      }
    }
    const T nf = T(n);
    const T denom = nf * Sxx - Sx * Sx;
    const T num = nf * Sxy - Sx * Sy;
    const T sl = (denom != T(0) && n >= 2) ? num / denom : T(0);
    const T last = M[((size_t)j * S_t + S_t - 1) * V + c];
    const T sh = total > T(0) ? last / total : T(0);
    slope[i] = sl;
    share[i] = sh;
    flag[i] = (msum > T(0)) && (sl - ideal > margin) && (sh >= min_share);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
ns_fused(Blocks<T> in, long long scale_stride, int P, int V, int ntiles,
         int S_d, int H, int* __restrict__ part_cnt, T* __restrict__ part_f,
         unsigned* __restrict__ ticket, T* __restrict__ M, int tail,
         const T* __restrict__ hist, const T* __restrict__ logp,
         const unsigned char* __restrict__ present,
         const int* __restrict__ top, int ntop, T ideal, T margin,
         T min_share, T total, int use_total, T* __restrict__ slope,
         T* __restrict__ share, unsigned char* __restrict__ flag) {
  __shared__ Shared<T> sh;
  const int tile = blockIdx.x, s = blockIdx.y;
  tile_partials(in, scale_stride, P, V, ntiles, tile, s, sh, part_cnt,
                part_f);
  // the partials are visible to every block before the ticket is taken
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned n = atomicAdd(ticket, 1u);
    sh.last = n == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
  const int S_t = H + S_d;
  merge_columns(in, scale_stride, P, V, ntiles, S_d, sh, part_cnt, part_f, M,
                S_t, H);
  if (threadIdx.x == 0) *ticket = 0u;     // ready for the next launch
  if (!tail) return;
  __syncthreads();
  tail_fit(hist, H, M, S_t, V, logp, present, top, ntop, ideal, margin,
           min_share, total, use_total, slope, share, flag);
}

template <typename T>
int ns_fused_impl(const T* const* t, const T* const* var, const int* row0,
                  int nb, long long scale_stride, const T* hist,
                  const T* logp, const unsigned char* present, const int* top,
                  int ntop, int S_d, int P, int V, int H, double ideal,
                  double margin, double min_share, double total,
                  int use_total, int tail, int* part_cnt, T* part_f,
                  unsigned* ticket, T* M, T* slope, T* share,
                  unsigned char* flag, cudaStream_t s) {
  if (nb < 1 || nb > NB || S_d < 1 || V < 1 || P < 0 || row0[0] != 0 ||
      row0[nb] != P)
    return (int)cudaErrorInvalidValue;
  // the table holds the blocks that have rows, so that global row 0 is
  // the first block's first
  Blocks<T> in = {};
  in.t[0] = t[0];
  in.v[0] = var[0];
  for (int k = 0; k < nb; ++k) {
    if (row0[k + 1] < row0[k]) return (int)cudaErrorInvalidValue;
    if (row0[k + 1] == row0[k]) continue;
    in.t[in.nb] = t[k];
    in.v[in.nb] = var[k];
    in.row0[in.nb++] = row0[k];
  }
  if (in.nb == 0) in.nb = 1;              // P = 0: no row is read
  in.row0[in.nb] = P;
  const int ntiles = P > 0 ? (P + TP - 1) / TP : 1;
  ns_fused<T><<<dim3(ntiles, S_d), NT, 0, s>>>(
      in, scale_stride, P, V, ntiles, S_d, H, part_cnt, part_f, ticket, M,
      tail, hist, logp, present, top, ntop, (T)ideal, (T)margin,
      (T)min_share, (T)total, use_total, slope, share, flag);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* scalana_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ``t`` and ``var``: host arrays of ``nb`` device pointers, the shard
// blocks in row order, block k starting at global row ``row0[k]``
// (row0[0] = 0, row0[nb] = P); scale s of each lies ``scale_stride``
// elements after scale 0.  ``ticket``: a device counter that is 0 before
// the launch and is 0 again after it.
#define NS_ARGS(T)                                                         \
  const T *const *t, const T *const *var, const int *row0, int nb,         \
      long long scale_stride, const T *hist, const T *logp,                \
      const unsigned char *present, const int *top, int ntop, int S_d,     \
      int P, int V, int H, double ideal, double margin, double min_share,  \
      double total, int use_total, int tail, int *part_cnt, T *part_f,     \
      unsigned *ticket, T *M, T *slope, T *share, unsigned char *flag,     \
      void *stream
#define NS_PASS                                                            \
  t, var, row0, nb, scale_stride, hist, logp, present, top, ntop, S_d, P, \
      V, H, ideal, margin, min_share, total, use_total, tail, part_cnt,    \
      part_f, ticket, M, slope, share, flag, (cudaStream_t)stream

int ns_fused_f64(NS_ARGS(double)) { return ns_fused_impl<double>(NS_PASS); }

int ns_fused_f32(NS_ARGS(float)) { return ns_fused_impl<float>(NS_PASS); }

}  // extern "C"
