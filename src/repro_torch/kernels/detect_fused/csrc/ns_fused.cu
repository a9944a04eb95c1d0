// Non-scalable detection: per-scale merges over rows, historical-column
// splice, closed-form log-log slope fit, share and flags, for Hopper.
//
// Replaces the JAX package's Pallas kernel ``ns_fused_kernel``
// (src/repro/kernels/detect_fused/kernel.py:227, body ``_ns_kernel``),
// and, run without its tail, the jitted ``merge_scale_column``
// (src/repro/kernels/detect_fused/ops.py:334).
//
// What bounds it on an H100: the bytes of t and var.  The function reads
// the (S_d, P, V) time and variance stacks once (2 * S_d * P * V * 8 bytes
// in f64: 29 MB for one 65536 x 56 scale, about 9 us at 3.35 TB/s) and
// writes O(S * V); a few operations per element.
//
// Design.  The TPU grid (S, NP) walks the row tiles in order and carries
// the merge accumulators across them in VMEM.  Hopper blocks run in
// parallel and in no order, so the reduction has two fixed-order stages
// and no float atomics, and its result is the same on every run:
//
//   1. ns_partial — one block per (row tile of 512 rows, scale), 32 x 8
//      threads: a warp reads 32 neighbouring columns of one row, so the
//      loads are coalesced.  Each thread folds its rows in order; the 8
//      row lanes are then summed in order through shared memory into the
//      tile's partial count, sum, max, inverse-variance weight sum and
//      weighted sum per column.
//   2. ns_reduce — one block per scale: the tiles' partials folded in
//      tile order into the scale's (4, V) merged column (mean, max, p0,
//      inverse-variance).  p0 is the reading of the scale's global row 0,
//      or the mean where that reading is dead.
//   3. ns_tail — one block over the (4, V) strategy-by-vertex grid: the
//      historical columns spliced in front, the reference step time from
//      the "max" row at the last scale (summed over the root-child
//      columns in order, unless given), the slope fit over the scales in
//      order, share (0 where the step time is not positive) and flags.
//
// merge_scale_column is stages 1 and 2 for one scale.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32, TY = 8;        // ns_partial block: columns x row lanes
constexpr int TP = 512;               // rows per tile (kernel.py NS_ROW_TILE)
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

// 1. Per (tile, scale) partials.
template <typename T>
__global__ void __launch_bounds__(TX * TY)
ns_partial(const T* __restrict__ t, const T* __restrict__ var, int P, int V,
           int ntiles, int* __restrict__ part_cnt, T* __restrict__ part_f) {
  __shared__ int s_cnt[TY][TX];
  __shared__ T s_f[4][TY][TX];
  const int tile = blockIdx.x, s = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r0 = tile * TP;
  const int r1 = r0 + TP < P ? r0 + TP : P;
  const size_t sbase = (size_t)s * P * V;
  const size_t o = (size_t)s * ntiles + tile;
  for (int c0 = 0; c0 < V; c0 += TX) {
    const int c = c0 + tx;
    int cnt = 0;
    T total = T(0), wsum = T(0), wt = T(0), mx = neg_inf<T>();
    if (c < V) {
      for (int r = r0 + ty; r < r1; r += TY) {
        const size_t at = sbase + (size_t)r * V + c;
        const T x = t[at];
        mx = x > mx ? x : mx;
        if (x > T(0)) {
          const T w = T(1) / (var[at] + T(VAR_EPS));
          cnt += 1;
          total += x;
          wsum += w;
          wt += w * x;
        }
      }
    }
    s_cnt[ty][tx] = cnt;
    s_f[0][ty][tx] = total;
    s_f[1][ty][tx] = wsum;
    s_f[2][ty][tx] = wt;
    s_f[3][ty][tx] = mx;
    __syncthreads();
    if (ty == 0 && c < V) {
      for (int y = 1; y < TY; ++y) {
        cnt += s_cnt[y][tx];
        total += s_f[0][y][tx];
        wsum += s_f[1][y][tx];
        wt += s_f[2][y][tx];
        mx = s_f[3][y][tx] > mx ? s_f[3][y][tx] : mx;
      }
      part_cnt[o * V + c] = cnt;
      part_f[(o * 4 + 0) * V + c] = total;
      part_f[(o * 4 + 1) * V + c] = wsum;
      part_f[(o * 4 + 2) * V + c] = wt;
      part_f[(o * 4 + 3) * V + c] = mx;
    }
    __syncthreads();
  }
}

// 2. Partials -> each scale's (4, V) merged column, written to M at
// scale offset h0 + s of an S_t-scale stack.
template <typename T>
__global__ void ns_reduce(const T* __restrict__ t, int P, int V, int ntiles,
                          const int* __restrict__ part_cnt,
                          const T* __restrict__ part_f, T* __restrict__ M,
                          int S_t, int h0) {
  const int s = blockIdx.x;
  for (int c = threadIdx.x; c < V; c += blockDim.x) {
    int cnt = 0;
    T total = T(0), wsum = T(0), wt = T(0), mx = neg_inf<T>();
    for (int tile = 0; tile < ntiles; ++tile) {
      const size_t o = (size_t)s * ntiles + tile;
      cnt += part_cnt[o * V + c];
      total += part_f[(o * 4 + 0) * V + c];
      wsum += part_f[(o * 4 + 1) * V + c];
      wt += part_f[(o * 4 + 2) * V + c];
      const T m = part_f[(o * 4 + 3) * V + c];
      mx = m > mx ? m : mx;
    }
    const bool any = cnt > 0;
    const T mean = any ? total / T(cnt) : T(0);
    const T p0raw = P > 0 ? t[(size_t)s * P * V + c] : T(0);
    const T col[4] = {mean, any ? mx : T(0), p0raw > T(0) ? p0raw : mean,
                      wsum > T(0) ? wt / wsum : T(0)};
    for (int j = 0; j < 4; ++j)
      M[((size_t)j * S_t + h0 + s) * V + c] = col[j];
  }
}

// 3. Splice, reference step time, slope fit, share, flags.
template <typename T>
__global__ void ns_tail(const T* __restrict__ hist, int H, T* __restrict__ M,
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
int ns_fused_impl(const T* t, const T* var, const T* hist, const T* logp,
                  const unsigned char* present, const int* top, int ntop,
                  int S_d, int P, int V, int H, double ideal, double margin,
                  double min_share, double total, int use_total, int tail,
                  int* part_cnt, T* part_f, T* M, T* slope, T* share,
                  unsigned char* flag, cudaStream_t s) {
  const int ntiles = P > 0 ? (P + TP - 1) / TP : 1;
  const int S_t = H + S_d;
  ns_partial<T><<<dim3(ntiles, S_d), dim3(TX, TY), 0, s>>>(
      t, var, P, V, ntiles, part_cnt, part_f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ns_reduce<T><<<S_d, 128, 0, s>>>(t, P, V, ntiles, part_cnt, part_f, M,
                                   S_t, H);
  e = cudaGetLastError();
  if (e != cudaSuccess || !tail) return (int)e;
  ns_tail<T><<<1, 256, 0, s>>>(hist, H, M, S_t, V, logp, present, top, ntop,
                               (T)ideal, (T)margin, (T)min_share, (T)total,
                               use_total, slope, share, flag);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* scalana_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#define NS_ARGS(T)                                                        \
  const T *t, const T *var, const T *hist, const T *logp,                 \
      const unsigned char *present, const int *top, int ntop, int S_d,    \
      int P, int V, int H, double ideal, double margin, double min_share, \
      double total, int use_total, int tail, int *part_cnt, T *part_f,    \
      T *M, T *slope, T *share, unsigned char *flag, void *stream

int ns_fused_f64(NS_ARGS(double)) {
  return ns_fused_impl<double>(t, var, hist, logp, present, top, ntop, S_d, P,
                               V, H, ideal, margin, min_share, total,
                               use_total, tail, part_cnt, part_f, M, slope,
                               share, flag, (cudaStream_t)stream);
}

int ns_fused_f32(NS_ARGS(float)) {
  return ns_fused_impl<float>(t, var, hist, logp, present, top, ntop, S_d, P,
                              V, H, ideal, margin, min_share, total,
                              use_total, tail, part_cnt, part_f, M, slope,
                              share, flag, (cudaStream_t)stream);
}

}  // extern "C"
