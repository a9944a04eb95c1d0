// Mamba2 SSD chunked scan, forward, for Hopper: float32 in, float32 out.
//
// Replaces the JAX package's Pallas kernel ``ssd_scan_kernel``
// (src/repro/kernels/ssd_scan/kernel.py:81, body ``_ssd_kernel`` at :34):
// the same function of (x, dt, A, B, C), not the Pallas grid carried over
// block by block.  Per chunk of Q steps, with s = cumsum(dt * A):
//   y_i   = sum_{j<=i} (C_i . B_j) exp(s_i - s_j) dt_j x_j      (intra)
//         + exp(s_i) C_i . h_prev                               (inter)
//   h_new = exp(s_Q) h_prev + sum_j B_j (x) exp(s_Q - s_j) dt_j x_j
// and the last chunk's h_new is the final state.
//
// What bounds it on an H100: operations.  The four products of a chunk
// (C B^T, M x, C h, B^T w) need Q(Q+1)/2 (N + P) + 2 Q N P multiply-adds
// per (batch row, head, chunk): y_i sums over j <= i only.  At
// mamba2-130m's loss shape (B=8, S=2048, H=24, P=64, N=128, Q=64) that
// is 17.8 GFLOP, 0.266 ms at the 67 TFLOP/s float32 rate outside the
// tensor cores, against 226 MB read once and written once (x and y
// 101 MB each), 0.067 ms at 3.35 TB/s.  At zamba2-2.7b's (B=2, H=80,
// N=64) it is 8.1 GFLOP, 0.121 ms (chip_smoke.py's ssd_bound).
//
// Design (right and simple first).
//   * One CTA of 256 threads (a 16 x 16 grid) per (head, batch row).  The
//     TPU kernel carries the (N, P) state in VMEM across a sequential
//     chunk grid axis; Hopper blocks run in no order, so the CTA loops
//     over its chunks itself and keeps the state in shared memory, zeroed
//     before the first chunk.
//   * Per chunk: x (Q x P), B and C (Q x N) are staged in shared memory
//     (float4 loads; rows past Q are zeros); warp 0 takes the inclusive
//     scan s = cumsum(dt * A) with shuffles and forms exp(s),
//     exp(s_Q - s) dt and exp(s_Q).  Then M = (C B^T) exp(s_i - s_j) dt_j,
//     evaluating exp only for j <= i (the upper triangle of s_i - s_j is
//     positive and could overflow; the reference masks after exp); then
//     y = M x + exp(s) (C h_prev), written straight to global memory,
//     while B's rows are scaled by exp(s_Q - s_j) dt_j in place; then
//     each thread updates its own state entries.  Four barriers a chunk.
//   * Each product is a register tile of 4 x 4 (or 4 x P/16) outputs a
//     thread; B and C rows are padded to N + 4 floats so the float4 reads
//     of a quarter-warp cover all 32 banks, M rows to 68.
//   * Shared memory per CTA: Q(P + 2(N + 4) + 68) + N P floats plus four
//     Q-vectors: 132 KB at mamba2's (P, N) = (64, 128), so one CTA an SM
//     (the launcher raises the 48 KB default limit).  Q is a runtime
//     value up to 64; (P, N) come from a compiled set, others are refused.
//
// Known limits, for later work: one CTA per (head, batch row) gives 192
// CTAs at mamba2's B = 8 and 160 at zamba2's B = 2 (under two waves on
// 132 SMs, and only H at batch 1); the chunks run one after another; the
// products run on the CUDA cores in float32.  The chunk-parallel two-pass
// SSD, wgmma and TMA are the way past these.

#include <cuda_runtime.h>

namespace {

constexpr int QMAX = 64;        // largest chunk
constexpr int NT = 256;         // threads per CTA (16 x 16)
constexpr int LDM = QMAX + 4;   // row stride of M
constexpr unsigned FULL = 0xffffffffu;

template <int P, int N> struct Smem {
  static constexpr int LDN = N + 4;               // B and C row stride
  static constexpr int X = 0;                     // QMAX x P
  static constexpr int BS = X + QMAX * P;         // QMAX x LDN
  static constexpr int CS = BS + QMAX * LDN;      // QMAX x LDN
  static constexpr int HS = CS + QMAX * LDN;      // N x P state
  static constexpr int MS = HS + N * P;           // QMAX x LDM
  static constexpr int VEC = MS + QMAX * LDM;     // s, exp(s), dt, w: 4 x QMAX
  static constexpr int FLOATS = VEC + 4 * QMAX + 4;   // + exp(s_Q)
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int P, int N>
__global__ void __launch_bounds__(NT, 1)
ssd_fwd(const float* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ A, const float* __restrict__ Bm,
        const float* __restrict__ Cm, float* __restrict__ y,
        float* __restrict__ hout, int S, int H, int Q) {
  using L = Smem<P, N>;
  constexpr int LDN = L::LDN;
  constexpr int PC = P / 16;              // output / state columns a thread
  constexpr int NR = (N + 15) / 16;       // state rows a thread
  static_assert(P % 16 == 0 && N % 4 == 0, "compiled shapes");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* xs = sm + L::X;
  float* bs = sm + L::BS;
  float* cs = sm + L::CS;
  float* hs = sm + L::HS;
  float* ms = sm + L::MS;
  float* sv = sm + L::VEC;                // s
  float* ev = sv + QMAX;                  // exp(s)
  float* dv = ev + QMAX;                  // dt
  float* wv = dv + QMAX;                  // exp(s_Q - s) dt
  float* dq = wv + QMAX;                  // exp(s_Q)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a = A[h];
  const int nc = S / Q;
  const int Q4 = (Q + 3) & ~3;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int e = tid; e < N * P; e += NT) hs[e] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const long long t0 = (long long)b * S + (long long)c * Q;   // (b, c Q)
    __syncthreads();                      // the last chunk's reads are done

    // stage x, B and C; rows past Q are zeros
    const float* xp = x + (t0 * H + h) * P;
    for (int i = tid; i < QMAX * (P / 4); i += NT) {
      const int r = i / (P / 4), d = 4 * (i % (P / 4));
      st4(xs + r * P + d, r < Q ? ld4(xp + (long long)r * H * P + d) : zero);
    }
    const float* bp = Bm + t0 * N;
    const float* cp = Cm + t0 * N;
    for (int i = tid; i < QMAX * (N / 4); i += NT) {
      const int r = i / (N / 4), d = 4 * (i % (N / 4));
      st4(bs + r * LDN + d, r < Q ? ld4(bp + r * N + d) : zero);
      st4(cs + r * LDN + d, r < Q ? ld4(cp + r * N + d) : zero);
    }

    // warp 0: s = cumsum(dt * A), inclusive; lanes hold steps l, l + 32
    if (tid < 32) {
      const int l = tid;
      const float d0 = l < Q ? dt[(t0 + l) * H + h] : 0.f;
      const float d1 = l + 32 < Q ? dt[(t0 + l + 32) * H + h] : 0.f;
      float s0 = d0 * a, s1 = d1 * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(FULL, s0, off);
        const float u1 = __shfl_up_sync(FULL, s1, off);
        if (l >= off) {
          s0 += u0;
          s1 += u1;
        }
      }
      s1 += __shfl_sync(FULL, s0, 31);
      const float last0 = __shfl_sync(FULL, s0, (Q - 1) & 31);
      const float last1 = __shfl_sync(FULL, s1, (Q - 1) & 31);
      const float sq = Q > 32 ? last1 : last0;
      const bool in0 = l < Q, in1 = l + 32 < Q;
      sv[l] = in0 ? s0 : 0.f;
      sv[l + 32] = in1 ? s1 : 0.f;
      ev[l] = in0 ? expf(s0) : 0.f;
      ev[l + 32] = in1 ? expf(s1) : 0.f;
      dv[l] = d0;
      dv[l + 32] = d1;
      wv[l] = in0 ? expf(sq - s0) * d0 : 0.f;
      wv[l + 32] = in1 ? expf(sq - s1) * d1 : 0.f;
      if (l == 0) dq[0] = expf(sq);
    }
    __syncthreads();

    // M[i][j] = (C_i . B_j) exp(s_i - s_j) dt_j for j <= i < Q, else 0;
    // rows ty + 16 r, columns tx + 16 k
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ld4(cs + (ty + 16 * r) * LDN + n);
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = ld4(bs + (tx + 16 * k) * LDN + n);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float s = acc[r][k];
            s = fmaf(cv[r].x, bv[k].x, s);
            s = fmaf(cv[r].y, bv[k].y, s);
            s = fmaf(cv[r].z, bv[k].z, s);
            s = fmaf(cv[r].w, bv[k].w, s);
            acc[r][k] = s;
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = tx + 16 * k;
          float m = 0.f;
          if (j <= i && i < Q) m = acc[r][k] * expf(sv[i] - sv[j]) * dv[j];
          ms[i * LDM + j] = m;
        }
      }
    }
    __syncthreads();

    // y = M x + exp(s) (C h_prev): rows ty + 16 r, columns tx + 16 k;
    // meanwhile B's rows are scaled by exp(s_Q - s_j) dt_j for the state
    {
      float yi[4][PC], yc[4][PC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < PC; ++k) yi[r][k] = yc[r][k] = 0.f;
      for (int j = 0; j < Q4; j += 4) {
        float4 mv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) mv[r] = ld4(ms + (ty + 16 * r) * LDM + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float xv[PC];
#pragma unroll
          for (int k = 0; k < PC; ++k) xv[k] = xs[(j + jj) * P + tx + 16 * k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < PC; ++k)
              yi[r][k] = fmaf(comp(mv[r], jj), xv[k], yi[r][k]);
        }
      }
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ld4(cs + (ty + 16 * r) * LDN + n);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          float hv[PC];
#pragma unroll
          for (int k = 0; k < PC; ++k) hv[k] = hs[(n + nn) * P + tx + 16 * k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < PC; ++k)
              yc[r][k] = fmaf(comp(cv[r], nn), hv[k], yc[r][k]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i >= Q) continue;
        float* yp = y + ((t0 + i) * H + h) * P;
#pragma unroll
        for (int k = 0; k < PC; ++k)
          yp[tx + 16 * k] = yi[r][k] + ev[i] * yc[r][k];
      }
      for (int e = tid; e < QMAX * N; e += NT) {
        const int r = e / N;
        bs[r * LDN + e % N] *= wv[r];
      }
    }
    __syncthreads();

    // h = exp(s_Q) h_prev + (w B)^T x: rows ty + 16 r, columns tx + 16 k
    {
      float st[NR][PC];
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int k = 0; k < PC; ++k) st[r][k] = 0.f;
      if (N % 16 == 0 || ty < N) {
        for (int j = 0; j < Q4; ++j) {
          float xv[PC];
#pragma unroll
          for (int k = 0; k < PC; ++k) xv[k] = xs[j * P + tx + 16 * k];
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            const float bv = bs[j * LDN + ty + 16 * r];
#pragma unroll
            for (int k = 0; k < PC; ++k) st[r][k] = fmaf(bv, xv[k], st[r][k]);
          }
        }
        const float decay = dq[0];
        const bool last = c == nc - 1;
        float* hp = hout + ((long long)b * H + h) * N * P;
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const int n = ty + 16 * r;
#pragma unroll
          for (int k = 0; k < PC; ++k) {
            const int e = n * P + tx + 16 * k;
            const float hn = fmaf(decay, hs[e], st[r][k]);
            hs[e] = hn;
            if (last) hp[e] = hn;
          }
        }
      }
    }
  }
}

template <int P, int N>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, float* y, float* h, int B, int S, int H, int Q,
           cudaStream_t stream) {
  const size_t smem = Smem<P, N>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B);
  ssd_fwd<P, N><<<grid, NT, smem, stream>>>(x, dt, A, Bm, Cm, y, h, S, H, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* scalana_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* h, int B, int S, int H, int P,
                 int N, int Q, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || Q <= 0 || Q > QMAX || S % Q)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSD_CASE(PP, NN)                                                   \
  if (P == PP && N == NN)                                                  \
    return launch<PP, NN>(xf, df, af, bf, cf, yf, hf, B, S, H, Q, s);
  SSD_CASE(16, 8)
  SSD_CASE(16, 16)
  SSD_CASE(32, 16)
  SSD_CASE(64, 32)
  SSD_CASE(64, 64)
  SSD_CASE(64, 128)
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
