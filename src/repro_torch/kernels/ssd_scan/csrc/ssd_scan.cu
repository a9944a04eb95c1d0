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
// What bounds it on an H100.  The function's products are C B^T on the
// causal triangle, Q(Q+1)/2 N multiply-adds per (batch row, chunk), as B
// and C are shared by every head, and per (batch row, head, chunk) M x on
// the triangle, Q(Q+1)/2 P, and C h and B^T w, 2 Q N P: y_i sums over
// j <= i only.  They run as 3xTF32 on the tensor cores, three TF32
// products per f32 product, so the bound is three times the products
// over the 494.7 TFLOP/s dense TF32 rate, or the bytes (x, dt, A, B, C
// read once, y and the final state written once) over 3.35 TB/s,
// whichever is larger (chip_smoke.py's ssd_bound):
//   mamba2-130m loss (B 8, S 2048, H 24, P 64, N 128, Q 64): 14.7 GFLOP,
//     0.0889 ms (bytes 226 MB, 0.067 ms; on the CUDA cores 0.219 ms);
//   zamba2-2.7b loss (B 2, S 2048, H 80, P 64, N 64): bytes, 0.052 ms;
//   mamba2-130m prefill (B 1, S 32768): 29.3 GFLOP, 0.178 ms.
// This kernel computes C B^T once per head, H times what the bound
// counts (a known cost, below).

// Design: the chunk-parallel (two-level) SSD, with the carry on chip.
//   * One thread-block cluster of CL blocks (1 to 8, chosen by the
//     wrapper so that the grid fills the card) per (head, batch row); the
//     cluster's blocks split the sequence's chunks into CL contiguous
//     ranges.  The chunks' intra products do not depend on the state;
//     only the (N, P) carry h_c = exp(s_Q,c) h_{c-1} + st_c is
//     sequential, and it is elementwise.
//   * Pass 1 (CL > 1, every block but the last): walk the range and fold
//     the chunk states from zero, h_loc = exp(s_Q) h_loc + B^T (w x), and
//     D = sum of s_Q.  After a cluster barrier, block k reads h_loc and D
//     of blocks 0..k-1 through distributed shared memory and folds them
//     in order, h_in = exp(D_j) h_in + h_loc_j; after a second barrier it
//     starts pass 2 from h_in.  The per-chunk states never go to HBM.
//   * Pass 2: walk the range again with the carried state.  Per chunk,
//     three barriers: x and B are staged in shared memory by cp.async, all
//     copies in flight at once (rows past Q are zeros), while warp 0 scans
//     s; then each warp, one 16-row tile of the chunk and half of the
//     columns, runs G = C B^T (only the tiles on and below the diagonal)
//     and C h_prev in one loop over N, with C's rows read from global
//     memory one step ahead (L2: C is shared by all heads of a batch row),
//     and writes M = G exp(s_i - s_j) dt_j, evaluating exp only for j <= i
//     (the upper triangle of s_i - s_j is positive and could overflow);
//     then y = exp(s) C h_prev + M x, over the causal k range only, is
//     stored from the accumulators, while the state h = exp(s_Q) h +
//     B^T (w x) is updated in shared memory.
//   * Every product is mma.sync m16n8k8 TF32 in 3xTF32: each operand is
//     cut into a big and a small TF32 part by truncation (three
//     operations) as its fragment is loaded, and a b = a_s b_b + a_b b_s
//     + a_b b_b is accumulated in f32, term by term across a warp's tiles
//     so that no mma waits on the one before.  Fragment reads of x, the
//     state and M are free of bank conflicts (row strides P + 8 and Q +
//     4); B^T's, read down columns, have two-way conflicts.
//   * Shared memory: Q(P + 8) + Q(N + 4) + N(P + 8) + Q(Q + 4) floats: 108
//     KB at mamba2's (P, N) = (64, 128), two CTAs an SM (128 registers a
//     thread).  Q is a runtime value up to 64; (P, N) come from a
//     compiled set, others are refused.
//
// Known limits, for later work: several times the bound (PERF.md).  A
// CTA alone on an SM (one block per head) runs a chunk several times
// slower than its instruction count allows: latency, with two warps a
// scheduler.  Nothing overlaps a chunk's staging but the other CTA;
// every operand is split again by each warp that loads it (more integer
// work than mma); pass 1 reads x and B a second time and repeats
// B^T (w x) (a third more products at CL > 1); C B^T is computed per
// head though heads share it; mma.sync, not wgmma.  Splitting into
// shared-memory planes once per chunk and double-buffered copies need
// the shared memory of the second CTA: a one-CTA, 16-warp design with
// wgmma is the way past these.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int QMAX = 64;        // largest chunk
constexpr int NT = 256;         // threads per CTA
constexpr int NW = NT / 32;     // warps per CTA
constexpr int LDM = QMAX + 4;   // row stride of M
constexpr int CLMAX = 8;        // largest cluster
constexpr unsigned FULL = 0xffffffffu;

template <int P, int N> struct Smem {
  static constexpr int LDX = P + 8;               // x and state row stride
  static constexpr int LDN = N + 4;               // B row stride
  static constexpr int X = 0;                     // QMAX x LDX
  static constexpr int BS = X + QMAX * LDX;       // QMAX x LDN
  static constexpr int HS = BS + QMAX * LDN;      // N x LDX state
  static constexpr int MS = HS + N * LDX;         // QMAX x LDM
  static constexpr int VEC = MS + QMAX * LDM;     // s, exp(s), dt, w
  static constexpr int SCAL = VEC + 4 * QMAX;     // exp(s_Q), D
  static constexpr int FLOATS = SCAL + 4;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// x = big + small + r, big and small TF32 values (10-bit mantissa) cut by
// truncation, |r| < 2^-20 |x|: three operations an element (rounding to
// nearest, as flash_attention.cu does, takes five for |r| < 2^-22 |x|;
// the SSD's sums keep 20x inside their limit either way).
constexpr uint32_t TF32_MASK = 0xffffe000u;
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) & TF32_MASK;
  small = __float_as_uint(x - __uint_as_float(big)) & TF32_MASK;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A 16 x 8 (row-major) and B 8 x 8 fragments of mma.m16n8k8, split in two
// TF32 planes.  With g = lane / 4, t = lane % 4: A holds (g, t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4); B holds (t, g), (t + 4, g); the
// accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
struct FragA {
  uint32_t b[4], s[4];
  __device__ __forceinline__ void set(float v0, float v1, float v2,
                                      float v3) {
    split(v0, b[0], s[0]);
    split(v1, b[1], s[1]);
    split(v2, b[2], s[2]);
    split(v3, b[3], s[3]);
  }
};
struct FragB {
  uint32_t b[2], s[2];
  __device__ __forceinline__ void set(float v0, float v1) {
    split(v0, b[0], s[0]);
    split(v1, b[1], s[1]);
  }
};
// c[k] += a b[k] for k < n in 3xTF32 (the small x small term dropped),
// term by term across the tiles, so that no mma waits on the one before
template <int K>
__device__ __forceinline__ void mma3(float (*c)[4], const FragA& a,
                                     const FragB* b, int n = K) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k < n) mma(c[k], a.s, b[k].b);
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k < n) mma(c[k], a.b, b[k].s);
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k < n) mma(c[k], a.b, b[k].b);
}

// Stage chunk steps [t0, t0 + Q) (flat step index b S + c Q) of x and B
// (rows past Q are zeros) with cp.async, all in flight at once; warp 0
// meanwhile forms s = cumsum(dt a), exp(s), dt, w = exp(s_Q - s) dt and
// exp(s_Q), and adds s_Q to D.  Waits for its own copies; no barrier.
template <int P, int N>
__device__ __forceinline__ void stage(const float* __restrict__ x,
                                      const float* __restrict__ dt,
                                      const float* __restrict__ Bm,
                                      float a, long long t0, int H, int h,
                                      int Q, float* sm) {
  using L = Smem<P, N>;
  const int tid = threadIdx.x;
  const float* xp = x + (t0 * H + h) * P;
#pragma unroll 4
  for (int i = tid; i < QMAX * (P / 4); i += NT) {
    const int r = i / (P / 4), d = 4 * (i % (P / 4));
    cp_async16(sm + L::X + r * L::LDX + d,
               xp + (long long)(r < Q ? r : 0) * H * P + d, r < Q);
  }
  const float* bp = Bm + t0 * N;
#pragma unroll 4
  for (int i = tid; i < QMAX * (N / 4); i += NT) {
    const int r = i / (N / 4), d = 4 * (i % (N / 4));
    cp_async16(sm + L::BS + r * L::LDN + d, bp + (r < Q ? r : 0) * N + d,
               r < Q);
  }
  if (tid < 32) {               // lanes hold steps l and l + 32
    float* sv = sm + L::VEC;
    float* ev = sv + QMAX;
    float* dv = ev + QMAX;
    float* wv = dv + QMAX;
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
    if (l == 0) {
      sm[L::SCAL] = expf(sq);
      sm[L::SCAL + 1] += sq;
    }
  }
  cp_wait_all();
}

// h = exp(s_Q) h + B^T (w x) on the staged chunk, in shared memory.  The
// (N, P) state is cut into 16 x 8 tiles: each warp takes state row tiles
// and column tiles as NW warps divide them.
template <int P, int N>
__device__ __forceinline__ void state_update(float* sm, int Q) {
  using L = Smem<P, N>;
  constexpr int LDX = L::LDX, LDN = L::LDN;
  constexpr int NTL = P / 8;                      // state column tiles
  constexpr int MT = (N + 15) / 16;               // state row tiles
  constexpr int WPM = MT >= NW ? 1 : NW / MT;     // warps per row tile
  constexpr int MPW = MT >= NW ? MT / NW : 1;     // row tiles per warp
  constexpr int NPW = (NTL + WPM - 1) / WPM;      // column tiles per warp
  static_assert(MT <= NW ? NW % MT == 0 : MT % NW == 0, "state tiling");
  const float* xs = sm + L::X;
  const float* bs = sm + L::BS;
  float* hs = sm + L::HS;
  const float* wv = sm + L::VEC + 3 * QMAX;
  const float decay = sm[L::SCAL];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Q8 = (Q + 7) & ~7;
#pragma unroll
  for (int m = 0; m < MPW; ++m) {
    const int mt = w / WPM + m * (NW / WPM);
    if (mt >= MT) continue;
    const int na = 16 * mt + g, nb = na + 8;
    const bool ina = na < N, inb = nb < N;
    // column tiles w % WPM + WPM k < NTL
    const int nvalid = (NTL - w % WPM + WPM - 1) / WPM;
    float acc[NPW][4];
#pragma unroll
    for (int k = 0; k < NPW; ++k)
      acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
    for (int j0 = 0; j0 < Q8; j0 += 8) {
      const float* r0 = bs + (j0 + t) * LDN;
      const float* r1 = r0 + 4 * LDN;
      const float w0 = wv[j0 + t], w1 = wv[j0 + t + 4];
      FragA fa;
      fa.set(ina ? r0[na] * w0 : 0.f, inb ? r0[nb] * w0 : 0.f,
             ina ? r1[na] * w1 : 0.f, inb ? r1[nb] * w1 : 0.f);
      FragB fb[NPW];
#pragma unroll
      for (int k = 0; k < NPW; ++k) {
        const int p = 8 * (w % WPM + WPM * k) + g;
        if (k < nvalid)
          fb[k].set(xs[(j0 + t) * LDX + p], xs[(j0 + t + 4) * LDX + p]);
      }
      mma3<NPW>(acc, fa, fb, nvalid);
    }
#pragma unroll
    for (int k = 0; k < NPW; ++k) {
      const int nt = w % WPM + WPM * k;
      if (nt >= NTL) continue;
      const int p = 8 * nt + 2 * t;
      if (ina) {
        float* e = hs + na * LDX + p;
        e[0] = fmaf(decay, e[0], acc[k][0]);
        e[1] = fmaf(decay, e[1], acc[k][1]);
      }
      if (inb) {
        float* e = hs + nb * LDX + p;
        e[0] = fmaf(decay, e[0], acc[k][2]);
        e[1] = fmaf(decay, e[1], acc[k][3]);
      }
    }
  }
}

template <int P, int N>
__global__ void __launch_bounds__(NT, 2)
ssd_chunks(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, float* __restrict__ y,
           float* __restrict__ hout, int S, int H, int Q, int CL) {
  using L = Smem<P, N>;
  constexpr int LDX = L::LDX, LDN = L::LDN;
  constexpr int NTH = P / 16;             // y column tiles a warp
  static_assert(P % 16 == 0 && N % 8 == 0, "compiled shapes");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const float* xs = sm + L::X;
  const float* bs = sm + L::BS;
  float* hs = sm + L::HS;
  float* ms = sm + L::MS;
  const float* sv = sm + L::VEC;
  const float* ev = sv + QMAX;
  const float* dv = ev + QMAX;

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const float a = A[h];
  const int nc = S / Q;
  const int c_begin = (int)((long long)rank * nc / CL);
  const int c_end = (int)((long long)(rank + 1) * nc / CL);

  for (int e = tid; e < N * LDX; e += NT) hs[e] = 0.f;
  if (tid == 0) sm[L::SCAL + 1] = 0.f;

  // pass 1: this range's own state from zero, and its decay D
  if (CL > 1) {
    if (rank < CL - 1) {
      for (int c = c_begin; c < c_end; ++c) {
        __syncthreads();
        stage<P, N>(x, dt, Bm, a, (long long)b * S + (long long)c * Q, H, h,
                    Q, sm);
        __syncthreads();
        state_update<P, N>(sm, Q);
      }
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    // h_in = the earlier ranges' states folded in order
    constexpr int PER = (N * P + NT - 1) / NT;
    float hin[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) hin[k] = 0.f;
    for (int j = 0; j < rank; ++j) {
      const float* hj = cluster.map_shared_rank(hs, j);
      const float dj = expf(*cluster.map_shared_rank(sm + L::SCAL + 1, j));
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int e = tid + k * NT;
        if (e < N * P) hin[k] = fmaf(dj, hin[k], hj[(e / P) * LDX + e % P]);
      }
    }
    cluster.sync();             // no block reads another's state past here
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * NT;
      if (e < N * P) hs[(e / P) * LDX + e % P] = hin[k];
    }
  }

  // pass 2: y and the carried state, chunk by chunk
  const int r = w & 3, hf = w >> 2;       // row tile, column half
  const int i0 = 16 * r + g, i1 = i0 + 8;
  for (int c = c_begin; c < c_end; ++c) {
    const long long t0 = (long long)b * S + (long long)c * Q;
    __syncthreads();                      // the last chunk's reads are done
    stage<P, N>(x, dt, Bm, a, t0, H, h, Q, sm);
    __syncthreads();

    // G = C B^T on this warp's tiles j in 8 (hf + 2k) .. + 8, k <= r,
    // and yc = C h_prev on its column half, in one loop over N
    float gacc[4][4], yacc[NTH][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      gacc[k][0] = gacc[k][1] = gacc[k][2] = gacc[k][3] = 0.f;
#pragma unroll
    for (int k = 0; k < NTH; ++k)
      yacc[k][0] = yacc[k][1] = yacc[k][2] = yacc[k][3] = 0.f;
    {
      // C's rows i0 and i1 from global memory, one step of 8 ahead
      const bool in0 = i0 < Q, in1 = i1 < Q;
      const float* c0 = Cm + (t0 + (in0 ? i0 : 0)) * N + t;
      const float* c1 = Cm + (t0 + (in1 ? i1 : 0)) * N + t;
      float cn[4] = {in0 ? c0[0] : 0.f, in1 ? c1[0] : 0.f,
                     in0 ? c0[4] : 0.f, in1 ? c1[4] : 0.f};
#pragma unroll 4
      for (int n0 = 0; n0 < N; n0 += 8) {
        FragA fa;
        fa.set(cn[0], cn[1], cn[2], cn[3]);
        if (n0 + 8 < N) {
          cn[0] = in0 ? c0[n0 + 8] : 0.f;
          cn[1] = in1 ? c1[n0 + 8] : 0.f;
          cn[2] = in0 ? c0[n0 + 12] : 0.f;
          cn[3] = in1 ? c1[n0 + 12] : 0.f;
        }
        FragB fg[4], fy[NTH];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float* bj = bs + (8 * (hf + 2 * k) + g) * LDN + n0;
          if (k <= r) fg[k].set(bj[t], bj[t + 4]);
        }
#pragma unroll
        for (int k = 0; k < NTH; ++k) {
          const int p = 8 * (hf * NTH + k) + g;
          fy[k].set(hs[(n0 + t) * LDX + p], hs[(n0 + t + 4) * LDX + p]);
        }
        mma3<4>(gacc, fa, fg, r + 1);
        mma3<NTH>(yacc, fa, fy);
      }
    }
    // M = G exp(s_i - s_j) dt_j on j <= i < Q, else 0
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k > r) continue;
      const int j = 8 * (hf + 2 * k) + 2 * t;
      const int rows[2] = {i0, i1};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = rows[u];
        float m0 = 0.f, m1 = 0.f;
        if (i < Q) {
          if (j <= i) m0 = gacc[k][2 * u] * expf(sv[i] - sv[j]) * dv[j];
          if (j + 1 <= i)
            m1 = gacc[k][2 * u + 1] * expf(sv[i] - sv[j + 1]) * dv[j + 1];
        }
        *reinterpret_cast<float2*>(ms + i * LDM + j) = make_float2(m0, m1);
      }
    }
    const float e0 = ev[i0], e1 = ev[i1];
#pragma unroll
    for (int k = 0; k < NTH; ++k) {
      yacc[k][0] *= e0;
      yacc[k][1] *= e0;
      yacc[k][2] *= e1;
      yacc[k][3] *= e1;
    }
    __syncthreads();

    // y += M x over the causal k range j < 16 (r + 1), then store
    for (int j0 = 0; j0 < 16 * (r + 1); j0 += 8) {
      FragA fa;
      fa.set(ms[i0 * LDM + j0 + t], ms[i1 * LDM + j0 + t],
             ms[i0 * LDM + j0 + t + 4], ms[i1 * LDM + j0 + t + 4]);
      FragB fb[NTH];
#pragma unroll
      for (int k = 0; k < NTH; ++k) {
        const int p = 8 * (hf * NTH + k) + g;
        fb[k].set(xs[(j0 + t) * LDX + p], xs[(j0 + t + 4) * LDX + p]);
      }
      mma3<NTH>(yacc, fa, fb);
    }
#pragma unroll
    for (int k = 0; k < NTH; ++k) {
      const int p = 8 * (hf * NTH + k) + 2 * t;
      if (i0 < Q)
        *reinterpret_cast<float2*>(y + ((t0 + i0) * H + h) * P + p) =
            make_float2(yacc[k][0], yacc[k][1]);
      if (i1 < Q)
        *reinterpret_cast<float2*>(y + ((t0 + i1) * H + h) * P + p) =
            make_float2(yacc[k][2], yacc[k][3]);
    }
    state_update<P, N>(sm, Q);
  }

  if (rank == CL - 1) {                   // the final state, written once
    __syncthreads();
    float* hp = hout + ((long long)b * H + h) * N * P;
    for (int e = tid; e < N * P; e += NT) hp[e] = hs[(e / P) * LDX + e % P];
  }
}

template <int P, int N>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, float* y, float* h, int B, int S, int H, int Q,
           int CL, cudaStream_t stream) {
  const size_t smem = Smem<P, N>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunks<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, H, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ssd_chunks<P, N>, x, dt, A, Bm, Cm, y, h, S,
                         H, Q, CL);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* scalana_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ``cluster``: blocks per (head, batch row), 1 to 8 and at most the
// number of chunks S / Q (the wrapper's cluster_size); refused otherwise.
int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* h, int B, int S, int H, int P,
                 int N, int Q, int cluster, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || Q <= 0 || Q > QMAX || S % Q ||
      cluster < 1 || cluster > CLMAX || cluster > S / Q)
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
    return launch<PP, NN>(xf, df, af, bf, cf, yf, hf, B, S, H, Q, cluster, \
                          s);
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
