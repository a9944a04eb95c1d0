// Flash-attention forward (GQA, causal or full) for Hopper, f32 or bf16
// inputs, f32 accumulation.
//
// Replaces the JAX package's Pallas kernel ``flash_attention_kernel``
// (src/repro/kernels/flash_attention/kernel.py:96, body ``_attn_kernel``
// at :34): the same function, with the same masking constant and the
// same l == 0 rule, not the Pallas grid carried over block by block.
//
// What bounds it on an H100: operations.  A causal call does about
// 2 * B * nq * S^2 * h floating-point operations (QK^T and PV over the
// lower triangle) on B * (nq + 2 nkv) * S * h inputs: at the
// full-width tinyllama layer (B=4, nq=32, nkv=4, S=2048, h=64) that is
// 69 GFLOP against 84 MB of f32 traffic, about 1 ms at the 67 TFLOP/s
// float32 rate outside the tensor cores and 0.025 ms at 3.35 TB/s.  This
// first kernel computes in float32 on the CUDA cores (no TF32, no
// tensor cores), so its floor is that 1 ms; wgmma on bf16 is later work.
//
// Design.
//   * One CTA per (query tile of BQ = 64 rows, query head, batch row),
//     256 threads as a 16 x 16 grid.  Tiles are launched heaviest first
//     (the causal triangle's last query tiles have the most keys).
//   * GQA: query head qh reads KV head qh / group straight from the
//     caller's tensors; K/V are never replicated.  The caller's strides
//     are taken as given, so the models' (B, S, heads, h) layout needs no
//     transpose.
//   * The Q tile is staged once in shared memory (upcast to f32).  The
//     loop over K tiles of BK = 64 keys stages K and V (upcast to f32),
//     computes the 64 x 64 score tile from shared memory (each thread
//     4 query rows x 4 keys, float4 reads, conflict-free), keeps the
//     running max m, sum l and the output accumulator in registers, and
//     writes the probabilities over the K tile's shared memory for the
//     PV product (each thread 4 rows x h/16 output columns).
//   * Causal skipping: K tiles wholly above the diagonal, judged by the
//     tile's LAST real query row, are never loaded.  Inside a tile,
//     entries with col > row get NEG_INF = -1e30 as in the reference, so
//     their exp underflows to exactly 0 once a row has seen key 0 (its
//     first tile always holds it); keys past Sk get -inf (weight 0).
//   * The output is written once, acc / l, with l == 0 dividing by 1
//     (the row's acc is then 0), rounded once to the input type.
//   * Shared memory per CTA: (BQ + BK) * (h + 4) + BK * h floats, 100 KB
//     at h = 128, so two CTAs fit on an SM; 51 KB at h = 64, 62 KB at
//     h = 80 (zamba2-2.7b's 2560 / 32).
//   * Head dims 32, 64, 80 and 128 are compiled; any other is refused.
//     At h = 80 a thread keeps 5 output columns, 16 apart (80 = 5 x 16
//     does not split into float4 groups of a 16-thread row).

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per tile
constexpr int NT = 256;         // threads per CTA (16 x 16)
constexpr int LDP = BK + 4;     // row stride of the probability tile
constexpr float NEG_INF = -1e30f;

struct Strides {                // element strides: batch, head, position
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// 4 and 2 consecutive elements to and from float.
template <typename T> struct IO;
template <> struct IO<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  static __device__ __forceinline__ void store1(float* p, float a) { *p = a; }
};
template <> struct IO<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    uint2 u = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 a, b;
    memcpy(&a, &u.x, 4);
    memcpy(&b, &u.y, 4);
    float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    return make_float4(fa.x, fa.y, fb.x, fb.y);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    memcpy(&u.x, &a, 4);
    memcpy(&u.y, &b, 4);
    *reinterpret_cast<uint2*>(p) = u;
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a,
                                                float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
    *p = __float2bfloat16_rn(a);
  }
};

// Output columns of a thread: NG groups of G consecutive columns.  For
// h = 64 and 128, group g is columns 64 g + 4 tx .. + 3 (a row of 16
// threads reads 256 contiguous bytes of V); for h = 32, columns 2 tx,
// 2 tx + 1; for h = 80 (5 x 16 columns), the single columns 16 g + tx.
template <int H> struct Cols {
  static_assert(H % 16 == 0, "a row of 16 threads splits the head");
  static constexpr int G = H % 64 == 0 ? 4 : H == 32 ? 2 : 1;
  static constexpr int NG = H / (16 * G);
  static __device__ __forceinline__ int col(int tx, int g) {
    return G == 4 ? 64 * g + 4 * tx : G == 2 ? 2 * tx : 16 * g + tx;
  }
};

template <int H> struct Smem {
  static constexpr int LD = H + 4;                  // Q and K row stride
  static constexpr int KP = BK * LD > BQ * LDP ? BK * LD : BQ * LDP;
  static constexpr int FLOATS = BQ * LD + KP + BK * H;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// rows x H elements of one head, starting at position p0, into a
// shared-memory tile of row stride ld (f32); rows past n are zeros.
template <typename T, int H, int ROWS>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long stride, int p0, int n) {
  constexpr int V4 = H / 4;                         // float4s per row
  static_assert(ROWS * V4 % NT == 0, "the tile splits evenly");
#pragma unroll
  for (int it = 0; it < ROWS * V4 / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / V4, d = 4 * (i % V4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p0 + r < n) x = IO<T>::load4(src + (long long)(p0 + r) * stride + d);
    *reinterpret_cast<float4*>(dst + r * ld + d) = x;
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(NT, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int nq, int nkv,
          int Sq, int Sk, Strides st, float scale, int causal) {
  using C = Cols<H>;
  constexpr int LD = Smem<H>::LD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);      // BQ x LD
  float* Ks = Qs + BQ * LD;                         // BK x LD, then P
  float* Ps = Ks;                                   // BQ x LDP
  float* Vs = Ks + Smem<H>::KP;                     // BK x H

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;        // heaviest tiles first
  const int qh = blockIdx.y, b = blockIdx.z;
  const int kh = qh / (nq / nkv);
  const int q0 = qt * BQ;

  const T* qp = q + b * st.qb + qh * st.qh;
  const T* kp = k + b * st.kb + kh * st.kh;
  const T* vp = v + b * st.vb + kh * st.vh;
  stage<T, H, BQ>(Qs, LD, qp, st.qs, q0, Sq);

  // keys this tile needs: all, or (causal) those up to its last real row
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kend = causal ? min(Sk, last_row + 1) : Sk;
  const int n_kt = (kend + BK - 1) / BK;

  float m[4], l[4], acc[4][C::NG * C::G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C::NG * C::G; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                // the last tile's P and V are read
    stage<T, H, BK>(Ks, LD, kp, st.ks, k0, Sk);
    stage<T, H, BK>(Vs, H, vp, st.vs, k0, Sk);
    __syncthreads();

    // scores: rows 4 ty + i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < H; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb[j].x, a);
          a = fmaf(qa[i].y, kb[j].y, a);
          a = fmaf(qa[i].z, kb[j].z, a);
          a = fmaf(qa[i].w, kb[j].w, a);
          s[i][j] = a;
        }
    }

    // scale, mask, online softmax (a row's 16 threads share a half-warp)
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= Sk) x = -INFINITY;
        else if (causal && col > row) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha[i] * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < C::NG * C::G; ++j) acc[i][j] *= alpha[i];
    }

    __syncthreads();                // every thread is done reading K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(4 * ty + i) * LDP + tx + 16 * j] = s[i][j];
    __syncthreads();

    // acc += P V: rows 4 ty + i, this thread's output columns
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float pa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * LDP + c);
        pa[i][0] = p4.x; pa[i][1] = p4.y; pa[i][2] = p4.z; pa[i][3] = p4.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vr = Vs + (c + cc) * H;
#pragma unroll
        for (int g = 0; g < C::NG; ++g) {
          float vv[4];
          if constexpr (C::G == 4) {
            const float4 v4 =
                *reinterpret_cast<const float4*>(vr + C::col(tx, g));
            vv[0] = v4.x; vv[1] = v4.y; vv[2] = v4.z; vv[3] = v4.w;
          } else if constexpr (C::G == 2) {
            const float2 v2 =
                *reinterpret_cast<const float2*>(vr + C::col(tx, g));
            vv[0] = v2.x; vv[1] = v2.y;
          } else {
            vv[0] = vr[C::col(tx, g)];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < C::G; ++e)
              acc[i][g * C::G + e] = fmaf(pa[i][cc], vv[e], acc[i][g * C::G + e]);
        }
      }
    }
  }

  // out = acc / l, l == 0 dividing by 1; written once
  T* op = o + b * st.ob + qh * st.oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    const float den = l[i] > 0.f ? l[i] : 1.f;
    T* orow = op + (long long)row * st.os;
#pragma unroll
    for (int g = 0; g < C::NG; ++g) {
      const float* a = acc[i] + g * C::G;
      if constexpr (C::G == 4)
        IO<T>::store4(orow + C::col(tx, g),
                      make_float4(a[0] / den, a[1] / den, a[2] / den,
                                  a[3] / den));
      else if constexpr (C::G == 2)
        IO<T>::store2(orow + C::col(tx, g), a[0] / den, a[1] / den);
      else
        IO<T>::store1(orow + C::col(tx, g), a[0] / den);
    }
  }
}

template <typename T, int H>
int launch(const T* q, const T* k, const T* v, T* o, int B, int nq, int nkv,
           int Sq, int Sk, const Strides& st, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = Smem<H>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BQ - 1) / BQ, nq, B);
  flash_fwd<T, H><<<grid, NT, smem, stream>>>(q, k, v, o, nq, nkv, Sq, Sk, st,
                                              scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int flash_impl(const void* q, const void* k, const void* v, void* o, int B,
               int nq, int nkv, int Sq, int Sk, int h, const Strides& st,
               float scale, int causal, void* stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || nq <= 0 || nkv <= 0 || nq % nkv || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  switch (h) {
    case 32: return launch<T, 32>(qt, kt, vt, ot, B, nq, nkv, Sq, Sk, st, scale, causal, s);
    case 64: return launch<T, 64>(qt, kt, vt, ot, B, nq, nkv, Sq, Sk, st, scale, causal, s);
    case 80: return launch<T, 80>(qt, kt, vt, ot, B, nq, nkv, Sq, Sk, st, scale, causal, s);
    case 128: return launch<T, 128>(qt, kt, vt, ot, B, nq, nkv, Sq, Sk, st, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* scalana_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#define FLASH_ENTRY(NAME, T)                                                 \
  int NAME(const void* q, const void* k, const void* v, void* o, int B,      \
           int nq, int nkv, int Sq, int Sk, int h, long long qb,             \
           long long qh, long long qs, long long kb, long long kh,           \
           long long ks, long long vb, long long vh, long long vs,           \
           long long ob, long long oh, long long os, float scale,            \
           int causal, void* stream) {                                       \
    const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};        \
    return flash_impl<T>(q, k, v, o, B, nq, nkv, Sq, Sk, h, st, scale,       \
                         causal, stream);                                    \
  }

FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)

}  // extern "C"
