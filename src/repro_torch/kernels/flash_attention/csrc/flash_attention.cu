// Flash-attention forward (GQA, causal or full) for Hopper, f32 or bf16
// inputs, f32 accumulation, both products on the tensor cores.
//
// Replaces the JAX package's Pallas kernel ``flash_attention_kernel``
// (src/repro/kernels/flash_attention/kernel.py:96, body ``_attn_kernel``
// at :34): the same function, with the same masking constant and the
// same l == 0 rule, not the Pallas grid carried over block by block.
//
// What bounds it on an H100: operations.  A causal call does about
// 2 * B * nq * S^2 * h floating-point operations (QK^T and PV over the
// lower triangle) on B * (nq + 2 nkv) * S * h inputs: at the full-width
// tinyllama layer (B=4, nq=32, nkv=4, S=2048, h=64) that is 69 GFLOP
// against 84 MB of f32 traffic (0.025 ms at 3.35 TB/s).  On the CUDA
// cores (67 TFLOP/s in f32) that is 1 ms at best, so both products run on
// the tensor cores.
//
// f32 inputs (what the models run): 3xTF32 on wgmma.
//   * Each operand is split into a big and a small TF32 part, a = tf32(a)
//     + tf32(a - tf32(a)) (round to nearest, ties away, as cvt.rna), and
//     each product is accumulated in f32 as a_small b_big + a_big b_small +
//     a_big b_big.  That keeps f32 accuracy (within the reference's 2e-5;
//     plain TF32 is off by ~1e-3: tests/test_torch_flash_precision.py), at
//     three TF32 products per f32 product: the bound is 3 x 69 GFLOP over
//     the 494.7 TFLOP/s dense TF32 rate, 0.42 ms at the tinyllama layer.
//   * wgmma (m64nNk8 TF32) with A in registers and B in shared memory: Q's
//     fragments are split once per CTA and stay in registers for every K
//     tile; P comes straight from the score accumulators (the k index of a
//     k-step permuted, logical k = q holding key 2q and k = q + 4 key
//     2q + 1, so the accumulator layout is the A layout with no shuffle).
//     TF32 wgmma takes B only K-major, so V is stored transposed.
//   * tf32_planes splits K and V into those operands once per (batch row,
//     KV head): per tile of BK keys, K big / K small in the no-swizzle
//     core-matrix layout (8 rows x 16 bytes) and V big / V small transposed
//     to K-major with the same key permutation, contiguous.  Splitting in
//     the attention kernel instead would repeat the work in every CTA that
//     reads a tile (128 of them for a GQA group of 8 at S = 2048) and hold
//     the tensor cores up behind it.
//   * flash_tf32: one CTA per (query tile of BQ = 128 rows, query head,
//     batch row), two warpgroups of 64 rows.  A tile's four planes arrive
//     by one 1-D bulk copy (TMA, completion on an mbarrier) into a
//     two-stage ring, so tile kt + 1 loads while tile kt computes.  Per
//     tile: S = Q K^T (3 x H/8 wgmma), the online softmax on the CUDA cores
//     in f32 (base 2, the scale folded in: exp2 is one instruction; the row
//     max and sum over the quad of threads that holds a row; -1e30 masking
//     as in the reference), O += P V (3 x BK/8 wgmma).
//
// bf16 inputs: one bf16 product with f32 accumulation (the probabilities
// rounded to bf16 for PV, as flash attention does), on mma.sync m16n8k16:
// 8 warps of 16 query rows, K/V tiles by cp.async into a two-stage ring,
// rows padded by 8 elements so every fragment load is conflict-free.  It
// is not on the models' path (they run f32); wgmma would fit its layouts
// too and is later work.
//
// f32 at h = 256 (gemma-7b): flash_tf32_qs.  The design above does not
// fit: Q's two planes in registers would take 256 a thread for one
// warpgroup of 64 rows, beside O's 128, and two stages of 32-key tiles
// 256 KB of shared memory (an H100 CTA has 227 KB).  So:
//   * one warpgroup of 64 query rows per CTA (wgmma's M), 128 threads;
//   * Q split once into its big and small TF32 planes in shared memory
//     (2 x 64 KB, the core-matrix layout of the K planes) and fed to wgmma
//     as the A operand by descriptor; O's 128 accumulators a thread stay in
//     registers, P comes from the score accumulators as above;
//   * K/V tiles of BK = 16 keys, the K planes and the V planes of a tile in
//     two bulk copies on two mbarriers (32 KB each): K of tile kt + 1 loads
//     while P V of tile kt runs, V of tile kt + 1 while the scores of tile
//     kt + 1 are made.  128 + 32 + 32 = 192 KB; one CTA an SM.
//   * QK^T is m64n16k8 with both operands in shared memory, 96 a tile;
//     P V is two m64n128k8 (O's two column halves) per 8 keys, 3 each for
//     3xTF32.  A simple instance that is right, not a fast one: the A reads
//     of the narrow QK^T products bound it on shared-memory bandwidth.
//
// Both: causal tiles wholly above the diagonal, judged by the CTA's last
// real query row, are never loaded; a warpgroup (warp for bf16) skips the
// math of a tile wholly above its own rows.  The output is written once,
// acc / l, with l == 0 dividing by 1, rounded once to the input type.  The
// caller's strides are taken as given (16-byte aligned), so the models'
// (B, S, heads, h) layout needs no transpose; GQA query head qh reads KV
// head qh / group, never replicated.  Head dims 32, 64, 80, 128 and 256
// are compiled; any other is refused.  Shared memory per CTA (f32): two
// stages of 4 BK h floats, 64 KB at h = 32, 128 KB at h = 64, 160 KB at
// h = 80 (BK = 64) and 128 KB at h = 128 (BK = 32); 192 KB at h = 256
// (above); one CTA an SM.  bf16: (128 + 4 x 64) (h + 8) x 2 bytes, 198 KB
// at h = 256.

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 128;         // query rows per CTA
constexpr int NT = 256;         // threads per CTA: 8 warps, 2 warpgroups
constexpr float NEG_INF = -1e30f;

struct Strides {                // element strides: batch, head, position
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS x H elements of one head, from position p0, into a shared tile of
// row stride LD; rows at or past n are zero-filled.
template <typename T, int H, int ROWS, int LD, int THREADS = NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long stride, int p0, int n) {
  constexpr int CE = 16 / (int)sizeof(T);           // elements a cp.async
  constexpr int PER_ROW = H / CE;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, e = (i % PER_ROW) * CE;
    const bool in = p0 + r < n;
    const T* s = src + (long long)(in ? p0 + r : 0) * stride + e;
    cp_async16(dst + r * LD + e, s, in);
  }
}

// -- f32 inputs: 3xTF32 on wgmma ---------------------------------------------

// Round to TF32 (10-bit mantissa), to nearest with ties away from zero:
// what cvt.rna.tf32.f32 computes for finite values, in two integer
// operations (on sm_90a cvt.rna compiles to a long compare-and-select
// sequence).  IEEE
// floats are sign-magnitude, so adding half a TF32 ulp to the bits rounds
// the magnitude up on a tie, and the carry into the exponent is the right
// result.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = big + small, each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// m64nNk8 TF32 products, A from registers (the mma.sync m16n8k8 A layout
// per warp), B from a shared-memory descriptor, D += A B in f32.
template <int N> struct Wgmma;
template <> struct Wgmma<32> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
  }
};

template <> struct Wgmma<80> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
  }
};

// m64n16k8 TF32 products with A and B both from shared-memory
// descriptors (the scores of flash_tf32_qs), D += A B in f32.
__device__ __forceinline__ void wgmma_ss16(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes by the threads made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A no-swizzle, K-major wgmma operand: core matrices of 8 rows x 16 bytes
// (128 contiguous bytes), LBO bytes apart along K, SBO bytes apart per 8
// rows.
__device__ __forceinline__ uint64_t make_desc(const float* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

template <int H> struct Tf32Cfg {
  // h = 256: Q's planes in shared memory (flash_tf32_qs), one warpgroup
  static constexpr bool QSMEM = H > 128;
  static constexpr int BQ = QSMEM ? 64 : 128;       // query rows per CTA
  static constexpr int NT = QSMEM ? 128 : 256;      // 1 or 2 warpgroups
  static constexpr int BK = QSMEM ? 16 : H >= 128 ? 32 : 64;  // keys a tile
  static constexpr int LDQ = H + 4;                 // staged Q rows
  static constexpr int PL = BK * H;                 // a plane (floats)
  // a tile's four planes: K big, K small, V big, V small
  static constexpr int STAGE = 4 * PL;
  static constexpr uint32_t STAGE_BYTES = STAGE * sizeof(float);
  // shared memory: two stages, Q staged over them before the first; or
  // (QSMEM) Q's two planes and one tile
  static constexpr size_t BYTES =
      QSMEM ? (size_t)(2 * BQ * H + STAGE) * sizeof(float)
            : (size_t)(2 * STAGE > BQ * LDQ ? 2 * STAGE : BQ * LDQ) *
                  sizeof(float);
  static constexpr uint32_t SBO_K = (H / 4) * 128;  // per 8 keys
  static constexpr uint32_t SBO_V = (BK / 4) * 128; // per 8 head dims
};

// K plane (N = keys, K = head dims) and V plane (N = head dims, K =
// keys): float offset of element (row, col) in the core-matrix layout.
template <int KEXT>
__device__ __forceinline__ int core_off(int row, int col) {
  return (row >> 3) * (8 * KEXT) + (col >> 2) * 32 + (row & 7) * 4 + (col & 3);
}

// The planes of every K/V tile, once per (batch row, KV head): K split
// into big and small TF32 parts in the core-matrix layout QK^T reads; V
// split and transposed to K-major, the keys of each 8 in the order
// 0 2 4 6 1 3 5 7 (the layout P has in the accumulator registers).  Rows
// past Sk are zeros.  A tile's planes are contiguous, so the attention
// kernel fetches each with one bulk copy.
template <int H>
__global__ void __launch_bounds__(NT)
tf32_planes(const float* __restrict__ k, const float* __restrict__ v,
            float* __restrict__ work, int nkv, int Sk, int n_tiles,
            Strides st) {
  using C = Tf32Cfg<H>;
  constexpr int BK = C::BK;
  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int p0 = kt * BK;
  const float* kp = k + b * st.kb + kh * st.kh;
  const float* vp = v + b * st.vb + kh * st.vh;
  float* Kb = work + ((size_t)(b * nkv + kh) * n_tiles + kt) * C::STAGE;
  float* Ks = Kb + C::PL;
  float* Vb = Ks + C::PL;
  float* Vs = Vb + C::PL;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < BK * H / 4; i += NT) {
    const int nl = i & 7, c = (i >> 3) % (H / 4), ng = (i >> 3) / (H / 4);
    const int n = 8 * ng + nl;
    const float4 x = p0 + n < Sk
        ? *reinterpret_cast<const float4*>(kp + (long long)(p0 + n) * st.ks +
                                           4 * c)
        : zero;
    uint32_t bg[4], sl[4];
    split(x.x, bg[0], sl[0]);
    split(x.y, bg[1], sl[1]);
    split(x.z, bg[2], sl[2]);
    split(x.w, bg[3], sl[3]);
    const int off = core_off<H>(n, 4 * c);
    *reinterpret_cast<uint4*>(Kb + off) = make_uint4(bg[0], bg[1], bg[2], bg[3]);
    *reinterpret_cast<uint4*>(Ks + off) = make_uint4(sl[0], sl[1], sl[2], sl[3]);
  }
  // V in 4 x 4 blocks: keys 8o + hf + {0, 2, 4, 6} (logical keys
  // 8o + 4hf + {0..3}) by head dims 4c .. 4c + 3, transposed in registers
  for (int i = threadIdx.x; i < BK * H / 16; i += NT) {
    const int c = i % (H / 4), oh = i / (H / 4);    // oh = 2 o + hf
    const int n0 = 8 * (oh >> 1) + (oh & 1);
    float4 x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = p0 + n0 + 2 * e;
      x[e] = n < Sk ? *reinterpret_cast<const float4*>(
                          vp + (long long)n * st.vs + 4 * c)
                    : zero;
    }
    const float col[4][4] = {{x[0].x, x[1].x, x[2].x, x[3].x},
                             {x[0].y, x[1].y, x[2].y, x[3].y},
                             {x[0].z, x[1].z, x[2].z, x[3].z},
                             {x[0].w, x[1].w, x[2].w, x[3].w}};
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      uint32_t bg[4], sl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(col[dd][e], bg[e], sl[e]);
      const int off = core_off<BK>(4 * c + dd, 4 * oh);
      *reinterpret_cast<uint4*>(Vb + off) =
          make_uint4(bg[0], bg[1], bg[2], bg[3]);
      *reinterpret_cast<uint4*>(Vs + off) =
          make_uint4(sl[0], sl[1], sl[2], sl[3]);
    }
  }
}

// mbarrier and 1-D bulk copy (TMA) helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// one thread: the bytes at src into dst, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One K/V tile's scores sc (a warpgroup's m64nBK accumulators) through
// the online softmax in base 2 (the scores carry a factor log2 e, so exp2
// is one instruction): scaled, masked (-inf past Sk, NEG_INF above the
// diagonal, as in the reference; nothing when `whole`), the row max and
// sum over the quad of threads that holds a row, O's NACC accumulators
// rescaled; then P split into the TF32 A fragments of O += P V (k-step j
// is keys 8j .. 8j + 7, logical k = q holding key 2q and k = q + 4 key
// 2q + 1, so A is the accumulator of group j).
template <int BK, int NACC>
__device__ __forceinline__ void tf32_softmax(
    float* sc, float* acc, float* m, float* l, uint32_t (*pb)[4],
    uint32_t (*ps)[4], int k0, int Sk, int row0, int row1, int qd,
    bool whole, bool causal, float scale2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x = sc[i] * scale2;
    if (!whole) {
      const int row = (i & 2) ? row1 : row0;
      const int col = k0 + 8 * (i >> 2) + 2 * qd + (i & 1);
      if (col >= Sk) x = -INFINITY;
      else if (causal && col > row) x = NEG_INF;
    }
    sc[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    sc[i] = exp2f(sc[i] - m[(i >> 1) & 1]);
    sum[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = alpha[r] * l[r] + sum[r];
  }
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float a[4] = {sc[4 * j], sc[4 * j + 2], sc[4 * j + 1],
                        sc[4 * j + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], pb[j][i], ps[j][i]);
  }
}

// out = acc / l, l == 0 dividing by 1, written once: this thread's rows
// row0 and row1 of one head, acc[4 i + 2 r ..] at columns 8 i + 2 qd, + 1
template <int H>
__device__ __forceinline__ void tf32_store(float* op, long long os,
                                           const float* acc, const float* l,
                                           int row0, int row1, int qd,
                                           int Sq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= Sq) continue;
    const float den = l[r] > 0.f ? l[r] : 1.f;
    float* orow = op + (long long)row * os + 2 * qd;
#pragma unroll
    for (int i = 0; i < H / 8; ++i)
      *reinterpret_cast<float2*>(orow + 8 * i) =
          make_float2(acc[4 * i + 2 * r] / den, acc[4 * i + 2 * r + 1] / den);
  }
}

template <int H>
__global__ void __launch_bounds__(Tf32Cfg<H>::NT, 1)
flash_tf32(const float* __restrict__ q, const float* __restrict__ work,
           float* __restrict__ o, int nq, int nkv, int Sq, int Sk,
           int n_tiles, Strides st, float scale, int causal) {
  using C = Tf32Cfg<H>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = BK / 8;
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bars[2];
  float* sm = reinterpret_cast<float*>(smem4);      // 2 stages of planes

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;                         // warpgroup: 64 rows
  const int g = lane >> 2, qd = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;        // heaviest tiles first
  const int qh = blockIdx.y, b = blockIdx.z;
  const int kh = qh / (nq / nkv);
  const int q0 = qt * BQ;
  const int w0 = q0 + 64 * wg;                      // the warpgroup's rows
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;

  const float* qp = q + b * st.qb + qh * st.qh;
  const float* tiles = work + (size_t)(b * nkv + kh) * n_tiles * C::STAGE;

  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kend = causal ? min(Sk, last_row + 1) : Sk;
  const int n_kt = (kend + BK - 1) / BK;
  const int wg_last = min(w0 + 63, Sq - 1);
  const float scale2 = scale * 1.4426950408889634f;  // log2 e

  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q, split once into the A fragments of every k-step
  load_rows<float, H, BQ, C::LDQ, C::NT>(sm, qp, st.qs, q0, Sq);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  uint32_t qb[H / 8][4], qs[H / 8][4];
  {
    const float* qa = sm + (16 * warp + g) * C::LDQ + qd;
#pragma unroll
    for (int kk = 0; kk < H / 8; ++kk) {
      const float a[4] = {qa[8 * kk], qa[8 * C::LDQ + 8 * kk],
                          qa[8 * kk + 4], qa[8 * C::LDQ + 8 * kk + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split(a[i], qb[kk][i], qs[kk][i]);
    }
  }
  fence_async_smem();               // the staging space takes bulk copies
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < 2 && t < n_kt; ++t)
      bulk_load(sm + t * C::STAGE, tiles + (size_t)t * C::STAGE,
                C::STAGE_BYTES, &bars[t]);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    const float* Kb = sm + (kt & 1) * C::STAGE;
    const float* Ks = Kb + C::PL;
    const float* Vb = Ks + C::PL;
    const float* Vs = Vb + C::PL;
    mbar_wait(&bars[kt & 1], (kt >> 1) & 1);        // tile kt has landed
    if (w0 < Sq && !(causal && k0 > wg_last)) {
      // S = Q K^T: 64 x BK per warpgroup
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < H / 8; ++kk) {
        const uint64_t db = make_desc(Kb + 64 * kk, 128, C::SBO_K);
        const uint64_t ds = make_desc(Ks + 64 * kk, 128, C::SBO_K);
        Wgmma<BK>::run(sc, qs[kk], db);
        Wgmma<BK>::run(sc, qb[kk], ds);
        Wgmma<BK>::run(sc, qb[kk], db);
      }
      wg_commit();
      wg_wait0();

      // a tile wholly below the diagonal and inside Sk masks nothing
      const bool whole = k0 + BK <= Sk && (!causal || k0 + BK - 1 <= w0);
      uint32_t pb[NS][4], ps[NS][4];
      tf32_softmax<BK, H / 2>(sc, acc, m, l, pb, ps, k0, Sk, row0, row1, qd,
                              whole, causal, scale2);
      // O += P V
      wg_fence();
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const uint64_t db = make_desc(Vb + 64 * j, 128, C::SBO_V);
        const uint64_t ds = make_desc(Vs + 64 * j, 128, C::SBO_V);
        Wgmma<H>::run(acc, ps[j], db);
        Wgmma<H>::run(acc, pb[j], ds);
        Wgmma<H>::run(acc, pb[j], db);
      }
      wg_commit();
      wg_wait0();
    }
    __syncthreads();                // every warp is done with tile kt
    if (tid == 0 && kt + 2 < n_kt)
      bulk_load(sm + (kt & 1) * C::STAGE, tiles + (size_t)(kt + 2) * C::STAGE,
                C::STAGE_BYTES, &bars[kt & 1]);
  }

  tf32_store<H>(o + b * st.ob + qh * st.oh, st.os, acc, l, row0, row1, qd,
                Sq);
}

// f32 at h = 256: one warpgroup of 64 query rows; Q's planes in shared
// memory as wgmma's A operand; K and V of each 16-key tile in separate
// bulk copies (bars[0]: the K planes, bars[1]: the V planes), each half
// refilled with tile kt + 1 as soon as tile kt is done with it.
template <int H>
__global__ void __launch_bounds__(Tf32Cfg<H>::NT, 1)
flash_tf32_qs(const float* __restrict__ q, const float* __restrict__ work,
              float* __restrict__ o, int nq, int nkv, int Sq, int Sk,
              int n_tiles, Strides st, float scale, int causal) {
  using C = Tf32Cfg<H>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = BK / 8;
  constexpr int HALF = 2 * C::PL;                   // a tile's K (V) planes
  constexpr uint32_t HALF_BYTES = HALF * sizeof(float);
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bars[2];
  float* Qb = reinterpret_cast<float*>(smem4);      // BQ x H, core layout
  float* Qs = Qb + BQ * H;
  float* Kt = Qs + BQ * H;                          // K big, K small
  float* Vt = Kt + HALF;                            // V big, V small

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;        // heaviest tiles first
  const int qh = blockIdx.y, b = blockIdx.z;
  const int kh = qh / (nq / nkv);
  const int q0 = qt * BQ;
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;

  const float* qp = q + b * st.qb + qh * st.qh;
  const float* tiles = work + (size_t)(b * nkv + kh) * n_tiles * C::STAGE;

  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kend = causal ? min(Sk, last_row + 1) : Sk;
  const int n_kt = (kend + BK - 1) / BK;
  const float scale2 = scale * 1.4426950408889634f;  // log2 e

  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bulk_load(Kt, tiles, HALF_BYTES, &bars[0]);     // tile 0 lands while
    bulk_load(Vt, tiles + HALF, HALF_BYTES, &bars[1]);  // Q is split
  }
  // Q split once into its TF32 planes, rows past Sq zero
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < BQ * H / 4; i += C::NT) {
    const int nl = i & 7, c = (i >> 3) % (H / 4), ng = (i >> 3) / (H / 4);
    const int r = 8 * ng + nl;
    const float4 x = q0 + r < Sq
        ? *reinterpret_cast<const float4*>(qp + (long long)(q0 + r) * st.qs +
                                           4 * c)
        : zero;
    uint32_t bg[4], sl[4];
    split(x.x, bg[0], sl[0]);
    split(x.y, bg[1], sl[1]);
    split(x.z, bg[2], sl[2]);
    split(x.w, bg[3], sl[3]);
    const int off = core_off<H>(r, 4 * c);
    *reinterpret_cast<uint4*>(Qb + off) = make_uint4(bg[0], bg[1], bg[2], bg[3]);
    *reinterpret_cast<uint4*>(Qs + off) = make_uint4(sl[0], sl[1], sl[2], sl[3]);
  }
  fence_async_smem();               // the planes are read by wgmma
  __syncthreads();
  const uint64_t dqb = make_desc(Qb, 128, C::SBO_K);
  const uint64_t dqs = make_desc(Qs, 128, C::SBO_K);
  const uint64_t dkb = make_desc(Kt, 128, C::SBO_K);
  const uint64_t dks = make_desc(Kt + C::PL, 128, C::SBO_K);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[H / 2];                 // O's columns 0-127, then 128-255
#pragma unroll
  for (int i = 0; i < H / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    mbar_wait(&bars[0], kt & 1);                    // K of tile kt
    // S = Q K^T: 64 x 16; k-step kk is 2 core matrices (256 bytes, 16 in
    // the descriptor's address field) further along Q's and K's rows
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    wg_fence();
#pragma unroll 4
    for (int kk = 0; kk < H / 8; ++kk) {
      const uint64_t step = 16ull * kk;
      wgmma_ss16(sc, dqs + step, dkb + step);
      wgmma_ss16(sc, dqb + step, dks + step);
      wgmma_ss16(sc, dqb + step, dkb + step);
    }
    wg_commit();
    wg_wait0();
    __syncthreads();                // every warp is done with K of tile kt
    if (tid == 0 && kt + 1 < n_kt)
      bulk_load(Kt, tiles + (size_t)(kt + 1) * C::STAGE, HALF_BYTES,
                &bars[0]);

    const bool whole = k0 + BK <= Sk && (!causal || k0 + BK - 1 <= q0);
    uint32_t pb[NS][4], ps[NS][4];
    tf32_softmax<BK, H / 2>(sc, acc, m, l, pb, ps, k0, Sk, row0, row1, qd,
                            whole, causal, scale2);

    // O += P V, O's two column halves apart (head dims 128-255 start 16
    // core-matrix rows, (H / 2) BK floats, into each V plane)
    mbar_wait(&bars[1], kt & 1);                    // V of tile kt
    wg_fence();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* Vb = Vt + hf * (H / 2) * BK;
      const float* Vs = Vb + C::PL;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const uint64_t db = make_desc(Vb + 64 * j, 128, C::SBO_V);
        const uint64_t ds = make_desc(Vs + 64 * j, 128, C::SBO_V);
        Wgmma<H / 2>::run(acc + hf * (H / 4), ps[j], db);
        Wgmma<H / 2>::run(acc + hf * (H / 4), pb[j], ds);
        Wgmma<H / 2>::run(acc + hf * (H / 4), pb[j], db);
      }
    }
    wg_commit();
    wg_wait0();
    __syncthreads();                // every warp is done with V of tile kt
    if (tid == 0 && kt + 1 < n_kt)
      bulk_load(Vt, tiles + (size_t)(kt + 1) * C::STAGE + HALF, HALF_BYTES,
                &bars[1]);
  }

  // acc[4 i ..] holds columns 8 i .. 8 i + 7 in both halves (half hf
  // starts at i = 16 hf), the layout tf32_store writes
  tf32_store<H>(o + b * st.ob + qh * st.oh, st.os, acc, l, row0, row1, qd,
                Sq);
}

// -- bf16 inputs: mma.sync ---------------------------------------------------

constexpr int BK16 = 64;        // keys per bf16 tile
constexpr int NS16 = BK16 / 8;  // score n-tiles per warp
constexpr int LD16 = 8;         // row padding, elements

template <int H> struct Bf16Cfg {
  static constexpr int LD = H + LD16;               // shared row stride
  static constexpr size_t BYTES =
      (size_t)(BQ + 4 * BK16) * LD * sizeof(__nv_bfloat16);
  // two CTAs an SM (128 registers a thread) but at h = 128, whose output
  // accumulators alone take 64
  static constexpr int MIN_CTAS = H >= 128 ? 1 : 2;
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pair16(const __nv_bfloat16* lo,
                                           const __nv_bfloat16* hi) {
  unsigned short a, b;
  memcpy(&a, lo, 2);
  memcpy(&b, hi, 2);
  return (uint32_t)a | ((uint32_t)b << 16);
}

// One warp, 16 query rows, one K/V tile.  g = lane / 4, q = lane % 4;
// s[j] is the 16 x 8 accumulator of keys 8j .. 8j + 7: (row g: keys
// 8j + 2q, +1), (row g + 8: the same keys).
template <int H>
__device__ __forceinline__ void qk16(float (*s)[4], const __nv_bfloat16* Qw,
                                     const __nv_bfloat16* Ks, int g, int q) {
  constexpr int LD = Bf16Cfg<H>::LD;
#pragma unroll
  for (int j = 0; j < NS16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < H; kk += 16) {
    const __nv_bfloat16* qa = Qw + g * LD + kk + 2 * q;
    const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LD), ld32(qa + 8),
                           ld32(qa + 8 * LD + 8)};
#pragma unroll
    for (int j = 0; j < NS16; ++j) {
      const __nv_bfloat16* kb = Ks + (8 * j + g) * LD + kk + 2 * q;
      const uint32_t b[2] = {ld32(kb), ld32(kb + 8)};
      mma_bf16(s[j], a, b);
    }
  }
}

// k-step jj covers keys 16 jj .. 16 jj + 15: n-tiles 2 jj and 2 jj + 1,
// whose accumulators are the A fragment as they are
template <int H>
__device__ __forceinline__ void pv16(float (*o)[4], float (*p)[4],
                                     const __nv_bfloat16* Vs, int g, int q) {
  constexpr int LD = Bf16Cfg<H>::LD;
#pragma unroll
  for (int jj = 0; jj < NS16 / 2; ++jj) {
    const float* p0 = p[2 * jj];
    const float* p1 = p[2 * jj + 1];
    const uint32_t a[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                           pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
#pragma unroll
    for (int d = 0; d < H / 8; ++d) {
      const __nv_bfloat16* vb = Vs + (16 * jj + 2 * q) * LD + 8 * d + g;
      const uint32_t b[2] = {pair16(vb, vb + LD),
                             pair16(vb + 8 * LD, vb + 9 * LD)};
      mma_bf16(o[d], a, b);
    }
  }
}

template <int H>
__global__ void __launch_bounds__(NT, Bf16Cfg<H>::MIN_CTAS)
flash_bf16(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
           int nq, int nkv, int Sq, int Sk, Strides st, float scale,
           int causal) {
  typedef __nv_bfloat16 T;
  constexpr int LD = Bf16Cfg<H>::LD;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);              // BQ x LD
  T* KV = Qs + BQ * LD;                             // 2 stages of K, V

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;        // heaviest tiles first
  const int qh = blockIdx.y, b = blockIdx.z;
  const int kh = qh / (nq / nkv);
  const int q0 = qt * BQ;
  const int w0 = q0 + 16 * warp;                    // the warp's first row
  const int row0 = w0 + g, row1 = row0 + 8;         // this thread's rows

  const T* qp = q + b * st.qb + qh * st.qh;
  const T* kp = k + b * st.kb + kh * st.kh;
  const T* vp = v + b * st.vb + kh * st.vh;

  // keys this tile needs: all, or (causal) those up to its last real row
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kend = causal ? min(Sk, last_row + 1) : Sk;
  const int n_kt = (kend + BK16 - 1) / BK16;
  // the warp's own last row, for skipping the math above it
  const int w_last = min(w0 + 15, Sq - 1);
  const float scale2 = scale * 1.4426950408889634f;  // log2 e

  auto stage_k = [&](int s) { return KV + (2 * s) * BK16 * LD; };
  auto stage_v = [&](int s) { return KV + (2 * s + 1) * BK16 * LD; };
  auto fetch = [&](int kt) {
    const int s = kt & 1;
    load_rows<T, H, BK16, LD>(stage_k(s), kp, st.ks, kt * BK16, Sk);
    load_rows<T, H, BK16, LD>(stage_v(s), vp, st.vs, kt * BK16, Sk);
  };
  load_rows<T, H, BQ, LD>(Qs, qp, st.qs, q0, Sq);
  fetch(0);
  cp_commit();
  if (n_kt > 1) fetch(1);
  cp_commit();

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[H / 8][4];
#pragma unroll
  for (int d = 0; d < H / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  const T* Qw = Qs + 16 * warp * LD;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK16;
    cp_wait<1>();                   // tile kt has landed
    __syncthreads();
    if (w0 < Sq && !(causal && k0 > w_last)) {
      float s[NS16][4];
      qk16<H>(s, Qw, stage_k(kt & 1), g, qd);

      // scale, mask, online softmax in base 2; a row's 4 threads share a
      // quad
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NS16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row0 : row1;
          const int col = k0 + 8 * j + 2 * qd + (e & 1);
          float x = s[j][e] * scale2;
          if (col >= Sk) x = -INFINITY;
          else if (causal && col > row) x = NEG_INF;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NS16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - m[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = alpha[i] * l[i] + sum[i];
      }
#pragma unroll
      for (int d = 0; d < H / 8; ++d) {
        acc[d][0] *= alpha[0];
        acc[d][1] *= alpha[0];
        acc[d][2] *= alpha[1];
        acc[d][3] *= alpha[1];
      }
      pv16<H>(acc, s, stage_v(kt & 1), g, qd);
    }
    __syncthreads();                // every warp is done with tile kt
    if (kt + 2 < n_kt) fetch(kt + 2);
    cp_commit();
  }
  cp_wait<0>();

  // out = acc / l, l == 0 dividing by 1; written once
  T* op = o + b * st.ob + qh * st.oh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? row1 : row0;
    if (row >= Sq) continue;
    const float den = l[i] > 0.f ? l[i] : 1.f;
    T* orow = op + (long long)row * st.os + 2 * qd;
#pragma unroll
    for (int d = 0; d < H / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
          __floats2bfloat162_rn(acc[d][2 * i] / den, acc[d][2 * i + 1] / den);
  }
}

// -- launch ---------------------------------------------------------------------

// The shared-memory limit of a kernel, raised once per device (to what a
// launch of it asks for; the same every launch).
template <auto KERNEL>
cudaError_t smem_limit(size_t smem) {
  static unsigned set = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !(set >> dev & 1u)) {
    e = cudaFuncSetAttribute(
        KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) set |= 1u << dev;
  }
  return e;
}

template <int H>
int launch(const float* q, const float* k, const float* v, float* o,
           float* work, int B, int nq, int nkv, int Sq, int Sk,
           const Strides& st, float scale, int causal, cudaStream_t stream) {
  using C = Tf32Cfg<H>;
  const int n_tiles = (Sk + C::BK - 1) / C::BK;
  tf32_planes<H><<<dim3(n_tiles, nkv, B), NT, 0, stream>>>(k, v, work, nkv,
                                                           Sk, n_tiles, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + C::BQ - 1) / C::BQ, nq, B);
  if constexpr (C::QSMEM) {
    e = smem_limit<flash_tf32_qs<H>>(C::BYTES);
    if (e != cudaSuccess) return (int)e;
    flash_tf32_qs<H><<<grid, C::NT, C::BYTES, stream>>>(
        q, work, o, nq, nkv, Sq, Sk, n_tiles, st, scale, causal);
  } else {
    e = smem_limit<flash_tf32<H>>(C::BYTES);
    if (e != cudaSuccess) return (int)e;
    flash_tf32<H><<<grid, C::NT, C::BYTES, stream>>>(
        q, work, o, nq, nkv, Sq, Sk, n_tiles, st, scale, causal);
  }
  return (int)cudaGetLastError();
}
template <int H>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, __nv_bfloat16* o, float*, int B, int nq,
           int nkv, int Sq, int Sk, const Strides& st, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem = Bf16Cfg<H>::BYTES;
  cudaError_t e = smem_limit<flash_bf16<H>>(smem);
  if (e != cudaSuccess) return (int)e;
  flash_bf16<H><<<dim3((Sq + BQ - 1) / BQ, nq, B), NT, smem, stream>>>(
      q, k, v, o, nq, nkv, Sq, Sk, st, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int flash_impl(const void* q, const void* k, const void* v, void* o,
               void* work, int B, int nq, int nkv, int Sq, int Sk, int h,
               const Strides& st, float scale, int causal, void* stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  float* w = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || nq <= 0 || nkv <= 0 || nq % nkv || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  switch (h) {
    case 32:
      return launch<32>(qt, kt, vt, ot, w, B, nq, nkv, Sq, Sk, st, scale,
                        causal, s);
    case 64:
      return launch<64>(qt, kt, vt, ot, w, B, nq, nkv, Sq, Sk, st, scale,
                        causal, s);
    case 80:
      return launch<80>(qt, kt, vt, ot, w, B, nq, nkv, Sq, Sk, st, scale,
                        causal, s);
    case 128:
      return launch<128>(qt, kt, vt, ot, w, B, nq, nkv, Sq, Sk, st, scale,
                         causal, s);
    case 256:
      return launch<256>(qt, kt, vt, ot, w, B, nq, nkv, Sq, Sk, st, scale,
                         causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* scalana_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// work: for f32, B * nkv * ceil(Sk / BK) tiles of 4 * BK * h floats (BK =
// 64, 32 at h = 128, 16 at h = 256), the K/V planes; unused for bf16
#define FLASH_ENTRY(NAME, T)                                                 \
  int NAME(const void* q, const void* k, const void* v, void* o,            \
           void* work, int B, int nq, int nkv, int Sq, int Sk, int h,       \
           long long qb,                                                     \
           long long qh, long long qs, long long kb, long long kh,           \
           long long ks, long long vb, long long vh, long long vs,           \
           long long ob, long long oh, long long os, float scale,            \
           int causal, void* stream) {                                       \
    const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};        \
    return flash_impl<T>(q, k, v, o, work, B, nq, nkv, Sq, Sk, h, st,       \
                         scale, causal, stream);                             \
  }

FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)

}  // extern "C"
