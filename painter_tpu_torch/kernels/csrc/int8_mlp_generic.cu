// Width-generic fused w8a8 transformer MLP (K5g) on Hopper's int8 tensor
// cores: per-row int8 quantization of x, the int8 fc1 product,
// dequantization + bias, tanh GELU, per-row requantization from the fp32
// hidden row, the int8 fc2 product, dequantization + bias -- at every shape
// and type the kernel of int8_mlp.cu (K5: N = 4096, K a multiple of 128)
// does not take.
//
// Replaces the TPU kernel painter_tpu/kernels/int8_mlp.py:_int8_mlp_2d
// (kernel _kernel) at those shapes; the wrapper (kernels/int8_mlp.py
// int8_mlp_route) sends a shape here by its dims and type alone.
//
// Contract: K5's (int8_mlp.cu), per row i of x (M, K) in bf16 or fp32, for
// any M >= 1, K >= 1, N >= 1, with W1q int8 (N, K), fp32 s1, b1 (N,), W2q
// int8 (K, N), fp32 s2, b2 (K,) (the torch (out, in) layout):
//   a1   = max_k |x[i, k]| (fp32); xq = clip(rint(x * 127 / max(a1, 1e-20)),
//          -127, 127); r1 = a1 * (1/127)
//   h[j] = gelu_tanh(int32(xq . W1q[j]) * (r1 * s1[j]) + b1[j])   fp32
//   a2   = max_j |h[j]|; hq = clip(rint(h * 127 / max(a2, 1e-20)), ...);
//   r2   = a2 * (1/127)
//   out[k] = int32(hq . W2q[k]) * (r2 * s2[k]) + b2[k], in x's type
// rint rounds half to even, as jnp.round does. The int32 sums are exact in
// any order; every fp32 step is in the JAX kernel's order with no
// contraction into FMAs, so kernel and plain version agree to the bit
// where their tanhf does.
//
// What bounds it on an H100: operations, 2 * M * K * N * 2 int8 ops (1.18e11
// at a ViT-B-wide SegGPT's b8 trunk, M 12544, K 768, N 3072: 0.0598 ms at
// 1,979 TOP/s dense int8) against x and out, the weights and, in this
// design, the fp32 hidden scratch (M N 4 B written once and read once by
// the requantization: 154 MB at that shape, ~0.05 ms each way at 3.35
// TB/s).
//
// Design: four launches on the stream, no atomics and no split of the
// depth, so two runs give the same bits.
//   (a) quant_rows<T>: one warp per row of x; the row maximum by a butterfly
//       of shuffles, then xq (M, Kp) int8 with K zero-padded to Kp, a
//       multiple of 16 (16-byte aligned rows: a TMA source), and r1. Where
//       K is a multiple of 8, a lane reads 8 elements a step (16-byte
//       loads) and writes their 8 codes at once, as K5's quantize launch.
//   (b) tc_gemm<BN, GeluEpi>: fc1 on wgmma.mma_async m64nBNk32 .s32.s8.s8.
//       A CTA computes 128 rows x BN (128 or 256) output columns: two
//       consumer warpgroups of 64 rows each hold the int32 accumulators (BN
//       / 2 registers a thread, setmaxnreg 240), a producer warpgroup
//       (setmaxnreg 24) of which one thread streams 128-byte-deep slices of
//       A (xq) and B (W1q rows) by TMA -- 2-D maps, 128-byte swizzle, both
//       K-major as the torch layouts give them -- through a ring of 4 stages
//       guarded by full / empty mbarriers; each slice is four k32 products.
//       This is K5's fc2 mainloop with its fixed N, K % 128 and cluster
//       replaced by tile counts known at run time. The ragged edges: depth
//       past K, rows past M and columns past N lie outside the TMA maps,
//       which zero-fill them (a zero int8 adds nothing), and the stores
//       mask them. Every box starts inside its map (the last depth slice at
//       t KC < K, the tiles at m0 < M, n0 < N), with one B box of BN rows.
//       The epilogue dequantizes, adds b1 and applies the GELU on the
//       accumulator fragments, writing fp32 h (M, N) to a scratch the
//       wrapper allocates (pairs of columns as one 8-byte store where N is
//       even), and each row's |h| maximum over the CTA's BN columns (a
//       row's columns lie in one quad of lanes: two shuffles) to tmax (M,
//       N / BN), no atomics.
//   (c) quant_rows<float> on h: hq (M, Np) and r2. The requantization needs
//       the maximum over all N of a row, which spans N / BN CTAs of (b):
//       this launch takes it as the maximum of the row's tmax entries, so
//       it reads h once (maxima are order-free: the same bits as the
//       row's own maximum).
//   (d) tc_gemm<BN, OutEpi<T>>: fc2 the same way (A = hq, B = W2q rows),
//       dequantization + bias, out (M, K) in x's type.
// BN: the wrapper's choice (int8_mlp.py k5g_tile_n), the width whose waves
// of one CTA per SM give each SM the fewest output columns.
// Weights whose row stride is not a multiple of 16 bytes (K or N not a
// multiple of 16) cannot be TMA sources: the wrapper stages a zero-padded
// copy per call (ldw1 / ldw2 below; at most a few MB, and none at the
// widths the port's models use), which keeps one load path -- TMA -- for
// every shape instead of a second cp.async mainloop for the odd ones.
//
// The launchers allocate nothing and do not synchronize: the caller passes
// xq, r1, h, hq and r2 as scratch. They return cudaGetLastError() (or
// cudaErrorInvalidValue for operands they do not take) so the caller can
// raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {
namespace k5g {

using namespace hopper;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ int8_t quant(float v, float inv) {
  return (int8_t)fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.0f), 127.0f);
}

// every product and sum rounded on its own (no contraction into FMAs), in
// the order of the plain version
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(0.7978845608028654f,
                                __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

// int32 sum -> float, times (row scale * column scale), plus the bias
__device__ __forceinline__ float dequant(int acc, float r, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(r, s)), b);
}

// --- (a), (c) per-row quantization -----------------------------------------

constexpr int Q_WARPS = 8;

// elements [k, k + 8) of a row as four fp32 pairs (16-byte loads)
__device__ __forceinline__ void load8(const bf16* p, float2 (&f)[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __bfloat1622float2(h[i]);
}
__device__ __forceinline__ void load8(const float* p, float2 (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = make_float2(a.x, a.y);
  f[1] = make_float2(a.z, a.w);
  f[2] = make_float2(b.x, b.y);
  f[3] = make_float2(b.z, b.w);
}

// one warp per row: the row maximum by a butterfly of shuffles (maxima are
// order-free) over the row, or over the ``tiles`` maxima ``tmax`` (M,
// tiles) already taken of it, then the codes with the row zero-padded to
// ldq. ``vec``: K is a multiple of 8 and the rows 16-byte aligned, so a
// lane takes 8 elements a step by 16-byte loads and writes their 8 codes
// at once
template <typename T>
__global__ void __launch_bounds__(Q_WARPS * 32)
quant_rows(const T* __restrict__ x, int8_t* __restrict__ q,
           float* __restrict__ rs, int M, int K, int ldq, int vec,
           const float* __restrict__ tmax, int tiles) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * Q_WARPS + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  int8_t* qr = q + (size_t)row * ldq;
  float amax = 0.0f;
  if (tmax) {
    for (int i = lane; i < tiles; i += 32)
      amax = fmaxf(amax, tmax[(size_t)row * tiles + i]);
  } else if (vec) {
    for (int k = 8 * lane; k < K; k += 256) {
      float2 f[4];
      load8(xr + k, f);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        amax = fmaxf(amax, fmaxf(fabsf(f[i].x), fabsf(f[i].y)));
    }
  } else {
    for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f(xr[k])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float inv = 127.0f / fmaxf(amax, 1e-20f);
  if (vec) {
    for (int k = 8 * lane; k < K; k += 256) {
      float2 f[4];
      load8(xr + k, f);
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i / 2] |=
            ((uint32_t)(uint8_t)quant(f[i].x, inv) << (16 * (i % 2))) |
            ((uint32_t)(uint8_t)quant(f[i].y, inv) << (16 * (i % 2) + 8));
      *reinterpret_cast<uint2*>(qr + k) = make_uint2(w[0], w[1]);
    }
    for (int k = K + lane; k < ldq; k += 32) qr[k] = 0;
  } else {
    for (int k = lane; k < ldq; k += 32)
      qr[k] = k < K ? quant(to_f(xr[k]), inv) : (int8_t)0;
  }
  if (lane == 0) rs[row] = amax * (1.0f / 127.0f);
}

// --- (b), (d) the int8 products on the tensor cores ------------------------

constexpr int BM = 128;               // rows per CTA, 64 per warpgroup
constexpr int KC = 128;               // depth bytes per ring stage
constexpr int STAGES = 4;
constexpr int THREADS = 384;          // two consumer warpgroups + producer
constexpr int CONSUMERS = 256;
constexpr int A_BYTES = BM * KC;      // 16 KiB of A per stage

template <int BN>
__host__ __device__ constexpr int stage_bytes() { return A_BYTES + BN * KC; }
template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + STAGES * stage_bytes<BN>() + 16 * STAGES;
}
static_assert(smem_bytes<256>() <= 232448, "K5g shared memory");

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t da,
                                           uint64_t db, int acc);
template <>
__device__ __forceinline__ void wgmma_tile<128>(int (&d)[64], uint64_t da,
                                                uint64_t db, int acc) {
  wgmma_m64n128k32_s8(d, da, db, acc);
}
template <>
__device__ __forceinline__ void wgmma_tile<256>(int (&d)[128], uint64_t da,
                                                uint64_t db, int acc) {
  wgmma_m64n256k32_s8(d, da, db, acc);
}

// fc1's epilogue: fp32 h = gelu(dequant + b1), and each row's |h| maximum
// over the CTA's columns into tmax (M, tiles)
struct GeluEpi {
  typedef float Out;
  static constexpr bool ROW_MAX = true;
  const float* r;
  const float* s;
  const float* b;
  float* out;
  float* tmax;
  __device__ __forceinline__ float operator()(int acc, float r_m, float s_n,
                                              float b_n) const {
    return gelu_tanh(dequant(acc, r_m, s_n, b_n));
  }
};

// fc2's epilogue: out = dequant + b2, in the output type
template <typename T>
struct OutEpi {
  typedef T Out;
  static constexpr bool ROW_MAX = false;
  const float* r;
  const float* s;
  const float* b;
  T* out;
  __device__ __forceinline__ float operator()(int acc, float r_m, float s_n,
                                              float b_n) const {
    return dequant(acc, r_m, s_n, b_n);
  }
};

// outputs (m, c) and (m, c + 1) of a row-major output; ``vec``: one
// aligned store (the row stride is even, so m N + c is)
__device__ __forceinline__ void store2(float* p, float a, float b, bool vec) {
  if (vec) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    p[1] = b;
  }
}
__device__ __forceinline__ void store2(bf16* p, float a, float b, bool vec) {
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    p[1] = __float2bfloat16_rn(b);
  }
}

// C[m, n] = sum_k A[m, k] B[n, k] over k < K, A (M, K) and B (N, K) int8
// through the TMA maps tm_a (boxes of BM rows) and tm_b (boxes of BN rows),
// then epi at every (m < M, n < N) of C (row stride N)
template <int BN, typename Epi>
__global__ void __launch_bounds__(THREADS, 1)
tc_gemm(const __grid_constant__ CUtensorMap tm_a,
        const __grid_constant__ CUtensorMap tm_b, int M, int N, int K,
        Epi epi) {
  constexpr int STAGE = stage_bytes<BN>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_full = s_base + STAGES * STAGE;
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int nk = (K + KC - 1) / KC;

  if (tid == CONSUMERS) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % STAGES;
        mbar_wait(bar_empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        const uint32_t dst = s_base + s * STAGE;
        mbar_expect_tx(bar_full + 8 * s, STAGE);
        tma_load_2d(dst, &tm_a, t * KC, m0, bar_full + 8 * s);
        tma_load_2d(dst + A_BYTES, &tm_b, t * KC, n0, bar_full + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

    for (int t = 0; t < nk; ++t) {
      const int s = t % STAGES;
      mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
      const uint32_t st = s_base + s * STAGE;
      const uint64_t da = desc_sw128(st + wg * (A_BYTES / 2), 16, 1024);
      const uint64_t db = desc_sw128(st + A_BYTES, 16, 1024);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 32; ++kk)
        wgmma_tile<BN>(acc, da + 2 * kk, db + 2 * kk, t > 0 || kk > 0);
      wgmma_commit();
      if (t > 0) {
        wgmma_wait<1>();
        mbar_arrive(bar_empty + 8 * ((t - 1) % STAGES));
      }
    }
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(bar_empty + 8 * ((nk - 1) % STAGES));

    // element 4j + 2h + e of the fragments is row ra + 8h, column
    // n0 + 8j + 2tq + e
    const int ra = m0 + wg * 64 + warp * 16 + g;
    const float r_a = ra < M ? epi.r[ra] : 0.0f;
    const float r_b = ra + 8 < M ? epi.r[ra + 8] : 0.0f;
    const bool vec = (N & 1) == 0;
    typedef typename Epi::Out Out;
    float ma = 0.0f, mb = 0.0f;  // |value| maxima of rows ra, ra + 8
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * tq;
      if (c >= N) continue;
      const bool two = c + 1 < N;
      const float s0 = epi.s[c], b0 = epi.b[c];
      const float s1 = two ? epi.s[c + 1] : 0.0f;
      const float b1 = two ? epi.b[c + 1] : 0.0f;
      if (ra < M) {
        Out* p = epi.out + (size_t)ra * N + c;
        const float v0 = epi(acc[4 * j], r_a, s0, b0);
        const float v1 = two ? epi(acc[4 * j + 1], r_a, s1, b1) : 0.0f;
        ma = fmaxf(ma, fmaxf(fabsf(v0), fabsf(v1)));
        if (two)
          store2(p, v0, v1, vec);
        else
          p[0] = from_f<Out>(v0);
      }
      if (ra + 8 < M) {
        Out* p = epi.out + (size_t)(ra + 8) * N + c;
        const float v0 = epi(acc[4 * j + 2], r_b, s0, b0);
        const float v1 = two ? epi(acc[4 * j + 3], r_b, s1, b1) : 0.0f;
        mb = fmaxf(mb, fmaxf(fabsf(v0), fabsf(v1)));
        if (two)
          store2(p, v0, v1, vec);
        else
          p[0] = from_f<Out>(v0);
      }
    }
    if constexpr (Epi::ROW_MAX) {
      // a row's columns lie in the four lanes of its quad
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, off));
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      }
      if (tq == 0) {
        if (ra < M) epi.tmax[(size_t)ra * gridDim.x + blockIdx.x] = ma;
        if (ra + 8 < M)
          epi.tmax[(size_t)(ra + 8) * gridDim.x + blockIdx.x] = mb;
      }
    }
  }
}

// an int8 matrix of ``rows`` rows of ``cols`` bytes at row stride ``ld`` (a
// multiple of 16) as TMA boxes of (box_rows, KC bytes); box elements past
// ``cols`` or ``rows`` are zero-filled
bool map_i8(CUtensorMap* map, const void* ptr, int rows, int cols, int ld,
            int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {KC, (cuuint32_t)box_rows};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, ptr, dims, strides,
                    box);
}

template <int BN, typename Epi>
int launch_gemm(const int8_t* a, int lda, const int8_t* b, int ldb, int M,
                int N, int K, const Epi& epi, cudaStream_t st) {
  CUtensorMap m_a, m_b;
  if (!map_i8(&m_a, a, M, K, lda, BM) || !map_i8(&m_b, b, N, K, ldb, BN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tc_gemm<BN, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<BN>());
  if (err != cudaSuccess) return (int)err;
  tc_gemm<BN, Epi><<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM), THREADS,
                     smem_bytes<BN>(), st>>>(m_a, m_b, M, N, K, epi);
  return (int)cudaGetLastError();
}

template <typename Epi>
int gemm(const int8_t* a, int lda, const int8_t* b, int ldb, int M, int N,
         int K, int bn, const Epi& epi, cudaStream_t st) {
  return bn == 256 ? launch_gemm<256>(a, lda, b, ldb, M, N, K, epi, st)
                   : launch_gemm<128>(a, lda, b, ldb, M, N, K, epi, st);
}

inline int round16(int v) { return (v + 15) / 16 * 16; }

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* x, const void* w1, const void* s1, const void* b1,
           const void* w2, const void* s2, const void* b2, void* out,
           void* xq, void* row1, void* h, void* tmax, void* hq, void* row2,
           int M, int K, int N, int ldw1, int ldw2, int bn1, int bn2,
           cudaStream_t st) {
  const bool bn_ok = (bn1 == 128 || bn1 == 256) && (bn2 == 128 || bn2 == 256);
  if (M < 1 || K < 1 || N < 1 || !bn_ok || ldw1 < K || ldw1 % 16 ||
      ldw2 < N || ldw2 % 16 || !aligned16(w1) || !aligned16(w2) ||
      !aligned16(xq) || !aligned16(hq))
    return (int)cudaErrorInvalidValue;
  const int kp = round16(K), np = round16(N);
  const dim3 q_grid((M + Q_WARPS - 1) / Q_WARPS);
  quant_rows<T><<<q_grid, Q_WARPS * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(row1), M, K, kp, K % 8 == 0 && aligned16(x),
      nullptr, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const GeluEpi fc1{static_cast<const float*>(row1),
                    static_cast<const float*>(s1),
                    static_cast<const float*>(b1), static_cast<float*>(h),
                    static_cast<float*>(tmax)};
  int rc = gemm(static_cast<const int8_t*>(xq), kp,
                static_cast<const int8_t*>(w1), ldw1, M, N, K, bn1, fc1, st);
  if (rc) return rc;

  quant_rows<float><<<q_grid, Q_WARPS * 32, 0, st>>>(
      static_cast<const float*>(h), static_cast<int8_t*>(hq),
      static_cast<float*>(row2), M, N, np, N % 8 == 0 && aligned16(h),
      static_cast<const float*>(tmax), (N + bn1 - 1) / bn1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const OutEpi<T> fc2{static_cast<const float*>(row2),
                      static_cast<const float*>(s2),
                      static_cast<const float*>(b2), static_cast<T*>(out)};
  return gemm(static_cast<const int8_t*>(hq), np,
              static_cast<const int8_t*>(w2), ldw2, M, K, N, bn2, fc2, st);
}

}  // namespace k5g
}  // namespace

extern "C" {

// x (M, K) -> out (M, K) in x's type. Scratch of the caller: xq (M, Kp)
// int8, row1 (M,) fp32, h (M, N) fp32, tmax (M, ceil(N / bn1)) fp32, hq
// (M, Np) int8, row2 (M,) fp32, with Kp and Np K and N rounded up to
// multiples of 16. The weights' row
// strides ldw1 (>= K) and ldw2 (>= N) are multiples of 16 bytes, their
// columns past K / N are not read; xq, hq and the weights are 16-byte
// aligned. bn1 / bn2: fc1's and fc2's output-tile widths, 128 or 256.
int int8_mlp_generic_bf16(const void* x, const void* w1, const void* s1,
                          const void* b1, const void* w2, const void* s2,
                          const void* b2, void* out, void* xq, void* row1,
                          void* h, void* tmax, void* hq, void* row2, int M,
                          int K, int N, int ldw1, int ldw2, int bn1, int bn2,
                          void* stream) {
  return k5g::launch<k5g::bf16>(x, w1, s1, b1, w2, s2, b2, out, xq, row1, h,
                                tmax, hq, row2, M, K, N, ldw1, ldw2, bn1, bn2,
                                static_cast<cudaStream_t>(stream));
}

int int8_mlp_generic_f32(const void* x, const void* w1, const void* s1,
                         const void* b1, const void* w2, const void* s2,
                         const void* b2, void* out, void* xq, void* row1,
                         void* h, void* tmax, void* hq, void* row2, int M,
                         int K, int N, int ldw1, int ldw2, int bn1, int bn2,
                         void* stream) {
  return k5g::launch<float>(x, w1, s1, b1, w2, s2, b2, out, xq, row1, h,
                            tmax, hq, row2, M, K, N, ldw1, ldw2, bn1, bn2,
                            static_cast<cudaStream_t>(stream));
}

const char* int8_mlp_generic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
