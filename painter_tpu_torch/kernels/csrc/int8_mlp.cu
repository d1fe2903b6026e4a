// Fused w8a8 transformer MLP (Hopper): per-row int8 quantization of x, the
// int8 fc1 product, dequantization + bias, tanh GELU, per-row
// requantization from the fp32 hidden row, the int8 fc2 product,
// dequantization + bias.
//
// Replaces the TPU kernel painter_tpu/kernels/int8_mlp.py:_int8_mlp_2d
// (kernel _kernel), reached through int8_mlp.
//
// Contract, per row i of x (M, K) bf16 or fp32, with fc1 weights
// W1q int8 (N, K), fp32 scales s1 (N,) and bias b1 (N,), fc2 W2q int8
// (K, N), s2 (K,), b2 (K,) (the torch (out, in) layout):
//   a1   = max_k |x[i, k]|  (fp32);  xq = clip(rint(x * 127 / max(a1,
//          1e-20)), -127, 127);  r1 = a1 * (1/127)
//   h[j] = gelu_tanh(int32(xq . W1q[j]) * (r1 * s1[j]) + b1[j])   fp32
//   a2   = max_j |h[j]|;  hq = clip(rint(h * 127 / max(a2, 1e-20)), ...)
//   r2   = a2 * (1/127)
//   out[k] = int32(hq . W2q[k]) * (r2 * s2[k]) + b2[k], in x's type
// rint rounds half to even, as jnp.round does. The int32 sums are exact;
// everything else is fp32, in the JAX kernel's order (no contraction into
// FMAs), so kernel and plain version agree to the bit where their tanhf
// does. x's type touches only the quantize launch's loads and fc2's stores:
// from the quantized x on, bf16 and fp32 run the same code.
//
// What bounds it on an H100: operations. It does 2 * M * K * N * 2 int8
// operations -- 2.10e11 at M = 12544 (ViT-L b8 trunk, K = 1024, N =
// 4096), 0.106 ms at 1,979 TOP/s dense int8 -- and its IO is x and out in
// bf16 plus 8 MiB of weights, 59.8 MB (0.018 ms at 3.35 TB/s; in fp32
// 111.2 MB, 0.033 ms).
//
// Design: three launches on the stream, all sm_90a.
//   (1) quantize: one warp per row writes xq (M, K) int8 and r1; a lane
//       reads 8 elements a step (one 16-byte load in bf16, two in fp32).
//   (2) fc1: a thread-block cluster of 8 CTAs per 64-row block of x; CTA r
//       owns hidden columns [512 r, 512 r + 512). Two consumer warpgroups
//       each hold a m64n256 int32 accumulator (128 registers a thread) fed
//       by wgmma m64n256k32 s8.s8.s32, A = xq and B = W1q rows, both K-major
//       as the torch layouts give them; a producer warp streams 128-deep
//       k slices of both by TMA (2-D maps, 128-byte swizzle, rows past M
//       zero-filled) through a ring of 3 stages guarded by full / empty
//       mbarriers. Dequantization, bias and GELU run on the accumulator
//       fragments; each row's |h| maximum over the CTA's 512 columns takes
//       two quad shuffles and a shared-memory max of the two warpgroups,
//       and the full row maximum over 4096 columns is the max of the eight
//       CTAs' values read through distributed shared memory between two
//       cluster barriers. The fp32 hidden values never leave the registers:
//       they are requantized in place and only their int8 codes are written
//       (staged through shared memory, 16-byte stores), with r2.
//   (3) fc2: out = hq . W2q^T as a plain tiled GEMM, 128 rows x 256 output
//       columns per CTA (two consumer warpgroups of m64n256k32, a 4-stage
//       TMA ring), or 128 columns (m64n128k32) where 256-column tiles would
//       not fill two waves of SMs (the b1 shapes); dequantization + bias on
//       the fragments, stores in x's type.
// Why the int8 hidden codes go through L2 instead of staying on chip: an
// fc2 output row spans all 1024 columns, and its int32 accumulators for a
// 64-row block are 256 KiB -- more than the registers or the shared memory
// of an SM. Keeping hq on chip means either reducing 256 KiB of int32
// partials per CTA across the cluster through distributed shared memory or
// gathering the other CTAs' hq slices into a ring of local copies; both
// move more bytes between SMs than the 32 KiB of codes each fc1 CTA writes
// here, and the codes of a b8 call (51 MB) are read back once by fc2. The
// fp32 h -- the value whose row maximum needs the cluster -- stays on chip,
// which removes the old kernel's second fc1 pass. Rows per weight byte:
// fc1 serves 64 rows per W1 byte read (CTA tile 64 x 512), fc2 128 rows per
// W2 byte, against 32 rows per 12 MiB in the old mma.sync kernel.
// Determinism: maxima and int32 sums are order-free, every fp32 step has a
// fixed order, no atomics: two runs give the same bits.
//
// The launcher allocates nothing and does not synchronize: the caller
// passes xq, r1, hq and r2 as scratch. It returns cudaGetLastError() so the
// caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int KC = 128;               // k bytes per ring stage
constexpr int CL = 8;                 // fc1 cluster: hidden slices
constexpr int SLICE = 512;            // hidden columns per fc1 CTA
constexpr int HIDDEN = CL * SLICE;    // N the kernel is built for
constexpr int THREADS = 384;          // two consumer warpgroups + producer
constexpr int CONSUMERS = 256;

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

__device__ __forceinline__ void consumer_bar() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// --- (1) row quantization of x ----------------------------------------------

constexpr int Q_WARPS = 8;

// elements [k, k + 8) of a row as four fp32 pairs
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float2 (&f)[4]) {
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

template <typename T>
__global__ void __launch_bounds__(Q_WARPS * 32)
quant_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
             float* __restrict__ row1, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * Q_WARPS + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  float amax = 0.0f;
  for (int k = 8 * lane; k < K; k += 256) {
    float2 f[4];
    load8(xr + k, f);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      amax = fmaxf(amax, fmaxf(fabsf(f[i].x), fabsf(f[i].y)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float inv = 127.0f / fmaxf(amax, 1e-20f);
  for (int k = 8 * lane; k < K; k += 256) {
    float2 f[4];
    load8(xr + k, f);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i / 2] |= ((uint32_t)(uint8_t)quant(f[i].x, inv) << (16 * (i % 2))) |
                  ((uint32_t)(uint8_t)quant(f[i].y, inv) << (16 * (i % 2) + 8));
    *reinterpret_cast<uint2*>(xq + (size_t)row * K + k) = make_uint2(w[0], w[1]);
  }
  if (lane == 0) row1[row] = amax * (1.0f / 127.0f);
}

// --- (2) fc1, GELU, requantization: one cluster per 64 rows ----------------

constexpr int F1_ROWS = 64;
constexpr int F1_STAGES = 3;
constexpr int F1_A = F1_ROWS * KC;          // 8 KiB of xq
constexpr int F1_B = SLICE * KC;            // 64 KiB of W1q rows
constexpr int F1_STAGE = F1_A + F1_B;
constexpr int F1_OFF_BAR = F1_STAGES * F1_STAGE;
constexpr int F1_OFF_PMAX = F1_OFF_BAR + 64;        // 64 fp32: CTA row maxima
constexpr int F1_OFF_WMAX = F1_OFF_PMAX + 256;      // 2 x 64 fp32
constexpr int F1_OFF_SB = F1_OFF_WMAX + 512;        // s1, b1 of the slice
constexpr int F1_SMEM = 1024 + F1_OFF_SB + 2 * SLICE * 4;
constexpr int HQ_LD = SLICE + 16;           // staging row stride (bytes)
static_assert(F1_ROWS * HQ_LD <= F1_STAGE, "hq staging fits stage 0");
static_assert(F1_SMEM <= 232448, "fc1 shared memory");

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS, 1)
fc1_kernel(const __grid_constant__ CUtensorMap tm_xq,
           const __grid_constant__ CUtensorMap tm_w1,
           const float* __restrict__ row1, const float* __restrict__ s1,
           const float* __restrict__ b1, int8_t* __restrict__ hq,
           float* __restrict__ row2, int M, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_full = s_base + F1_OFF_BAR;
  const uint32_t bar_empty = bar_full + 8 * F1_STAGES;
  float* pmax = reinterpret_cast<float*>(smem + F1_OFF_PMAX);
  float* wmax = reinterpret_cast<float*>(smem + F1_OFF_WMAX);
  float* sv = reinterpret_cast<float*>(smem + F1_OFF_SB);  // s1 of the slice
  float* bv = sv + SLICE;                                  // b1

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * SLICE;
  const int row0 = blockIdx.y * F1_ROWS;
  const int nk = K / KC;

  if (tid == CONSUMERS) {
    for (int s = 0; s < F1_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < SLICE; i += THREADS) {
    sv[i] = s1[n0 + i];
    bv[i] = b1[n0 + i];
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % F1_STAGES;
        mbar_wait(bar_empty + 8 * s, ((t / F1_STAGES) & 1) ^ 1);
        const uint32_t dst = s_base + s * F1_STAGE;
        mbar_expect_tx(bar_full + 8 * s, F1_STAGE);
        tma_load_2d(dst, &tm_xq, t * KC, row0, bar_full + 8 * s);
        tma_load_2d(dst + F1_A, &tm_w1, t * KC, n0, bar_full + 8 * s);
        tma_load_2d(dst + F1_A + F1_B / 2, &tm_w1, t * KC, n0 + SLICE / 2,
                    bar_full + 8 * s);
      }
    }
    cluster_sync();  // the CTAs' row maxima are published
    cluster_sync();  // every CTA has read them
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;

    for (int t = 0; t < nk; ++t) {
      const int s = t % F1_STAGES;
      mbar_wait(bar_full + 8 * s, (t / F1_STAGES) & 1);
      const uint32_t st = s_base + s * F1_STAGE;
      const uint64_t da = desc_sw128(st, 16, 1024);
      const uint64_t db = desc_sw128(st + F1_A + wg * (F1_B / 2), 16, 1024);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 32; ++kk)
        wgmma_m64n256k32_s8(acc, da + 2 * kk, db + 2 * kk, t > 0 || kk > 0);
      wgmma_commit();
      if (t > 0) {
        wgmma_wait<1>();
        mbar_arrive(bar_empty + 8 * ((t - 1) % F1_STAGES));
      }
    }
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(bar_empty + 8 * ((nk - 1) % F1_STAGES));

    // dequantize, bias, GELU on the fragments: element 4j + 2h + e is row
    // ra + 8h, slice column 256 wg + 8j + 2tq + e
    const int lr = warp * 16 + g;  // local rows lr, lr + 8
    const int ra = row0 + lr;
    const float r1a = ra < M ? row1[ra] : 0.0f;
    const float r1b = ra + 8 < M ? row1[ra + 8] : 0.0f;
    float h[128];
    float ma = 0.0f, mb = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = wg * 256 + 8 * j + 2 * tq + e;
        const float sc = sv[c], bc = bv[c];
        const float ha = gelu_tanh(
            __fadd_rn(__fmul_rn((float)acc[4 * j + e], __fmul_rn(r1a, sc)), bc));
        const float hb = gelu_tanh(__fadd_rn(
            __fmul_rn((float)acc[4 * j + 2 + e], __fmul_rn(r1b, sc)), bc));
        h[4 * j + e] = ha;
        h[4 * j + 2 + e] = hb;
        ma = fmaxf(ma, fabsf(ha));
        mb = fmaxf(mb, fabsf(hb));
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, off));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
    }
    if (tq == 0) {
      wmax[wg * 64 + lr] = ma;
      wmax[wg * 64 + lr + 8] = mb;
    }
    consumer_bar();
    if (tid < F1_ROWS) pmax[tid] = fmaxf(wmax[tid], wmax[64 + tid]);
    cluster_sync();  // the CTAs' row maxima are published
    float a2a = 0.0f, a2b = 0.0f;
    const uint32_t pa = smem_u32(pmax + lr);
#pragma unroll
    for (int r = 0; r < CL; ++r) {
      a2a = fmaxf(a2a, ld_cluster_f32(pa, r));
      a2b = fmaxf(a2b, ld_cluster_f32(pa + 32, r));
    }
    cluster_sync();  // every CTA has read them

    // requantize into the staging tile (stage 0: every stage is consumed),
    // then 16-byte stores of the slice's codes
    const float inv_a = 127.0f / fmaxf(a2a, 1e-20f);
    const float inv_b = 127.0f / fmaxf(a2b, 1e-20f);
    unsigned char* stage = smem;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = wg * 256 + 8 * j + 2 * tq;
      const uint16_t qa = (uint16_t)(uint8_t)quant(h[4 * j], inv_a) |
                          ((uint16_t)(uint8_t)quant(h[4 * j + 1], inv_a) << 8);
      const uint16_t qb = (uint16_t)(uint8_t)quant(h[4 * j + 2], inv_b) |
                          ((uint16_t)(uint8_t)quant(h[4 * j + 3], inv_b) << 8);
      *reinterpret_cast<uint16_t*>(stage + lr * HQ_LD + c) = qa;
      *reinterpret_cast<uint16_t*>(stage + (lr + 8) * HQ_LD + c) = qb;
    }
    if (blockIdx.x == 0 && wg == 0 && tq == 0) {
      if (ra < M) row2[ra] = a2a * (1.0f / 127.0f);
      if (ra + 8 < M) row2[ra + 8] = a2b * (1.0f / 127.0f);
    }
    consumer_bar();
    for (int i = tid; i < F1_ROWS * (SLICE / 16); i += CONSUMERS) {
      const int r = i / (SLICE / 16);
      const int c = (i % (SLICE / 16)) * 16;
      if (row0 + r < M)
        *reinterpret_cast<uint4*>(hq + (size_t)(row0 + r) * HIDDEN + n0 + c) =
            *reinterpret_cast<const uint4*>(stage + r * HQ_LD + c);
    }
  }
}

// --- (3) fc2: out = hq . W2q^T, 128-row tiles of BN output columns ---------

constexpr int F2_ROWS = 128;
constexpr int F2_BOX = 128;                 // W2q rows per TMA box
constexpr int F2_STAGES = 4;
constexpr int F2_A = F2_ROWS * KC;          // 16 KiB of hq

template <int BN>
__host__ __device__ constexpr int f2_stage() { return F2_A + BN * KC; }
template <int BN>
__host__ __device__ constexpr int f2_smem() {
  return 1024 + F2_STAGES * f2_stage<BN>() + 64;
}
static_assert(f2_smem<256>() <= 232448, "fc2 shared memory");

template <int BN>
__device__ __forceinline__ void wgmma_fc2(int (&d)[BN / 2], uint64_t da,
                                          uint64_t db, int acc);
template <>
__device__ __forceinline__ void wgmma_fc2<128>(int (&d)[64], uint64_t da,
                                               uint64_t db, int acc) {
  wgmma_m64n128k32_s8(d, da, db, acc);
}
template <>
__device__ __forceinline__ void wgmma_fc2<256>(int (&d)[128], uint64_t da,
                                               uint64_t db, int acc) {
  wgmma_m64n256k32_s8(d, da, db, acc);
}

// two adjacent outputs in the output type
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <int BN, typename T>
__global__ void __launch_bounds__(THREADS, 1)
fc2_kernel(const __grid_constant__ CUtensorMap tm_hq,
           const __grid_constant__ CUtensorMap tm_w2,
           const float* __restrict__ row2, const float* __restrict__ s2,
           const float* __restrict__ b2, T* __restrict__ out, int M, int K) {
  constexpr int STAGE = f2_stage<BN>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_full = s_base + F2_STAGES * STAGE;
  const uint32_t bar_empty = bar_full + 8 * F2_STAGES;

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * F2_ROWS;
  constexpr int nk = HIDDEN / KC;

  if (tid == CONSUMERS) {
    for (int s = 0; s < F2_STAGES; ++s) {
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
        const int s = t % F2_STAGES;
        mbar_wait(bar_empty + 8 * s, ((t / F2_STAGES) & 1) ^ 1);
        const uint32_t dst = s_base + s * STAGE;
        mbar_expect_tx(bar_full + 8 * s, STAGE);
        tma_load_2d(dst, &tm_hq, t * KC, row0, bar_full + 8 * s);
        for (int h = 0; h < BN / F2_BOX; ++h)
          tma_load_2d(dst + F2_A + h * F2_BOX * KC, &tm_w2, t * KC,
                      c0 + h * F2_BOX, bar_full + 8 * s);
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
      const int s = t % F2_STAGES;
      mbar_wait(bar_full + 8 * s, (t / F2_STAGES) & 1);
      const uint32_t st = s_base + s * STAGE;
      const uint64_t da = desc_sw128(st + wg * (F2_A / 2), 16, 1024);
      const uint64_t db = desc_sw128(st + F2_A, 16, 1024);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 32; ++kk)
        wgmma_fc2<BN>(acc, da + 2 * kk, db + 2 * kk, t > 0 || kk > 0);
      wgmma_commit();
      if (t > 0) {
        wgmma_wait<1>();
        mbar_arrive(bar_empty + 8 * ((t - 1) % F2_STAGES));
      }
    }
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(bar_empty + 8 * ((nk - 1) % F2_STAGES));

    const int ra = row0 + wg * 64 + warp * 16 + g;
    const float r2a = ra < M ? row2[ra] : 0.0f;
    const float r2b = ra + 8 < M ? row2[ra + 8] : 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = c0 + 8 * j + 2 * tq;
      const float sa = s2[c], sb = s2[c + 1];
      const float ba = b2[c], bb = b2[c + 1];
      if (ra < M)
        store2(out + (size_t)ra * K + c,
               __fadd_rn(__fmul_rn((float)acc[4 * j], __fmul_rn(r2a, sa)), ba),
               __fadd_rn(__fmul_rn((float)acc[4 * j + 1], __fmul_rn(r2a, sb)),
                         bb));
      if (ra + 8 < M)
        store2(out + (size_t)(ra + 8) * K + c,
               __fadd_rn(__fmul_rn((float)acc[4 * j + 2], __fmul_rn(r2b, sa)),
                         ba),
               __fadd_rn(__fmul_rn((float)acc[4 * j + 3], __fmul_rn(r2b, sb)),
                         bb));
    }
  }
}

template <int BN, typename T>
int launch_fc2(const CUtensorMap& m_hq, const CUtensorMap& m_w2,
               const void* row2, const void* s2, const void* b2, void* out,
               int M, int K, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      fc2_kernel<BN, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      f2_smem<BN>());
  if (err != cudaSuccess) return (int)err;
  fc2_kernel<BN, T><<<dim3(K / BN, (M + F2_ROWS - 1) / F2_ROWS), THREADS,
                      f2_smem<BN>(), st>>>(
      m_hq, m_w2, static_cast<const float*>(row2),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<T*>(out), M, K);
  return (int)cudaGetLastError();
}

// an int8 (rows, cols) row-major matrix as TMA boxes of (box_rows, 128)
bool map_i8(CUtensorMap* map, const void* ptr, int rows, int cols,
            int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {KC, (cuuint32_t)box_rows};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, ptr, dims, strides,
                    box);
}

// T: the type of x and out (bf16 or fp32), both 16-byte aligned
template <typename T>
int launch(const void* x, const void* w1, const void* s1, const void* b1,
           const void* w2, const void* s2, const void* b2, void* out,
           void* xq, void* row1, void* hq, void* row2, int M, int K, int N,
           cudaStream_t st) {
  if (N != HIDDEN || K % F2_BOX || M < 1 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m_xq, m_w1, m_hq, m_w2;
  if (!map_i8(&m_xq, xq, M, K, F1_ROWS) ||
      !map_i8(&m_w1, w1, N, K, SLICE / 2) ||
      !map_i8(&m_hq, hq, M, N, F2_ROWS) || !map_i8(&m_w2, w2, K, N, F2_BOX))
    return (int)cudaErrorInvalidValue;

  quant_kernel<T><<<(M + Q_WARPS - 1) / Q_WARPS, Q_WARPS * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(row1), M, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(
      fc1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F1_SMEM);
  if (err != cudaSuccess) return (int)err;
  fc1_kernel<<<dim3(CL, (M + F1_ROWS - 1) / F1_ROWS), THREADS, F1_SMEM, st>>>(
      m_xq, m_w1, static_cast<const float*>(row1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<int8_t*>(hq), static_cast<float*>(row2), M, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 256-column tiles read 1.5x fewer bytes per product than 128-column
  // ones, where there are enough of them to fill two waves of SMs
  const bool wide = K % 256 == 0 &&
                    (K / 256) * ((M + F2_ROWS - 1) / F2_ROWS) >= 2 * sm_count();
  return wide ? launch_fc2<256, T>(m_hq, m_w2, row2, s2, b2, out, M, K, st)
              : launch_fc2<128, T>(m_hq, m_w2, row2, s2, b2, out, M, K, st);
}

}  // namespace

extern "C" {

// x (M, K) bf16 -> out (M, K) bf16; xq (M, K) int8, row1 (M,) fp32, hq
// (M, N) int8 and row2 (M,) fp32 are the caller's scratch
int int8_mlp_bf16(const void* x, const void* w1, const void* s1,
                  const void* b1, const void* w2, const void* s2,
                  const void* b2, void* out, void* xq, void* row1, void* hq,
                  void* row2, int M, int K, int N, void* stream) {
  return launch<__nv_bfloat16>(x, w1, s1, b1, w2, s2, b2, out, xq, row1, hq,
                               row2, M, K, N,
                               static_cast<cudaStream_t>(stream));
}

// the same with x and out fp32
int int8_mlp_fp32(const void* x, const void* w1, const void* s1,
                  const void* b1, const void* w2, const void* s2,
                  const void* b2, void* out, void* xq, void* row1, void* hq,
                  void* row2, int M, int K, int N, void* stream) {
  return launch<float>(x, w1, s1, b1, w2, s2, b2, out, xq, row1, hq, row2, M,
                       K, N, static_cast<cudaStream_t>(stream));
}

const char* int8_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
