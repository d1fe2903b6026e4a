// Fused w8a8 transformer MLP (Hopper): per-row int8 quantization of x, the
// int8 fc1 product, dequantization + bias, tanh GELU, per-row
// requantization from the fp32 hidden row, the int8 fc2 product,
// dequantization + bias -- the (M, N) hidden activation never leaves the
// SM.
//
// Replaces the TPU kernel painter_tpu/kernels/int8_mlp.py:_int8_mlp_2d
// (kernel _kernel), reached through int8_mlp.
//
// Contract, per row i of x (M, K) bf16, with fc1 weights
// W1q int8 (N, K), fp32 scales s1 (N,) and bias b1 (N,), fc2 W2q int8
// (K, N), s2 (K,), b2 (K,) (the torch (out, in) layout):
//   a1   = max_k |x[i, k]|  (fp32);  xq = clip(rint(x * 127 / max(a1,
//          1e-20)), -127, 127);  r1 = a1 * (1/127)
//   h[j] = gelu_tanh(int32(xq . W1q[j]) * (r1 * s1[j]) + b1[j])   fp32
//   a2   = max_j |h[j]|;  hq = clip(rint(h * 127 / max(a2, 1e-20)), ...)
//   r2   = a2 * (1/127)
//   out[k] = int32(hq . W2q[k]) * (r2 * s2[k]) + b2[k], bf16
// rint rounds half to even, as jnp.round does. The int32 sums are exact;
// everything else is fp32, in the JAX kernel's order.
//
// What bounds it on an H100: operations. It does 2 * M * K * N * 2 int8
// operations -- 2.10e11 at M = 12544 (ViT-L b8 trunk, K = 1024, N =
// 4096), 0.106 ms at 1,979 TOP/s dense int8 -- and its IO is x and out in
// bf16 plus 8 MiB of weights, 59.8 MB (0.018 ms at 3.35 TB/s).
//
// What this simple design does about it: one CTA of 8 warps per 32 rows
// of x. The rows ride in the n = 8 side of the int8 tensor-core product
// (mma.sync m16n8k32 s8.s8.s32, four n-tiles): both products are computed
// transposed, hidden^T = W1q . xq^T and out^T = W2q . hq^T, with the weight
// rows as the 16-row A operand read straight from global memory
// (L2-resident, 8 MiB) and the quantized rows as B from shared memory.
// Requantization needs each hidden row's absmax over all 4096 columns,
// and a 32-row fp32 hidden tile (512 KiB) does not fit an SM, so fc1 runs
// twice: the first pass keeps only the row maxima, the second recomputes
// the same fp32 values and writes their int8 codes (32 x 4096 B) to
// shared memory, from which fc2 reads -- the hidden activation never
// leaves the SM, as the TPU kernel keeps it in VMEM. Each 16-byte load
// feeds two k32 steps: the k order inside a 64-wide chunk is permuted the
// same way for A and B, which leaves the exact int32 sum unchanged. What
// it does not do yet: every CTA streams 12 MiB of weights from L2 (fc1
// twice, then fc2) for its 32 rows (64 int8 operations per weight byte
// read, against the tensor cores' ~600 per byte of L2 bandwidth), so L2,
// not the tensor cores, sets its pace; the loads are not staged through
// shared memory or pipelined, and the products are mma.sync, not wgmma.
// (A first version took 8 rows per CTA with the fp32 hidden tile in
// shared memory, one fc1 pass but 8 MiB of weights per 8 rows: on an
// H100 1.6x slower at the b8 trunk's M = 12544, 1.2x faster at the b1
// trunk's 1568, where 32-row tiles leave most SMs idle.)
//
// The launcher allocates nothing and does not synchronize; it returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;              // rows of x per CTA
constexpr int NT = BM / 8;          // n8 tiles of the mma per weight tile
constexpr int PF = 8;               // 64-deep k chunks loaded per batch
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ int8_t quant(float v, float inv) {
  return (int8_t)fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.0f), 127.0f);
}

// every product and sum rounded on its own (no contraction into FMAs), in
// the order of the plain version, so that kernel and plain version agree
// to the bit where their tanhf does
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(0.7978845608028654f,
                                __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

__device__ __forceinline__ void mma_s8(int acc[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[j] (16 weight rows x the 8 x rows of n-tile j, int32) =
// W[m0 .. m0+16) . Q[8j .. 8j+8)^T over depth `depth`; W is (rows, depth)
// int8 in global memory, Q (BM, ldq) in shared memory. Thread (g, t) holds
// weight rows g / g+8 and x rows 8j + g; each 16-byte load at k0 + 16 t
// serves two m16n8k32 steps (bytes 0-7 then 8-15) -- the same permutation
// of k on both operands -- and one A load serves all NT n-tiles. The
// loads of PF chunks are issued before any of their products, so that a
// warp keeps 2 * PF 16-byte L2 loads in flight (depth % (64 PF) == 0).
__device__ __forceinline__ void tile_product(int acc[NT][4], const int8_t* w,
                                             int m0, int depth,
                                             const int8_t* q, int ldq,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int8_t* lo = w + (size_t)(m0 + g) * depth + 16 * t;
  const int8_t* hi = lo + (size_t)8 * depth;
  const int8_t* qb = q + g * ldq + 16 * t;
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  for (int k0 = 0; k0 < depth; k0 += 64 * PF) {
    uint4 a[PF], b[PF];
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      a[u] = __ldg(reinterpret_cast<const uint4*>(lo + k0 + 64 * u));
      b[u] = __ldg(reinterpret_cast<const uint4*>(hi + k0 + 64 * u));
    }
#pragma unroll
    for (int u = 0; u < PF; ++u)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            qb + 8 * j * ldq + k0 + 64 * u);
        mma_s8(acc[j], a[u].x, b[u].x, a[u].y, b[u].y, v.x, v.y);
        mma_s8(acc[j], a[u].z, b[u].z, a[u].w, b[u].w, v.z, v.w);
      }
  }
}

// accumulator element i of n-tile j sits at weight row m0 + g + 8 (i / 2)
// and x row 8 j + 2 t + i % 2 of the tile
__device__ __forceinline__ int acc_row(int m0, int g, int i) {
  return m0 + g + (i >> 1) * 8;
}
__device__ __forceinline__ int acc_col(int j, int t, int i) {
  return 8 * j + 2 * t + (i & 1);
}

// h = gelu(acc * (r1 * s1) + b1), every step rounded as the plain version
__device__ __forceinline__ float hidden(int acc, float r1, float s1,
                                        float b1) {
  return gelu_tanh(__fadd_rn(__fmul_rn((float)acc, __fmul_rn(r1, s1)), b1));
}

size_t smem_bytes(int K, int N) {
  return (size_t)BM * (K + 16)            // xq
         + (size_t)BM * (N + 16)          // hq
         + (size_t)(WARPS + 3) * BM * 4;  // absmax partials, scales
}

__global__ void __launch_bounds__(THREADS, 1)
int8_mlp_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w1,
                const float* __restrict__ s1, const float* __restrict__ b1,
                const int8_t* __restrict__ w2, const float* __restrict__ s2,
                const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int M,
                int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = K + 16, ldq = N + 16;
  int8_t* Xq = reinterpret_cast<int8_t*>(smem);
  int8_t* Hq = Xq + BM * ldx;
  float* Apart = reinterpret_cast<float*>(Hq + BM * ldq);  // (WARPS, BM)
  float* Row1 = Apart + WARPS * BM;
  float* Row2 = Row1 + BM;
  float* Inv2 = Row2 + BM;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM;

  // 1: warp w quantizes rows w, w + 8, ... of the tile
  for (int r = warp; r < BM; r += WARPS) {
    const int gr = row0 + r;
    const __nv_bfloat16* xr = x + (size_t)gr * K;
    float amax = 0.0f;
    if (gr < M)
      for (int k = lane; k < K; k += 32)
        amax = fmaxf(amax, fabsf(__bfloat162float(xr[k])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float inv = 127.0f / fmaxf(amax, 1e-20f);
    for (int k = lane; k < K; k += 32)
      Xq[r * ldx + k] = gr < M ? quant(__bfloat162float(xr[k]), inv) : (int8_t)0;
    if (lane == 0) Row1[r] = amax * (1.0f / 127.0f);
  }
  __syncthreads();

  // 2-4, first pass: fc1, dequantize, bias, GELU -- only each row's |h| max
  float am[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) am[j][0] = am[j][1] = 0.0f;
  for (int m0 = warp * 16; m0 < N; m0 += WARPS * 16) {
    int acc[NT][4];
    tile_product(acc, w1, m0, K, Xq, ldx, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = acc_row(m0, g, i);
        const float h = hidden(acc[j][i], Row1[acc_col(j, t, i)], s1[m],
                               b1[m]);
        am[j][i & 1] = fmaxf(am[j][i & 1], fabsf(h));
      }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        am[j][h] = fmaxf(am[j][h],
                         __shfl_xor_sync(0xffffffffu, am[j][h], off));
      if (g == 0) Apart[warp * BM + 8 * j + 2 * t + h] = am[j][h];
    }
  __syncthreads();
  if (tid < BM) {
    float amax = 0.0f;
    for (int w = 0; w < WARPS; ++w) amax = fmaxf(amax, Apart[w * BM + tid]);
    Inv2[tid] = 127.0f / fmaxf(amax, 1e-20f);
    Row2[tid] = amax * (1.0f / 127.0f);
  }
  __syncthreads();

  // 2-5, second pass: the same fp32 hidden values again, requantized with
  // their rows' scales into the int8 hidden tile
  for (int m0 = warp * 16; m0 < N; m0 += WARPS * 16) {
    int acc[NT][4];
    tile_product(acc, w1, m0, K, Xq, ldx, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = acc_row(m0, g, i);
        const int n = acc_col(j, t, i);
        Hq[n * ldq + m] = quant(hidden(acc[j][i], Row1[n], s1[m], b1[m]),
                                Inv2[n]);
      }
  }
  __syncthreads();

  // 6-7: fc2, dequantize, bias, straight to the output rows
  for (int m0 = warp * 16; m0 < K; m0 += WARPS * 16) {
    int acc[NT][4];
    tile_product(acc, w2, m0, N, Hq, ldq, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = acc_row(m0, g, i);
        const int n = acc_col(j, t, i);
        if (row0 + n < M)
          out[(size_t)(row0 + n) * K + m] = __float2bfloat16(__fadd_rn(
              __fmul_rn((float)acc[j][i], __fmul_rn(Row2[n], s2[m])), b2[m]));
      }
  }
}

int launch(const void* x, const void* w1, const void* s1, const void* b1,
           const void* w2, const void* s2, const void* b2, void* out, int M,
           int K, int N, void* stream) {
  const size_t smem = smem_bytes(K, N);
  cudaError_t err = cudaFuncSetAttribute(
      int8_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM);
  int8_mlp_kernel<<<grid, THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), M, K,
      N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int int8_mlp_bf16(const void* x, const void* w1, const void* s1,
                  const void* b1, const void* w2, const void* s2,
                  const void* b2, void* out, int M, int K, int N,
                  void* stream) {
  return launch(x, w1, s1, b1, w2, s2, b2, out, M, K, N, stream);
}

const char* int8_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
