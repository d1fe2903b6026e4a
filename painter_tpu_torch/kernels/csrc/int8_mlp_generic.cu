// Width-generic fused w8a8 transformer MLP (K5g): per-row int8
// quantization of x, the int8 fc1 product, dequantization + bias, tanh
// GELU, per-row requantization from the fp32 hidden row, the int8 fc2
// product, dequantization + bias -- at every shape and type the kernel of
// int8_mlp.cu (K5: bf16, N = 4096, K a multiple of 128) does not take.
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
// rint rounds half to even, as jnp.round does. The int32 sums are exact;
// every fp32 step is in the JAX kernel's order with no contraction into
// FMAs, so kernel and plain version agree to the bit where their tanhf
// does.
//
// What bounds it on an H100: operations, 2 * M * K * N * 2 int8 ops (2.1e11
// at SegGPT ViT-L's b8 trunk in fp32, M 12544, K 1024, N 4096: 0.106 ms at
// 1,979 TOP/s dense int8) against x and out, the weights, and here the fp32
// hidden scratch (M N 4 B written once and read twice: 0.6 GB at that
// shape, 0.18 ms at 3.35 TB/s). This design does not reach the tensor
// cores: the products are __dp4a (four int8 products and their sum into an
// int32 per instruction) on the SIMT pipes, a small fraction of the int8
// tensor-core rate. It is the simple, right kernel first; speed is later
// work (ROADMAP).
//
// Design: four launches on the stream, no atomics, so two runs give the
// same bits.
//   (a) quant_rows<T>: one warp per row of x; the row maximum by a butterfly
//       of shuffles, then xq (M, Kp) int8 with K zero-padded to Kp, a
//       multiple of 16 (16-byte aligned rows), and r1.
//   (b) gemm_kernel<GeluEpi>: fc1 as a tiled int8 GEMM, 128 x 128 outputs
//       per CTA of 256 threads (8 x 8 each in registers), the depth staged
//       32 bytes at a time (double-buffered shared memory, k-word-major so
//       a thread reads its four rows' words as one 16-byte load), products
//       by __dp4a; depth past K is zero (masked loads), so the ragged edge
//       adds nothing. The epilogue dequantizes, adds b1 and applies the
//       GELU, writing fp32 h (M, N) to a scratch the wrapper allocates.
//   (c) quant_rows<float> on h: hq (M, Np) and r2.
//   (d) gemm_kernel<OutEpi<T>>: fc2 the same way, dequantization + bias,
//       out (M, K) in x's type.
// Any M works (M = 1 included): rows and columns past the matrix are
// masked at the loads and the stores.
//
// The launchers allocate nothing and do not synchronize: the caller passes
// xq, r1, h, hq and r2 as scratch. They return cudaGetLastError() so the
// caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

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

template <typename T>
__global__ void __launch_bounds__(Q_WARPS * 32)
quant_rows(const T* __restrict__ x, int8_t* __restrict__ q,
           float* __restrict__ rs, int M, int K, int ldq) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * Q_WARPS + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  float amax = 0.0f;
  for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f(xr[k])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float inv = 127.0f / fmaxf(amax, 1e-20f);
  int8_t* qr = q + (size_t)row * ldq;
  for (int k = lane; k < ldq; k += 32)
    qr[k] = k < K ? quant(to_f(xr[k]), inv) : (int8_t)0;
  if (lane == 0) rs[row] = amax * (1.0f / 127.0f);
}

// --- (b), (d) the int8 products ---------------------------------------------

constexpr int BM = 128, BN = 128;    // outputs per CTA
constexpr int BKB = 32;              // depth bytes per stage
constexpr int BKW = BKB / 4;         // depth words (four int8 each)
constexpr int G_THREADS = 256;
constexpr int LDS = BM + 4;          // words per depth word in shared memory

// 16 bytes of row ``row`` from depth k0, zero past ``K`` (and for a row past
// the matrix, ``row == nullptr``); ``vec``: the row is 16-byte aligned
__device__ __forceinline__ uint4 load16(const int8_t* row, int k0, int K,
                                        bool vec) {
  if (row == nullptr || k0 >= K) return make_uint4(0u, 0u, 0u, 0u);
  if (vec && k0 + 16 <= K)
    return __ldg(reinterpret_cast<const uint4*>(row + k0));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (k0 + i < K)
      w[i >> 2] |= (uint32_t)(uint8_t)__ldg(row + k0 + i) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 depth bytes of one row as depth words lw..lw+3 of column lr
__device__ __forceinline__ void put4(int (*dst)[LDS], int lw, int lr,
                                     uint4 v) {
  dst[lw][lr] = (int)v.x;
  dst[lw + 1][lr] = (int)v.y;
  dst[lw + 2][lr] = (int)v.z;
  dst[lw + 3][lr] = (int)v.w;
}

// fc1's epilogue: fp32 h = gelu(dequant + b1)
struct GeluEpi {
  const float* r;
  const float* s;
  const float* b;
  float* out;
  __device__ __forceinline__ void operator()(size_t at, int acc, float r_m,
                                             float s_n, float b_n) const {
    out[at] = gelu_tanh(dequant(acc, r_m, s_n, b_n));
  }
};

// fc2's epilogue: out = dequant + b2, in the output type
template <typename T>
struct OutEpi {
  const float* r;
  const float* s;
  const float* b;
  T* out;
  __device__ __forceinline__ void operator()(size_t at, int acc, float r_m,
                                             float s_n, float b_n) const {
    out[at] = from_f<T>(dequant(acc, r_m, s_n, b_n));
  }
};

// C[m, n] = sum_k A[m, k] B[n, k] over k < K for A (M, >= K) int8 with row
// stride lda (a multiple of 16), B (N, K) int8 with row stride ldb, then
// epi at C's (m, n) (row stride N)
template <typename Epi>
__global__ void __launch_bounds__(G_THREADS)
gemm_kernel(const int8_t* __restrict__ A, int lda,
            const int8_t* __restrict__ B, int ldb, int M, int N, int K,
            int b_vec, Epi epi) {
  __shared__ __align__(16) int As[2][BKW][LDS];
  __shared__ __align__(16) int Bs[2][BKW][LDS];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // the loader: thread t brings 16 depth bytes (k-words lw..lw+3) of row t/2
  const int lr = tid >> 1, lw = (tid & 1) * 4;
  const int8_t* arow = m0 + lr < M ? A + (size_t)(m0 + lr) * lda : nullptr;
  const int8_t* brow = n0 + lr < N ? B + (size_t)(n0 + lr) * ldb : nullptr;
  const int nk = (K + BKB - 1) / BKB;

  uint4 ra = load16(arow, 4 * lw, K, true);
  uint4 rb = load16(brow, 4 * lw, K, b_vec != 0);
  put4(As[0], lw, lr, ra);
  put4(Bs[0], lw, lr, rb);
  __syncthreads();

  // thread (tx, ty) owns rows {4 ty + i, 64 + 4 ty + i} and columns
  // {4 tx + j, 64 + 4 tx + j}, i, j < 4
  const int tx = tid & 15, ty = tid >> 4;
  int acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk) {
      ra = load16(arow, (t + 1) * BKB + 4 * lw, K, true);
      rb = load16(brow, (t + 1) * BKB + 4 * lw, K, b_vec != 0);
    }
#pragma unroll
    for (int kw = 0; kw < BKW; ++kw) {
      const int4 a0 = *reinterpret_cast<const int4*>(&As[cur][kw][4 * ty]);
      const int4 a1 =
          *reinterpret_cast<const int4*>(&As[cur][kw][64 + 4 * ty]);
      const int4 b0 = *reinterpret_cast<const int4*>(&Bs[cur][kw][4 * tx]);
      const int4 b1 =
          *reinterpret_cast<const int4*>(&Bs[cur][kw][64 + 4 * tx]);
      const int a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const int b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (t + 1 < nk) {
      put4(As[cur ^ 1], lw, lr, ra);
      put4(Bs[cur ^ 1], lw, lr, rb);
    }
    __syncthreads();
  }

  float s_n[8], b_n[8];
  int n_of[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    n_of[j] = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
    s_n[j] = n_of[j] < N ? epi.s[n_of[j]] : 0.0f;
    b_n[j] = n_of[j] < N ? epi.b[n_of[j]] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= M) continue;
    const float r_m = epi.r[m];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (n_of[j] < N)
        epi((size_t)m * N + n_of[j], acc[i][j], r_m, s_n[j], b_n[j]);
  }
}

inline int round16(int v) { return (v + 15) / 16 * 16; }

dim3 gemm_grid(int rows, int cols) {
  return dim3((cols + BN - 1) / BN, (rows + BM - 1) / BM);
}

template <typename T>
int launch(const void* x, const void* w1, const void* s1, const void* b1,
           const void* w2, const void* s2, const void* b2, void* out,
           void* xq, void* row1, void* h, void* hq, void* row2, int M, int K,
           int N, int w1_vec, int w2_vec, cudaStream_t st) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const int kp = round16(K), np = round16(N);
  const dim3 q_grid((M + Q_WARPS - 1) / Q_WARPS);
  quant_rows<T><<<q_grid, Q_WARPS * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(row1), M, K, kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const GeluEpi fc1{static_cast<const float*>(row1),
                    static_cast<const float*>(s1),
                    static_cast<const float*>(b1), static_cast<float*>(h)};
  gemm_kernel<GeluEpi><<<gemm_grid(M, N), G_THREADS, 0, st>>>(
      static_cast<const int8_t*>(xq), kp, static_cast<const int8_t*>(w1), K,
      M, N, K, w1_vec, fc1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  quant_rows<float><<<q_grid, Q_WARPS * 32, 0, st>>>(
      static_cast<const float*>(h), static_cast<int8_t*>(hq),
      static_cast<float*>(row2), M, N, np);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const OutEpi<T> fc2{static_cast<const float*>(row2),
                      static_cast<const float*>(s2),
                      static_cast<const float*>(b2), static_cast<T*>(out)};
  gemm_kernel<OutEpi<T>><<<gemm_grid(M, K), G_THREADS, 0, st>>>(
      static_cast<const int8_t*>(hq), np, static_cast<const int8_t*>(w2), N,
      M, K, N, w2_vec, fc2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K) -> out (M, K) in x's type. Scratch of the caller: xq (M, Kp)
// int8, row1 (M,) fp32, h (M, N) fp32, hq (M, Np) int8, row2 (M,) fp32,
// with Kp and Np K and N rounded up to multiples of 16. w1_vec / w2_vec:
// the weight's rows are 16-byte aligned (K resp. N a multiple of 16 and
// the pointer aligned), so the loads may take 16 bytes at once.
int int8_mlp_generic_bf16(const void* x, const void* w1, const void* s1,
                          const void* b1, const void* w2, const void* s2,
                          const void* b2, void* out, void* xq, void* row1,
                          void* h, void* hq, void* row2, int M, int K, int N,
                          int w1_vec, int w2_vec, void* stream) {
  return launch<bf16>(x, w1, s1, b1, w2, s2, b2, out, xq, row1, h, hq, row2,
                      M, K, N, w1_vec, w2_vec,
                      static_cast<cudaStream_t>(stream));
}

int int8_mlp_generic_f32(const void* x, const void* w1, const void* s1,
                         const void* b1, const void* w2, const void* s2,
                         const void* b2, void* out, void* xq, void* row1,
                         void* h, void* hq, void* row2, int M, int K, int N,
                         int w1_vec, int w2_vec, void* stream) {
  return launch<float>(x, w1, s1, b1, w2, s2, b2, out, xq, row1, h, hq,
                       row2, M, K, N, w1_vec, w2_vec,
                       static_cast<cudaStream_t>(stream));
}

const char* int8_mlp_generic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
