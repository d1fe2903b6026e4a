// Shared pieces of the fused decoder-tail kernels (decoder_tail_fwd.cu,
// decoder_tail_bwd.cu): the channel count and LayerNorm epsilon, GELU and
// its derivative, and the fp32 routes' scalar building blocks (shared-memory
// row strides, a warp's 16 x 64 tile product in FMAs, the pixel-tile loader).
// The bf16 routes run on decoder_tail_hopper.cuh.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace dtail {

constexpr int C = 64;             // channels (the presets' decoder width)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LD = C + 4;         // fp32 pixel rows in shared memory
constexpr int LDE = C + 4;        // fp32 epilogue rows: one warp's 16 x C
constexpr float LN_EPS = 1e-6f;

// butterfly sum: every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float gelu(float x, bool approx) {
  if (approx) {
    const float inner = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
    return 0.5f * x * (1.0f + tanhf(inner));
  }
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// d gelu / dx (decoder_head._gelu_grad)
__device__ __forceinline__ float gelu_grad(float x, bool approx) {
  if (approx) {
    const float c = 0.7978845608028654f;
    const float a = 0.044715f;
    const float th = tanhf(c * (x + a * (x * x * x)));
    return 0.5f * (1.0f + th)
        + 0.5f * x * (1.0f - th * th) * c * (1.0f + 3.0f * a * x * x);
  }
  const float phi = expf(-0.5f * x * x) * 0.3989422804014327f;
  const float cdf = 0.5f * (1.0f + erff(x * 0.7071067811865476f));
  return cdf + x * phi;
}

// One warp's 16 x 16 fp32 accumulator tile: lane owns row lane / 2,
// columns (lane % 2) * 8 + [0, 8)
struct Acc { float v[8]; };

__device__ __forceinline__ void zero(Acc& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a.v[j] = 0.0f;
}

__device__ __forceinline__ void store(float* dst, int ld, const Acc& a,
                                      int lane) {
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[r * ld + c0 + j] = a.v[j];
}

__device__ __forceinline__ void load(Acc& a, const float* src, int ld,
                                     int lane) {
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) a.v[j] = src[r * ld + c0 + j];
}

// acc[n] += A (16 x 16) . B_n (16 x 16) for n = 0..3, B_n = b + n * b_step.
// Element (m, k) of A is a[m * lda + k] (A_ROW) or a[k * lda + m], likewise
// element (k, n) of B is b[k * ldb + n] (B_ROW) or b[n * ldb + k].
template <bool A_ROW, bool B_ROW>
__device__ __forceinline__ void mma16x64(Acc acc[4], const float* a, int lda,
                                         const float* b, int ldb, int b_step,
                                         int lane) {
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll 4
  for (int k = 0; k < 16; ++k) {
    const float av = A_ROW ? a[r * lda + k] : a[k * lda + r];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float* bn = b + n * b_step;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float bv = B_ROW ? bn[k * ldb + c0 + j] : bn[(c0 + j) * ldb + k];
        acc[n].v[j] = fmaf(av, bv, acc[n].v[j]);
      }
    }
  }
}

// rows x cols pixels of one (H, W, C) image from (y0, x0) into dst (row
// stride LD per pixel); pixels outside the image are zero (SAME padding)
__device__ void load_pixels(float* dst, const float* img, int H, int W,
                            int y0, int x0, int rows, int cols) {
  constexpr int CH = C / 4;
  for (int i = threadIdx.x; i < rows * cols * CH; i += THREADS) {
    const int p = i / CH;
    const int v = (i % CH) * 4;
    const int y = y0 + p / cols;
    const int x = x0 + p % cols;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (y >= 0 && y < H && x >= 0 && x < W)
      val = *reinterpret_cast<const float4*>(img + ((size_t)y * W + x) * C + v);
    *reinterpret_cast<float4*>(dst + p * LD + v) = val;
  }
}

}  // namespace dtail
