// Shared pieces of the fused decoder-tail kernels (decoder_tail_fwd.cu,
// decoder_tail_bwd.cu): the channel count, shared-memory row strides, a
// warp's 16 x 64 tile product on the tensor cores (bf16) or in scalar
// FMAs (fp32), the pixel-tile loader, GELU and its derivative.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace dtail {

using namespace nvcuda;

constexpr int C = 64;             // channels (the presets' decoder width)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDE = C + 4;        // fp32 epilogue rows: one warp's 16 x C
constexpr float LN_EPS = 1e-6f;

// Row strides in shared memory. bf16 pixel rows are 160 bytes, so a tile
// that starts at any pixel is 32-byte aligned, as WMMA loads need; the
// bf16 weights keep 144-byte rows (no two of 8 consecutive rows in one
// bank group). fp32 runs scalar FMAs and reads its weights from global
// memory (through L1), packed (LDW = C).
template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> {
  static constexpr int LD = C + 16;
  static constexpr int LDW = C + 8;
  static constexpr bool kSmemWeights = true;
};
template <> struct Tile<float> {
  static constexpr int LD = C + 4;
  static constexpr int LDW = C;
  static constexpr bool kSmemWeights = false;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T, back in fp32 (the casts of the JAX kernel)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// two adjacent channels of one pixel, stored as T
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

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

// One warp's 16 x 16 fp32 accumulator tile.
template <typename T> struct Acc;
template <> struct Acc<__nv_bfloat16> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f;
};
// fp32: lane owns row lane / 2, columns (lane % 2) * 8 + [0, 8)
template <> struct Acc<float> { float v[8]; };

__device__ __forceinline__ void zero(Acc<__nv_bfloat16>& a) {
  wmma::fill_fragment(a.f, 0.0f);
}
__device__ __forceinline__ void zero(Acc<float>& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a.v[j] = 0.0f;
}

__device__ __forceinline__ void store(float* dst, int ld,
                                      const Acc<__nv_bfloat16>& a, int) {
  wmma::store_matrix_sync(dst, a.f, ld, wmma::mem_row_major);
}
__device__ __forceinline__ void store(float* dst, int ld, const Acc<float>& a,
                                      int lane) {
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[r * ld + c0 + j] = a.v[j];
}

__device__ __forceinline__ void load(Acc<__nv_bfloat16>& a, const float* src,
                                     int ld, int) {
  wmma::load_matrix_sync(a.f, src, ld, wmma::mem_row_major);
}
__device__ __forceinline__ void load(Acc<float>& a, const float* src, int ld,
                                     int lane) {
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) a.v[j] = src[r * ld + c0 + j];
}

// acc[n] += A (16 x 16) . B_n (16 x 16) for n = 0..3, B_n = b + n * b_step.
// LA / LB are wmma::row_major or wmma::col_major: element (m, k) of A is
// a[m * lda + k] (row) or a[k * lda + m] (col), likewise for B (k, n).
template <typename LA, typename LB>
__device__ __forceinline__ void mma16x64(Acc<__nv_bfloat16> acc[4],
                                         const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb,
                                         int b_step, int) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> fa;
  wmma::load_matrix_sync(fa, a, lda);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> fb;
    wmma::load_matrix_sync(fb, b + n * b_step, ldb);
    wmma::mma_sync(acc[n].f, fa, fb, acc[n].f);
  }
}

template <typename LA, typename LB>
__device__ __forceinline__ void mma16x64(Acc<float> acc[4], const float* a,
                                         int lda, const float* b, int ldb,
                                         int b_step, int lane) {
  constexpr bool a_row = std::is_same<LA, wmma::row_major>::value;
  constexpr bool b_row = std::is_same<LB, wmma::row_major>::value;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll 4
  for (int k = 0; k < 16; ++k) {
    const float av = a_row ? a[r * lda + k] : a[k * lda + r];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float* bn = b + n * b_step;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float bv = b_row ? bn[k * ldb + c0 + j] : bn[(c0 + j) * ldb + k];
        acc[n].v[j] = fmaf(av, bv, acc[n].v[j]);
      }
    }
  }
}

// rows x cols pixels of one (H, W, C) image from (y0, x0) into dst (row
// stride LD per pixel); pixels outside the image are zero (SAME padding)
template <typename T>
__device__ void load_pixels(T* dst, const T* img, int H, int W, int y0,
                            int x0, int rows, int cols) {
  constexpr int LD = Tile<T>::LD;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = C / VEC;
  for (int i = threadIdx.x; i < rows * cols * CH; i += THREADS) {
    const int p = i / CH;
    const int v = (i % CH) * VEC;
    const int y = y0 + p / cols;
    const int x = x0 + p % cols;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (y >= 0 && y < H && x >= 0 && x < W)
      val = *reinterpret_cast<const uint4*>(img + ((size_t)y * W + x) * C + v);
    *reinterpret_cast<uint4*>(dst + p * LD + v) = val;
  }
}

// the packed (tap, c, o) conv weights into shared memory, rows of LDW
template <typename T>
__device__ void load_weights(T* dst, const T* w1) {
  constexpr int LDW = Tile<T>::LDW;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = C / VEC;
  for (int i = threadIdx.x; i < 9 * C * CH; i += THREADS) {
    const int row = i / CH;
    const int v = (i % CH) * VEC;
    *reinterpret_cast<uint4*>(dst + row * LDW + v) =
        *reinterpret_cast<const uint4*>(w1 + row * C + v);
  }
}

}  // namespace dtail
