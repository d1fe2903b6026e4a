// Shared pieces of the fused decoder-tail kernels (decoder_tail_fwd.cu,
// decoder_tail_bwd.cu, decoder_tail_generic.cu, and through
// decoder_tail_hopper.cuh and decoder_tail_tc.cuh the tensor-core tails):
// the presets' channel count, the LayerNorm epsilon, and GELU and its
// derivative in fp32 (erff, tanh) with the one choice of tanh each type
// takes.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace dtail {

constexpr int C = 64;             // channels (the presets' decoder width)
constexpr float LN_EPS = 1e-6f;

__device__ __forceinline__ float tanh_approx(float x) {
  float th;
  asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(x));
  return th;
}

// the tanh GELU's tanh: tanhf where the result stays fp32 (EXACT), else
// tanh.approx.f32 (about 2^-11 relative): its result is rounded to bf16
// next
template <bool EXACT>
__device__ __forceinline__ float tanh_of(float x) {
  return EXACT ? tanhf(x) : tanh_approx(x);
}

// gelu(x), exact (erf) or tanh (APPROX), as 0.5 x (1 + tanh(x (c + c a
// x^2))) and 0.5 x (1 + erf(x / sqrt 2))
constexpr float GELU_C = 0.7978845608028654f;     // sqrt(2 / pi)
constexpr float GELU_CA = 0.035677408136300125f;  // sqrt(2 / pi) 0.044715
constexpr float RSQRT2 = 0.7071067811865476f;

template <bool APPROX, bool EXACT>
__device__ __forceinline__ float gelu(float x) {
  const float h = 0.5f * x;
  if (APPROX)
    return fmaf(h, tanh_of<EXACT>(x * fmaf(GELU_CA, x * x, GELU_C)), h);
  return fmaf(h, erff(x * RSQRT2), h);
}

// gelu(x) and d gelu / dx (decoder_head._gelu_grad) from one tanh or erf
// evaluation: tanh, 0.5 (1 + t) + 0.5 x (1 - t^2) (c + 3 c a x^2); erf,
// cdf + x phi(x)
template <bool APPROX, bool EXACT>
__device__ __forceinline__ void gelu_and_grad(float x, float& g, float& dg) {
  if (APPROX) {
    const float x2 = x * x;
    const float th = tanh_of<EXACT>(x * fmaf(GELU_CA, x2, GELU_C));
    const float hp = fmaf(0.5f, th, 0.5f);
    g = x * hp;
    dg = fmaf(0.5f * x * fmaf(-th, th, 1.0f),
              fmaf(3.0f * GELU_CA, x2, GELU_C), hp);
    return;
  }
  const float cdf = fmaf(0.5f, erff(x * RSQRT2), 0.5f);
  g = x * cdf;
  dg = fmaf(x, expf(-0.5f * x * x) * 0.3989422804014327f, cdf);
}

}  // namespace dtail
