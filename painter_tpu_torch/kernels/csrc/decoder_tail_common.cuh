// Shared pieces of the fused decoder-tail kernels (decoder_tail_fwd.cu,
// decoder_tail_bwd.cu, decoder_tail_generic.cu): the presets' channel count,
// the LayerNorm epsilon, and GELU and its derivative in fp32 (erff, tanhf).
// The C = 64 bf16 kernels run on decoder_tail_hopper.cuh; the fp32 tail at
// C >= 9 on decoder_tail_tc.cuh, whose fp32 epilogues repeat these
// expressions.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace dtail {

constexpr int C = 64;             // channels (the presets' decoder width)
constexpr float LN_EPS = 1e-6f;

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

}  // namespace dtail
