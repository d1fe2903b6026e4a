// Fused decoder tail, forward (Hopper, bf16): conv3x3 + bias -> LayerNorm ->
// GELU -> conv1x1 + bias, one pass, only the 3 output channels written.
//
// Replaces the TPU kernel painter_tpu/kernels/decoder_head.py:_fwd_impl
// (kernel _make_fwd_kernel), reached through fused_decoder_tail.
//
// Contract, per image b and pixel (y, x) of pix (B, H, W, 64):
//   u[o]  = b1[o] + sum_{dy,dx,c} pix[y+dy-1, x+dx-1, c] * W1[dy,dx,c,o]
//           (SAME padding: zero pixels outside the image)
//   n     = LayerNorm(u) * ln_scale + ln_bias   (fp32 mean / biased
//           variance over the 64 channels, eps 1e-6)
//   g     = gelu(n) (exact or tanh), rounded to the input type
//   out[k]= b2[k] + sum_c g[c] * W2[c, k]        k = 0, 1, 2
// All weights and row vectors arrive in the input type (the JAX kernel
// casts them before the call); products accumulate in fp32; out is
// written in the input type. W1 is packed (tap = dy*3+dx, c_in, c_out).
//
// What bounds it on an H100: operations. It does 2 * N * 64 * (9*64 + 3)
// FLOP for N = B*H*W pixels -- 5.95e10 at the trainer's (2, 896, 448),
// 0.060 ms at 989 TFLOP/s bf16 -- and moves N * (64 + 3) values: 107.6 MB
// in bf16, 0.032 ms at 3.35 TB/s. The (B, H, W, 64) conv output never goes
// to device memory, which is what the TPU kernel is for.
//
// What this design does about it (bf16, sm_90a): the strip mainloop of
// decoder_tail_hopper.cuh, shared with the backward's du and dpix launches.
// One persistent CTA per SM walks strips of R = 16 output rows x 64 pixels
// of one image (R halved while SMs would stand idle). W1 (72 KiB) is loaded
// once per CTA by TMA and stays resident. One producer warp fills a 6-stage
// ring; a stage is one input row's three dx-shifted boxes of a 4-D (C, W,
// H, B) map whose zero fill is the SAME padding, loaded once per strip. Two
// consumer warpgroups take the even and odd rows, so one's epilogue runs
// while the other's products do: a row is 9 taps x 4 wgmma m64n64k16 (A the
// pixel box K-major, B the resident W1 MN-major, fp32 accumulate). The
// epilogue works on the accumulator fragments, with no round trip of u
// through shared memory: a pixel's 64 channels lie in the four threads of
// one quad, so the LayerNorm mean and variance and each of the three
// output dots are a thread's 16 channels and two shuffles. GELU is erff, or
// for the tanh flavour tanh.approx.f32 (about 2^-11 relative), since g is
// rounded to bf16 (2^-9) right after. A warp stages its 16 pixels' 48
// outputs (96 contiguous bytes of NHWC) in shared memory and writes them in
// six 16-byte stores, or in 2-byte stores where the unit is ragged or the
// row is not 16-byte aligned (a TMA store would need 16-byte row strides,
// which the 6 W-byte rows break at widths such as W = 29). No atomics and a
// static schedule: two runs give the same bits.
//
// The fp32 route at C = 64 runs the tensor-core kernels of
// decoder_tail_tc_fwd.cu in 3xTF32 (kernels/decoder_head.py
// fused_decoder_tail): this file is bf16 only.
//
// The launchers allocate nothing and do not synchronize; they return
// cudaGetLastError() so the caller can raise on a refused launch.

#include "decoder_tail_hopper.cuh"

// ---------------------------------------------------------------------------
// bf16: the forward epilogue on the strip mainloop
// ---------------------------------------------------------------------------

namespace hop {

// gelu (decoder_tail_common.cuh's expressions) with the tanh flavour on
// tanh.approx.f32: its result is rounded to bf16 next
__device__ __forceinline__ float gelu_bf16_route(float x, bool approx) {
  if (approx)
    return 0.5f * x * (1.0f + tanh_approx(0.7978845608028654f *
                                          (x + 0.044715f * (x * x * x))));
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

struct FwdParams {
  const bf16* b1;
  const bf16* lns;
  const bf16* lnb;
  const bf16* w2;
  const bf16* b2;
  int approx;
};

struct FwdEpi {
  static constexpr bool kRotated = false;
  // b1, lns, lnb, W2T (3, C), b2 (3 + 1 pad) in fp32, then each consumer
  // warp's staged outputs: 16 pixels x 3 bf16 (96 bytes)
  static constexpr int kPrmFloats = 6 * C + 4;
  static constexpr int kStage = 16 * 3;
  static constexpr int kPrmBytes = kPrmFloats * 4 + 8 * kStage * 2;
  typedef FwdParams Params;

  static __device__ __forceinline__ void load(const Params& p,
                                              unsigned char* prm, int tid) {
    float* B1 = reinterpret_cast<float*>(prm);
    float* LNS = B1 + C;
    float* LNB = LNS + C;
    float* W2T = LNB + C;
    float* B2 = W2T + 3 * C;
    for (int i = tid; i < C; i += AB_THREADS) {
      B1[i] = __bfloat162float(p.b1[i]);
      LNS[i] = __bfloat162float(p.lns[i]);
      LNB[i] = __bfloat162float(p.lnb[i]);
    }
    for (int i = tid; i < 3 * C; i += AB_THREADS)
      W2T[(i % 3) * C + i / 3] = __bfloat162float(p.w2[i]);
    if (tid < 3) B2[tid] = __bfloat162float(p.b2[tid]);
  }

  const float* B1;
  const float* LNS;
  const float* LNB;
  const float* W2T;  // (3, C): W2 transposed, channel pairs adjacent
  const float* B2;
  bf16* stage;       // this warp's 16 pixels x 3
  bool approx;
  int warp, lane, g, tq;

  __device__ __forceinline__ FwdEpi(const Params& p, unsigned char* prm)
      : B1(reinterpret_cast<const float*>(prm)), LNS(B1 + C), LNB(LNS + C),
        W2T(LNB + C), B2(W2T + 3 * C),
        stage(reinterpret_cast<bf16*>(prm + kPrmFloats * 4) +
              (threadIdx.x >> 5) * kStage),
        approx(p.approx != 0), warp((threadIdx.x & 127) >> 5),
        lane(threadIdx.x & 31), g(lane >> 2), tq(lane & 3) {}

  __device__ __forceinline__ void row(const float (&acc)[32], int b, int y,
                                      int x0, const Strips& sp,
                                      const bf16* __restrict__,
                                      bf16* __restrict__ out) {
    if (approx) row_as<true>(acc, b, y, x0, sp, out);
    else row_as<false>(acc, b, y, x0, sp, out);
  }

  // the row for one GELU flavour: a branch per element on the flavour
  // kept the compiler from interleaving the elements' epilogues
  template <bool APPROX>
  __device__ __forceinline__ void row_as(const float (&acc)[32], int b, int y,
                                         int x0, const Strips& sp,
                                         bf16* __restrict__ out) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // element i = 2 j + e is channel 8 j + 2 tq + e of pixel g + 8 h
      float v[16];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(B1 + 8 * j + 2 * tq);
        v[2 * j] = acc[4 * j + 2 * h] + bb.x;
        v[2 * j + 1] = acc[4 * j + 2 * h + 1] + bb.y;
        sum += v[2 * j] + v[2 * j + 1];
      }
      const float mean = quad_sum(sum) / C;
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        v[i] -= mean;
        sq += v[i] * v[i];
      }
      const float rstd = rsqrtf(quad_sum(sq) / C + dtail::LN_EPS);
      float o0 = 0.f, o1 = 0.f, o2 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * tq;
        const float2 sc = *reinterpret_cast<const float2*>(LNS + c);
        const float2 sh = *reinterpret_cast<const float2*>(LNB + c);
        const float2 wa = *reinterpret_cast<const float2*>(W2T + c);
        const float2 wb = *reinterpret_cast<const float2*>(W2T + C + c);
        const float2 wc = *reinterpret_cast<const float2*>(W2T + 2 * C + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float n = v[2 * j + e] * rstd * (e ? sc.y : sc.x)
              + (e ? sh.y : sh.x);
          const float gr =
              __bfloat162float(__float2bfloat16(gelu_bf16_route(n, APPROX)));
          o0 += gr * (e ? wa.y : wa.x);
          o1 += gr * (e ? wb.y : wb.x);
          o2 += gr * (e ? wc.y : wc.x);
        }
      }
      o0 = quad_sum(o0);
      o1 = quad_sum(o1);
      o2 = quad_sum(o2);
      if (tq < 3)
        stage[(g + 8 * h) * 3 + tq] =
            __float2bfloat16((tq == 0 ? o0 : tq == 1 ? o1 : o2) + B2[tq]);
    }
    __syncwarp();
    const int xw = x0 + warp * 16;
    const int n = sp.W - xw < 16 ? sp.W - xw : 16;
    if (y < sp.H && n > 0) {
      bf16* dst = out + (((size_t)b * sp.H + y) * sp.W + xw) * 3;
      if (n == 16 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        if (lane < 6)
          reinterpret_cast<uint4*>(dst)[lane] =
              reinterpret_cast<const uint4*>(stage)[lane];
      } else {
        for (int i = lane; i < 3 * n; i += 32) dst[i] = stage[i];
      }
    }
    __syncwarp();
  }

  __device__ __forceinline__ void finish() {}
};

int launch(const void* pix, const void* w1, const void* b1, const void* lns,
           const void* lnb, const void* w2, const void* b2, void* out, int B,
           int H, int W, int approx, cudaStream_t st) {
  const Strips sp = strips_of(B, H, W);
  CUtensorMap m_pix, m_w1;
  if (!map_pixels(&m_pix, pix, B, H, W) || !map_w1(&m_w1, w1))
    return (int)cudaErrorInvalidValue;
  const FwdParams p = {static_cast<const bf16*>(b1),
                       static_cast<const bf16*>(lns),
                       static_cast<const bf16*>(lnb),
                       static_cast<const bf16*>(w2),
                       static_cast<const bf16*>(b2), approx};
  return launch_strips<FwdEpi>(m_pix, m_w1, nullptr, static_cast<bf16*>(out),
                               p, sp, st);
}

}  // namespace hop

extern "C" {

int decoder_tail_fwd_bf16(const void* pix, const void* w1, const void* b1,
                          const void* lns, const void* lnb, const void* w2,
                          const void* b2, void* out, int B, int H, int W,
                          int approx, void* stream) {
  return hop::launch(pix, w1, b1, lns, lnb, w2, b2, out, B, H, W, approx,
                     static_cast<cudaStream_t>(stream));
}

const char* decoder_tail_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
