// Fused decoder tail, forward (Hopper): conv3x3 + bias -> LayerNorm ->
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
// What this simple design does about it: one CTA of 8 warps per 16 x 16
// output tile; the tile's 18 x 18 pixels (one-pixel halo) and the 9 x 64 x
// 64 conv weights sit in shared memory; each warp takes one output row of
// 16 pixels at a time and runs the conv as 9 shifted (16 x 64) . (64 x 64)
// products on the tensor cores (WMMA bf16, fp32 accumulate), then the
// per-pixel LayerNorm, GELU and 64 -> 3 dot with one lane per two
// channels. What it does not do yet: the conv output takes a round trip
// through shared memory before the epilogue, the loads are synchronous,
// the products are WMMA (not wgmma), and every CTA loads the weights
// again. The fp32 instantiation runs scalar FMAs and reads the weights
// from global memory: it exists for tight fp32 comparisons, not speed.
//
// The launcher allocates nothing and does not synchronize; it returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include "decoder_tail_common.cuh"

namespace {

using namespace dtail;

constexpr int TH = 16, TW = 16;          // output pixels per CTA
constexpr int PH = TH + 2, PW = TW + 2;  // with the one-pixel halo
constexpr int PRM = 3 * C + 3 * C + 3;   // b1, ln scale, ln bias, W2, b2
constexpr int PRM_PAD = (PRM + 7) / 8 * 8;

template <typename T>
size_t smem_bytes() {
  size_t bytes = (size_t)PH * PW * Tile<T>::LD * sizeof(T)
      + (size_t)WARPS * 16 * LDE * sizeof(float)
      + (size_t)PRM_PAD * sizeof(float);
  if (Tile<T>::kSmemWeights)
    bytes += (size_t)9 * C * Tile<T>::LDW * sizeof(T);
  return bytes;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
decoder_tail_fwd_kernel(const T* __restrict__ pix, const T* __restrict__ w1,
                        const T* __restrict__ b1, const T* __restrict__ lns,
                        const T* __restrict__ lnb, const T* __restrict__ w2,
                        const T* __restrict__ b2, T* __restrict__ out, int H,
                        int W, int approx_i) {
  constexpr int LD = Tile<T>::LD;
  constexpr int LDW = Tile<T>::LDW;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ps = reinterpret_cast<T*>(smem);                     // PH*PW pixels
  float* Es = reinterpret_cast<float*>(Ps + PH * PW * LD);  // WARPS*16 rows
  float* Prm = Es + WARPS * 16 * LDE;
  T* Ws = reinterpret_cast<T*>(Prm + PRM_PAD);            // 9*C rows
  float* B1 = Prm;
  float* LNS = B1 + C;
  float* LNB = LNS + C;
  float* W2 = LNB + C;   // (C, 3)
  float* B2 = W2 + 3 * C;

  const bool approx = approx_i != 0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const T* img = pix + (size_t)b * H * W * C;

  load_pixels(Ps, img, H, W, y0 - 1, x0 - 1, PH, PW);
  for (int i = tid; i < C; i += THREADS) {
    B1[i] = to_f32(b1[i]);
    LNS[i] = to_f32(lns[i]);
    LNB[i] = to_f32(lnb[i]);
  }
  for (int i = tid; i < 3 * C; i += THREADS) W2[i] = to_f32(w2[i]);
  if (tid < 3) B2[tid] = to_f32(b2[tid]);
  if (Tile<T>::kSmemWeights) load_weights(Ws, w1);
  __syncthreads();

  const T* Wp = Tile<T>::kSmemWeights ? Ws : w1;
  float* Ew = Es + warp * 16 * LDE;
  const int c0 = 2 * lane;  // this lane's two channels in the epilogue

  for (int r = warp; r < TH; r += WARPS) {
    const int y = y0 + r;
    if (y >= H) break;
    Acc<T> acc[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) zero(acc[n]);
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const T* a = Ps + ((r + dy) * PW + dx) * LD;
      const T* wt = Wp + tap * C * LDW;
#pragma unroll
      for (int cb = 0; cb < 4; ++cb)
        mma16x64<wmma::row_major, wmma::row_major>(
            acc, a + cb * 16, LD, wt + cb * 16 * LDW, LDW, 16, lane);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) store(Ew + n * 16, LDE, acc[n], lane);
    __syncwarp();

    for (int j = 0; j < TW; ++j) {
      const int x = x0 + j;
      if (x >= W) break;
      const float u0 = Ew[j * LDE + c0] + B1[c0];
      const float u1 = Ew[j * LDE + c0 + 1] + B1[c0 + 1];
      const float mean = warp_sum(u0 + u1) / C;
      const float d0 = u0 - mean, d1 = u1 - mean;
      const float var = warp_sum(d0 * d0 + d1 * d1) / C;
      const float rstd = rsqrtf(var + LN_EPS);
      const float g0 = round_to<T>(gelu(d0 * rstd * LNS[c0] + LNB[c0],
                                        approx));
      const float g1 = round_to<T>(gelu(d1 * rstd * LNS[c0 + 1]
                                        + LNB[c0 + 1], approx));
      float o[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        o[k] = warp_sum(g0 * W2[c0 * 3 + k] + g1 * W2[(c0 + 1) * 3 + k]);
      if (lane < 3)
        out[((size_t)(b * H + y) * W + x) * 3 + lane] =
            from_f32<T>(o[lane] + B2[lane]);
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* pix, const void* w1, const void* b1, const void* lns,
           const void* lnb, const void* w2, const void* b2, void* out, int B,
           int H, int W, int approx, void* stream) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      decoder_tail_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  decoder_tail_fwd_kernel<T><<<grid, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pix), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(lns),
      static_cast<const T*>(lnb), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), H, W, approx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int decoder_tail_fwd_bf16(const void* pix, const void* w1, const void* b1,
                          const void* lns, const void* lnb, const void* w2,
                          const void* b2, void* out, int B, int H, int W,
                          int approx, void* stream) {
  return launch<__nv_bfloat16>(pix, w1, b1, lns, lnb, w2, b2, out, B, H, W,
                               approx, stream);
}

int decoder_tail_fwd_f32(const void* pix, const void* w1, const void* b1,
                         const void* lns, const void* lnb, const void* w2,
                         const void* b2, void* out, int B, int H, int W,
                         int approx, void* stream) {
  return launch<float>(pix, w1, b1, lns, lnb, w2, b2, out, B, H, W, approx,
                       stream);
}

const char* decoder_tail_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
