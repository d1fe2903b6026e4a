// Width-generic fused decoder tail, the scalar route: forward (K3g) and
// backward (K4g) at decoder widths C <= 8, in bf16 and fp32 (C >= 9 runs on
// the tensor cores, decoder_tail_tc_fwd.cu / decoder_tail_tc_bwd.cu, where
// the tensor-core kernels took 1.3-1.6x this route's device time at
// tiny_test's (2, 64, 32, 8) in bf16).
//
// Replaces the TPU kernels painter_tpu/kernels/decoder_head.py:_fwd_impl
// (K3g) and _bwd_impl (K4g) at the widths the kernels of
// decoder_tail_fwd.cu / decoder_tail_bwd.cu are not built for (they take
// C = 64, the presets' ViT-L width); the wrapper (kernels/decoder_head.py
// decoder_route, generic_tail_route) sends a width here by its shape and
// type alone.
//
// Contracts: those of decoder_tail_fwd.cu and decoder_tail_bwd.cu at a
// channel count CP = 8 (a template parameter), of which the first C are
// real: the wrapper zero-pads the pixels, the conv weights and the row
// vectors to CP channels. LayerNorm runs over the real C (mean and
// variance over c < C); the padded channels of u, n, g, dn and du are held
// at zero, so they add nothing to any output or gradient, and the wrapper
// slices them off dpix and dW1.
//
// What bounds it on an H100: operations (2 N C (9 C + 3) FLOP forward, ~3x
// that backward, for N = B*H*W pixels, against N (C + 3) values of IO), in
// scalar fp32 FMAs here (67 TFLOP/s): at C <= 8 each pixel's few products
// leave the tensor cores' 64-wide tiles mostly empty; tiny_test (C = 8) is
// the one preset on it.
//
// Design: one CTA of 128 threads per 8 x 16 output tile, one
// thread per output pixel; the tile's pixels with a one-pixel halo (zero
// outside the image: the SAME padding) sit in shared memory as fp32, and
// the weights are read through L1 (every lane of a warp reads the same
// weight: a broadcast), 8 output channels per pass in registers.
//   K3g (one launch): conv3x3 + b1 into the thread's shared row, LayerNorm,
//        GELU (rounded to the input type), the 3 output dots, the store.
//   K4g (two launches): (a) recomputes the forward per pixel, forms du
//        (rounded to the input type into a (B, H, W, CP) scratch) and the
//        CTA's partial sums of db1, dLN scale, dLN bias, dW2 and db2 (each
//        channel summed over the tile's pixels in pixel order, staged
//        through shared memory); (b) per tile, dpix from du's halo and the
//        transposed taps (W1 packed (tap, o, c)) and the CTA's dW1 partial
//        (each (tap, c, o) summed over the tile's pixels in pixel order).
//        The wrapper sums the per-CTA partials with one torch.sum, as the
//        JAX package sums its per-block partials. No atomics: two runs give
//        the same bits.
//
// The launchers allocate nothing and do not synchronize; they return
// cudaGetLastError() so the caller can raise on a refused launch.

#include "decoder_tail_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TH = 8, TW = 16;           // output pixels per CTA
constexpr int THREADS = TH * TW;         // one per output pixel
constexpr int PH = TH + 2, PW = TW + 2;  // with the one-pixel halo
constexpr float LN_EPS = 1e-6f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return to_f(from_f<T>(x));
}

// 8 consecutive weights (16-byte aligned) through L1
__device__ __forceinline__ void load8(float w[8], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void load8(float w[8], const bf16* p) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ float ldf(const T* p) {
  return to_f(__ldg(p));
}

// the tile's PH x PW pixels of one (H, W, CP) image from (y0, x0) into
// fp32 shared memory (CP + 1 per pixel); pixels outside the image are zero
template <typename T, int CP>
__device__ void load_halo(float* dst, const T* img, int H, int W, int y0,
                          int x0) {
  for (int i = threadIdx.x; i < PH * PW * CP; i += THREADS) {
    const int p = i / CP;
    const int c = i % CP;
    const int y = y0 + p / PW;
    const int x = x0 + p % PW;
    dst[p * (CP + 1) + c] =
        (y >= 0 && y < H && x >= 0 && x < W)
            ? to_f(img[((size_t)y * W + x) * CP + c]) : 0.f;
  }
}

// u[o] = b1[o] + sum_{tap, c} P[pixel + tap, c] W1[tap, c, o] for the
// thread's pixel (ty, tx) of the halo tile P, into its row u
template <typename T, int CP>
__device__ void conv3x3(float* u, const float* P, const T* w1, const T* b1,
                        int ty, int tx) {
  for (int o0 = 0; o0 < CP; o0 += 8) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const float* pp = P + ((ty + tap / 3) * PW + tx + tap % 3) * (CP + 1);
      const T* wt = w1 + (size_t)tap * CP * CP + o0;
#pragma unroll 4
      for (int c = 0; c < CP; ++c) {
        const float pv = pp[c];
        float w[8];
        load8(w, wt + (size_t)c * CP);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(pv, w[i], acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) u[o0 + i] = acc[i] + ldf(b1 + o0 + i);
  }
}

// LayerNorm statistics of the thread's row u over the real C channels
__device__ __forceinline__ void ln_stats(const float* u, int C, float& mean,
                                         float& rstd) {
  float s = 0.f;
  for (int c = 0; c < C; ++c) s += u[c];
  mean = s / C;
  float v = 0.f;
  for (int c = 0; c < C; ++c) {
    const float d = u[c] - mean;
    v += d * d;
  }
  rstd = rsqrtf(v / C + LN_EPS);
}

template <int CP>
size_t fwd_smem_bytes() {
  return ((size_t)PH * PW + THREADS) * (CP + 1) * sizeof(float);
}

// K3g
template <typename T, int CP>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ pix, const T* __restrict__ w1,
           const T* __restrict__ b1, const T* __restrict__ lns,
           const T* __restrict__ lnb, const T* __restrict__ w2,
           const T* __restrict__ b2, T* __restrict__ out, int H, int W,
           int C, int approx_i) {
  extern __shared__ __align__(16) float smem[];
  float* P = smem;                    // PH * PW halo pixels
  float* U = P + PH * PW * (CP + 1);  // one row of u per thread
  const bool approx = approx_i != 0;
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  load_halo<T, CP>(P, pix + (size_t)b * H * W * CP, H, W, y0 - 1, x0 - 1);
  __syncthreads();

  const int ty = tid / TW, tx = tid % TW;
  const int y = y0 + ty, x = x0 + tx;
  if (y >= H || x >= W) return;  // past the only barrier
  float* u = U + tid * (CP + 1);
  conv3x3<T, CP>(u, P, w1, b1, ty, tx);
  float mean, rstd;
  ln_stats(u, C, mean, rstd);
  float o[3] = {0.f, 0.f, 0.f};
  for (int c = 0; c < C; ++c) {
    const float n = (u[c] - mean) * rstd * ldf(lns + c) + ldf(lnb + c);
    const float g = rounded<T>(dtail::gelu(n, approx));
#pragma unroll
    for (int k = 0; k < 3; ++k) o[k] = fmaf(g, ldf(w2 + c * 3 + k), o[k]);
  }
  T* dst = out + (((size_t)b * H + y) * W + x) * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) dst[k] = from_f<T>(o[k] + ldf(b2 + k));
}

template <int CP>
size_t du_smem_bytes() {
  return (((size_t)PH * PW + THREADS) * (CP + 1) + THREADS * 3) *
         sizeof(float);
}

template <int CP>
size_t dpix_smem_bytes() {
  return 2 * (size_t)PH * PW * (CP + 1) * sizeof(float);
}

// K4g (a): du and the small partial sums, one row of 6 CP + 3 per CTA:
// [db1 | dLN scale | dLN bias | dW2 (c, k) | db2]
template <typename T, int CP>
__global__ void __launch_bounds__(THREADS)
du_kernel(const T* __restrict__ pix, const T* __restrict__ go,
          const T* __restrict__ w1, const T* __restrict__ b1,
          const T* __restrict__ lns, const T* __restrict__ lnb,
          const T* __restrict__ w2, T* __restrict__ du,
          float* __restrict__ small_part, int H, int W, int C,
          int approx_i) {
  extern __shared__ __align__(16) float smem[];
  float* P = smem;                    // halo pixels, then the staging rows
  float* U = P + PH * PW * (CP + 1);  // one row of u per thread
  float* Go = U + THREADS * (CP + 1);  // (THREADS, 3) upstream gradients
  float* S = P;
  const bool approx = approx_i != 0;
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  load_halo<T, CP>(P, pix + (size_t)b * H * W * CP, H, W, y0 - 1, x0 - 1);
  __syncthreads();

  const int ty = tid / TW, tx = tid % TW;
  const int y = y0 + ty, x = x0 + tx;
  const bool in = y < H && x < W;
  const size_t pixel = ((size_t)b * H + y) * W + x;
  float* u = U + tid * (CP + 1);
  float g3[3] = {0.f, 0.f, 0.f};
  float mean = 0.f, rstd = 0.f, mx = 0.f, mxx = 0.f;
  if (in) {
    conv3x3<T, CP>(u, P, w1, b1, ty, tx);
    ln_stats(u, C, mean, rstd);
#pragma unroll
    for (int k = 0; k < 3; ++k) g3[k] = ldf(go + pixel * 3 + k);
    for (int c = 0; c < C; ++c) {
      const float xhat = (u[c] - mean) * rstd;
      const float n = xhat * ldf(lns + c) + ldf(lnb + c);
      const float dg = g3[0] * ldf(w2 + c * 3) + g3[1] * ldf(w2 + c * 3 + 1)
                       + g3[2] * ldf(w2 + c * 3 + 2);
      const float dxhat = dg * dtail::gelu_grad(n, approx) * ldf(lns + c);
      mx += dxhat;
      mxx += dxhat * xhat;
    }
    mx /= C;
    mxx /= C;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) Go[tid * 3 + k] = g3[k];
  __syncthreads();  // the halo is read: S takes its place

  float* part = small_part +
      (size_t)((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
               blockIdx.x) * (6 * CP + 3);
  float* srow = S + tid * (CP + 1);
  // q = 0 du, 1 dn * xhat, 2 dn, 3 g rounded (for dW2)
  for (int q = 0; q < 4; ++q) {
    for (int c = 0; c < CP; ++c) {
      float val = 0.f;
      if (in && c < C) {
        const float xhat = (u[c] - mean) * rstd;
        const float n = xhat * ldf(lns + c) + ldf(lnb + c);
        if (q == 3) {
          val = rounded<T>(dtail::gelu(n, approx));
        } else {
          const float dg = g3[0] * ldf(w2 + c * 3)
                           + g3[1] * ldf(w2 + c * 3 + 1)
                           + g3[2] * ldf(w2 + c * 3 + 2);
          const float dn = dg * dtail::gelu_grad(n, approx);
          val = q == 0 ? rstd * (dn * ldf(lns + c) - mx - xhat * mxx)
                       : q == 1 ? dn * xhat : dn;
        }
      }
      srow[c] = val;
      if (q == 0 && in) du[pixel * CP + c] = from_f<T>(val);
    }
    __syncthreads();
    if (q < 3) {
      for (int c = tid; c < CP; c += THREADS) {
        float s = 0.f;
        for (int p = 0; p < THREADS; ++p) s += S[p * (CP + 1) + c];
        part[q * CP + c] = s;
      }
    } else {
      for (int i = tid; i < 3 * CP; i += THREADS) {
        const int c = i / 3, k = i % 3;
        float s = 0.f;
        for (int p = 0; p < THREADS; ++p)
          s = fmaf(S[p * (CP + 1) + c], Go[p * 3 + k], s);
        part[3 * CP + i] = s;
      }
      if (tid < 3) {
        float s = 0.f;
        for (int p = 0; p < THREADS; ++p) s += Go[p * 3 + tid];
        part[6 * CP + tid] = s;
      }
    }
    __syncthreads();
  }
}

// K4g (b): dpix of the tile and the CTA's dW1 partial, (tap, c, o)
template <typename T, int CP>
__global__ void __launch_bounds__(THREADS)
dpix_kernel(const T* __restrict__ pix, const T* __restrict__ du,
            const T* __restrict__ w1t, T* __restrict__ dpix,
            float* __restrict__ dw1_part, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* P = smem;                      // halo pixels
  float* DU = P + PH * PW * (CP + 1);   // halo du (zero outside the image)
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const size_t img = (size_t)b * H * W * CP;
  load_halo<T, CP>(P, pix + img, H, W, y0 - 1, x0 - 1);
  load_halo<T, CP>(DU, du + img, H, W, y0 - 1, x0 - 1);
  __syncthreads();

  const int ty = tid / TW, tx = tid % TW;
  const int y = y0 + ty, x = x0 + tx;
  if (y < H && x < W) {
    // dpix[c] = sum_{dy, dx, o} du[y + 1 - dy, x + 1 - dx, o] W1[dy, dx, c, o]
    T* dst = dpix + (((size_t)b * H + y) * W + x) * CP;
    for (int c0 = 0; c0 < CP; c0 += 8) {
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      for (int tap = 0; tap < 9; ++tap) {
        const float* dd =
            DU + ((ty + 2 - tap / 3) * PW + tx + 2 - tap % 3) * (CP + 1);
        const T* wt = w1t + (size_t)tap * CP * CP + c0;
#pragma unroll 4
        for (int o = 0; o < CP; ++o) {
          const float dv = dd[o];
          float w[8];
          load8(w, wt + (size_t)o * CP);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = fmaf(dv, w[i], acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[c0 + i] = from_f<T>(acc[i]);
    }
  }

  // dW1[tap, c, o] = sum over the tile's pixels of pix[pixel + tap, c]
  // du[pixel, o] (pixels outside the image hold du = 0)
  float* part = dw1_part +
      (size_t)((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
               blockIdx.x) * 9 * CP * CP;
  for (int i = tid; i < 9 * CP * CP; i += THREADS) {
    const int tap = i / (CP * CP);
    const int c = (i / CP) % CP;
    const int o = i % CP;
    const int dy = tap / 3, dx = tap % 3;
    float s = 0.f;
    for (int p = 0; p < THREADS; ++p) {
      const int py = p / TW, px = p % TW;
      s = fmaf(P[((py + dy) * PW + px + dx) * (CP + 1) + c],
               DU[((py + 1) * PW + px + 1) * (CP + 1) + o], s);
    }
    part[i] = s;
  }
}


dim3 grid_of(int B, int H, int W) {
  return dim3((W + TW - 1) / TW, (H + TH - 1) / TH, B);
}

template <typename T, int CP>
int launch_fwd(const void* pix, const void* w1, const void* b1,
               const void* lns, const void* lnb, const void* w2,
               const void* b2, void* out, int B, int H, int W, int C,
               int approx, cudaStream_t st) {
  const size_t smem = fwd_smem_bytes<CP>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<T, CP><<<grid_of(B, H, W), THREADS, smem, st>>>(
      static_cast<const T*>(pix), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(lns),
      static_cast<const T*>(lnb), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), H, W, C, approx);
  return (int)cudaGetLastError();
}

template <typename T, int CP>
int launch_bwd(const void* pix, const void* go, const void* w1,
               const void* w1t, const void* b1, const void* lns,
               const void* lnb, const void* w2, void* du, void* dpix,
               void* dw1_part, void* small_part, int B, int H, int W, int C,
               int approx, cudaStream_t st) {
  const dim3 grid = grid_of(B, H, W);
  size_t smem = du_smem_bytes<CP>();
  cudaError_t err = cudaFuncSetAttribute(
      du_kernel<T, CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  du_kernel<T, CP><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(pix), static_cast<const T*>(go),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(lns), static_cast<const T*>(lnb),
      static_cast<const T*>(w2), static_cast<T*>(du),
      static_cast<float*>(small_part), H, W, C, approx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  smem = dpix_smem_bytes<CP>();
  err = cudaFuncSetAttribute(dpix_kernel<T, CP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dpix_kernel<T, CP><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(pix), static_cast<const T*>(du),
      static_cast<const T*>(w1t), static_cast<T*>(dpix),
      static_cast<float*>(dw1_part), H, W);
  return (int)cudaGetLastError();
}


}  // namespace

extern "C" {

// cp: the built width (8) the inputs are padded to; C the real width
// (C <= cp). Weights as the ViT-L kernels take them, at cp: W1 (tap, c,
// o), b1, LN scale, LN bias (cp,), W2 (cp, 3), b2 (3,). C >= 9 runs on the
// tensor cores: other cp are refused.
int decoder_tail_generic_fwd_bf16(const void* pix, const void* w1,
                                  const void* b1, const void* lns,
                                  const void* lnb, const void* w2,
                                  const void* b2, void* out, int B, int H,
                                  int W, int cp, int C, int approx,
                                  void* stream) {
  if (cp != 8) return (int)cudaErrorInvalidValue;
  return launch_fwd<bf16, 8>(pix, w1, b1, lns, lnb, w2, b2, out, B, H, W, C,
                             approx, static_cast<cudaStream_t>(stream));
}

int decoder_tail_generic_fwd_f32(const void* pix, const void* w1,
                                 const void* b1, const void* lns,
                                 const void* lnb, const void* w2,
                                 const void* b2, void* out, int B, int H,
                                 int W, int cp, int C, int approx,
                                 void* stream) {
  if (cp != 8) return (int)cudaErrorInvalidValue;
  return launch_fwd<float, 8>(pix, w1, b1, lns, lnb, w2, b2, out, B, H, W,
                              C, approx, static_cast<cudaStream_t>(stream));
}

// w1t: W1 packed (tap, o, c); du: (B, H, W, cp) scratch in the input type;
// dw1_part (ctas, 9 cp cp) and small_part (ctas, 6 cp + 3) fp32, one row
// per CTA of the (ceil(W / 16), ceil(H / 8), B) grid
int decoder_tail_generic_bwd_bf16(const void* pix, const void* go,
                                  const void* w1, const void* w1t,
                                  const void* b1, const void* lns,
                                  const void* lnb, const void* w2, void* du,
                                  void* dpix, void* dw1_part,
                                  void* small_part, int B, int H, int W,
                                  int cp, int C, int approx, void* stream) {
  if (cp != 8) return (int)cudaErrorInvalidValue;
  return launch_bwd<bf16, 8>(pix, go, w1, w1t, b1, lns, lnb, w2, du, dpix,
                             dw1_part, small_part, B, H, W, C, approx,
                             static_cast<cudaStream_t>(stream));
}

int decoder_tail_generic_bwd_f32(const void* pix, const void* go,
                                 const void* w1, const void* w1t,
                                 const void* b1, const void* lns,
                                 const void* lnb, const void* w2, void* du,
                                 void* dpix, void* dw1_part,
                                 void* small_part, int B, int H, int W,
                                 int cp, int C, int approx, void* stream) {
  if (cp != 8) return (int)cudaErrorInvalidValue;
  return launch_bwd<float, 8>(pix, go, w1, w1t, b1, lns, lnb, w2, du, dpix,
                              dw1_part, small_part, B, H, W, C, approx,
                              static_cast<cudaStream_t>(stream));
}

// The number of CTAs (rows of dw1_part and small_part) at (B, H, W)
int decoder_tail_generic_tiles(int B, int H, int W) {
  const dim3 grid = grid_of(B, H, W);
  return (int)(grid.x * grid.y * grid.z);
}

const char* decoder_tail_generic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
