// Width-generic fused decoder tail, the scalar route: forward (K3g) and
// backward (K4g) in fp32 at every decoder width C >= 1 but the presets' 64,
// and in bf16 at C <= 8 (bf16 at C >= 9 runs on the tensor cores,
// decoder_tail_tc_fwd.cu / decoder_tail_tc_bwd.cu).
//
// Replaces the TPU kernels painter_tpu/kernels/decoder_head.py:_fwd_impl
// (K3g) and _bwd_impl (K4g) at the widths the kernels of
// decoder_tail_fwd.cu / decoder_tail_bwd.cu are not built for (they take
// C = 64, the presets' ViT-L width); the wrapper (kernels/decoder_head.py
// decoder_route, generic_tail_route) sends a width here by its shape and
// type alone.
//
// Contracts: those of decoder_tail_fwd.cu and decoder_tail_bwd.cu at a
// channel count CP (fp32; bf16 at CP = 8), of which the first C are real:
// the wrapper zero-pads the pixels, the conv weights and the row vectors to
// CP channels. CP is 8, 16, 32, 64 or 128 (templates) for C <= 128, and C
// rounded up to a multiple of 8 past that (the wide route, CP a runtime
// value). LayerNorm runs over the real C (mean and variance over c < C);
// the padded channels of u, n, g, dn and du are held at zero, so they add
// nothing to any output or gradient, and the wrapper slices them off dpix
// and dW1.
//
// What bounds it on an H100: operations (2 N C (9 C + 3) FLOP forward, ~3x
// that backward, for N = B*H*W pixels, against N (C + 3) values of IO), in
// scalar fp32 FMAs here (67 TFLOP/s): the simple design, right first; no
// preset runs it at a size where its speed matters (tiny_test at C = 8),
// and speed is later work (ROADMAP).
//
// Design, C <= 128: one CTA of 128 threads per 8 x 16 output tile, one
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
// Design, C > 128 (the wide route): the halo of all CP channels (92 KiB
// of fp32 at CP = 128) and a row of u per thread no longer fit in shared
// memory, so the same tiles and threads stage the input channels in chunks
// of 32 (a 10 x 18 x 33 fp32 halo, 23 KiB) and accumulate the conv3x3 over
// the chunks in a global fp32 (B, H, W, CP) scratch u, each thread its own
// pixel's row (no other thread touches it: no race, a fixed order).
//   K3g (one launch): the chunked conv3x3 + b1 into u, then LayerNorm over
//        the real C, GELU and the 3 output dots from the thread's row of u.
//   K4g (three launches): (a) the chunked conv into u, du into its scratch
//        and the small partial sums as at C <= 128, staged 32 channels at a
//        time; (b) dpix, the chunked transposed conv of du, accumulated in
//        the u scratch (free by then); (c) dW1 by blocks of 32 x 32 (c, o)
//        per tap over a slice of the pixels each (32 pixels staged at a
//        time), one partial (slices, 9, CP, CP) row per slice: a per-tile
//        partial would be 9 CP^2 floats for every 128 pixels. The wrapper
//        sums the partials with torch.sum. No atomics.
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


// --- C > 128: input channels in chunks, u in a global fp32 scratch ---------

constexpr int CH = 32;        // input channels per staged chunk
constexpr int CHL = CH + 1;   // fp32 stride of a pixel in the chunk

// channels [c0, c0 + cn) of the PH x PW halo pixels of one (H, W, CP) image
// from (y0, x0) into fp32 shared memory; pixels outside the image are zero
template <typename T>
__device__ void load_halo_chunk(float* dst, const T* img, int H, int W,
                                int CP, int y0, int x0, int c0, int cn) {
  for (int i = threadIdx.x; i < PH * PW * cn; i += THREADS) {
    const int p = i / cn;
    const int c = i % cn;
    const int y = y0 + p / PW;
    const int x = x0 + p % PW;
    dst[p * CHL + c] =
        (y >= 0 && y < H && x >= 0 && x < W)
            ? to_f(img[((size_t)y * W + x) * CP + c0 + c]) : 0.f;
  }
}

// acc[i] += sum over the chunk's cn channels and the 9 taps of
// S[pixel + tap, c] Wt[tap, c0 + c, o0 + i] for the thread's pixel (ty, tx)
// of the chunk S; FLIP: the transposed conv's taps (dpix)
template <typename T, bool FLIP>
__device__ __forceinline__ void conv_chunk8(float acc[8], const float* S,
                                            const T* w, int CP, int c0,
                                            int cn, int o0, int ty, int tx) {
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = FLIP ? 2 - tap / 3 : tap / 3;
    const int dx = FLIP ? 2 - tap % 3 : tap % 3;
    const float* sp = S + ((ty + dy) * PW + tx + dx) * CHL;
    const T* wt = w + ((size_t)tap * CP + c0) * CP + o0;
#pragma unroll 4
    for (int c = 0; c < cn; ++c) {
      const float pv = sp[c];
      float wv[8];
      load8(wv, wt + (size_t)c * CP);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(pv, wv[i], acc[i]);
    }
  }
}

// The chunked conv3x3 of the image src (channels CP) with the packed taps
// w (tap, in, out) over the CTA's tile, every thread its pixel: the sums
// over the input chunks go through ``acc_row`` (the pixel's fp32 row of a
// (B, H, W, CP) scratch), in chunk order. After the last chunk the row holds
// the conv plus ``bias`` (if given), or, with ``out_row``, the conv is
// written there in the type T instead. Every thread takes every barrier.
template <typename T, bool FLIP>
__device__ void conv_pass(float* S, const T* src, const T* w, const T* bias,
                          float* acc_row, T* out_row, bool in, int H, int W,
                          int CP, int y0, int x0, int ty, int tx) {
  for (int c0 = 0; c0 < CP; c0 += CH) {
    const int cn = min(CH, CP - c0);
    const bool last = c0 + cn == CP;
    __syncthreads();  // the previous chunk is read
    load_halo_chunk<T>(S, src, H, W, CP, y0 - 1, x0 - 1, c0, cn);
    __syncthreads();
    if (!in) continue;
    for (int o0 = 0; o0 < CP; o0 += 8) {
      float acc[8];
      float4* row = reinterpret_cast<float4*>(acc_row + o0);
      if (c0 == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      } else {
        const float4 a = row[0], b = row[1];
        acc[0] = a.x; acc[1] = a.y; acc[2] = a.z; acc[3] = a.w;
        acc[4] = b.x; acc[5] = b.y; acc[6] = b.z; acc[7] = b.w;
      }
      conv_chunk8<T, FLIP>(acc, S, w, CP, c0, cn, o0, ty, tx);
      if (last && out_row != nullptr) {
#pragma unroll
        for (int i = 0; i < 8; ++i) out_row[o0 + i] = from_f<T>(acc[i]);
        continue;
      }
      if (last && bias != nullptr) {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += ldf(bias + o0 + i);
      }
      row[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      row[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
}

size_t wide_smem_bytes() {
  return ((size_t)PH * PW * CHL + THREADS * 3) * sizeof(float);
}

// K3g, C > 128
template <typename T>
__global__ void __launch_bounds__(THREADS)
wide_fwd_kernel(const T* __restrict__ pix, const T* __restrict__ w1,
                const T* __restrict__ b1, const T* __restrict__ lns,
                const T* __restrict__ lnb, const T* __restrict__ w2,
                const T* __restrict__ b2, T* __restrict__ out,
                float* __restrict__ u, int H, int W, int CP, int C,
                int approx_i) {
  extern __shared__ __align__(16) float smem[];
  const bool approx = approx_i != 0;
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int ty = tid / TW, tx = tid % TW;
  const int y = y0 + ty, x = x0 + tx;
  const bool in = y < H && x < W;
  const size_t pixel = ((size_t)b * H + y) * W + x;
  float* ur = in ? u + pixel * CP : nullptr;
  conv_pass<T, false>(smem, pix + (size_t)b * H * W * CP, w1, b1, ur,
                      nullptr, in, H, W, CP, y0, x0, ty, tx);
  if (!in) return;  // past the last barrier
  float mean, rstd;
  ln_stats(ur, C, mean, rstd);
  float o[3] = {0.f, 0.f, 0.f};
  for (int c = 0; c < C; ++c) {
    const float n = (ur[c] - mean) * rstd * ldf(lns + c) + ldf(lnb + c);
    const float g = rounded<T>(dtail::gelu(n, approx));
#pragma unroll
    for (int k = 0; k < 3; ++k) o[k] = fmaf(g, ldf(w2 + c * 3 + k), o[k]);
  }
  T* dst = out + pixel * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) dst[k] = from_f<T>(o[k] + ldf(b2 + k));
}

// K4g (a), C > 128: u, du and the small partial sums, one row of 6 CP + 3
// per CTA: [db1 | dLN scale | dLN bias | dW2 (c, k) | db2]
template <typename T>
__global__ void __launch_bounds__(THREADS)
wide_du_kernel(const T* __restrict__ pix, const T* __restrict__ go,
               const T* __restrict__ w1, const T* __restrict__ b1,
               const T* __restrict__ lns, const T* __restrict__ lnb,
               const T* __restrict__ w2, float* __restrict__ u,
               T* __restrict__ du, float* __restrict__ small_part, int H,
               int W, int CP, int C, int approx_i) {
  extern __shared__ __align__(16) float smem[];
  float* S = smem;                     // halo chunks, then staging rows
  float* Go = smem + PH * PW * CHL;    // (THREADS, 3) upstream gradients
  const bool approx = approx_i != 0;
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int ty = tid / TW, tx = tid % TW;
  const int y = y0 + ty, x = x0 + tx;
  const bool in = y < H && x < W;
  const size_t pixel = ((size_t)b * H + y) * W + x;
  float* ur = in ? u + pixel * CP : nullptr;
  conv_pass<T, false>(smem, pix + (size_t)b * H * W * CP, w1, b1, ur,
                      nullptr, in, H, W, CP, y0, x0, ty, tx);

  float g3[3] = {0.f, 0.f, 0.f};
  float mean = 0.f, rstd = 0.f, mx = 0.f, mxx = 0.f;
  if (in) {
    ln_stats(ur, C, mean, rstd);
#pragma unroll
    for (int k = 0; k < 3; ++k) g3[k] = ldf(go + pixel * 3 + k);
    for (int c = 0; c < C; ++c) {
      const float xhat = (ur[c] - mean) * rstd;
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
  __syncthreads();  // the last chunk is read: S takes its place

  float* part = small_part +
      (size_t)((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
               blockIdx.x) * (6 * CP + 3);
  float* srow = S + tid * CHL;
  // q = 0 du, 1 dn * xhat, 2 dn, 3 g rounded (for dW2), CH channels a pass
  for (int q = 0; q < 4; ++q) {
    for (int c0 = 0; c0 < CP; c0 += CH) {
      const int cn = min(CH, CP - c0);
      for (int j = 0; j < cn; ++j) {
        const int c = c0 + j;
        float val = 0.f;
        if (in && c < C) {
          const float xhat = (ur[c] - mean) * rstd;
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
        srow[j] = val;
        if (q == 0 && in) du[pixel * CP + c] = from_f<T>(val);
      }
      __syncthreads();
      if (q < 3) {
        for (int j = tid; j < cn; j += THREADS) {
          float s = 0.f;
          for (int p = 0; p < THREADS; ++p) s += S[p * CHL + j];
          part[q * CP + c0 + j] = s;
        }
      } else {
        for (int i = tid; i < 3 * cn; i += THREADS) {
          const int j = i / 3, k = i % 3;
          float s = 0.f;
          for (int p = 0; p < THREADS; ++p)
            s = fmaf(S[p * CHL + j], Go[p * 3 + k], s);
          part[3 * CP + 3 * c0 + i] = s;
        }
      }
      __syncthreads();
    }
  }
  if (tid < 3) {
    float s = 0.f;
    for (int p = 0; p < THREADS; ++p) s += Go[p * 3 + tid];
    part[6 * CP + tid] = s;
  }
}

// K4g (b), C > 128: dpix of the tile, the chunked transposed conv of du
// (W1 packed (tap, o, c)), summed over the chunks in the fp32 scratch acc
template <typename T>
__global__ void __launch_bounds__(THREADS)
wide_dpix_kernel(const T* __restrict__ du, const T* __restrict__ w1t,
                 float* __restrict__ acc, T* __restrict__ dpix, int H,
                 int W, int CP) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int ty = tid / TW, tx = tid % TW;
  const int y = y0 + ty, x = x0 + tx;
  const bool in = y < H && x < W;
  const size_t pixel = ((size_t)b * H + y) * W + x;
  conv_pass<T, true>(smem, du + (size_t)b * H * W * CP, w1t, nullptr,
                     in ? acc + pixel * CP : nullptr,
                     in ? dpix + pixel * CP : nullptr, in, H, W, CP, y0, x0,
                     ty, tx);
}

constexpr int DW_BLK = 32;       // c and o per CTA
constexpr int DW_PIX = 32;       // pixels staged per step
constexpr int DW_THREADS = 256;  // (c, 4 o) per thread
constexpr int DW_LD = DW_BLK + 4;

// K4g (c), C > 128: dW1[tap, c, o] partial over slice s of the pixels,
// sum over the slice's pixels (in order) of pix[pixel + tap, c] du[pixel,
// o]; grid (o blocks, c blocks, 9 * slices)
template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
wide_dw1_kernel(const T* __restrict__ pix, const T* __restrict__ du,
                float* __restrict__ dw1_part, int B, int H, int W, int CP,
                int slices) {
  __shared__ __align__(16) float Xs[DW_PIX][DW_BLK + 1];
  __shared__ __align__(16) float Ds[DW_PIX][DW_LD];
  const int tid = threadIdx.x;
  const int tap = blockIdx.z % 9, s = blockIdx.z / 9;
  const int dy = tap / 3, dx = tap % 3;
  const int c0 = blockIdx.y * DW_BLK, o0 = blockIdx.x * DW_BLK;
  const long long npix = (long long)B * H * W;
  const long long per = (npix + slices - 1) / slices;
  const long long p_begin = s * per;
  const long long p_end = min(npix, p_begin + per);
  const int ci = tid / 8, oj = (tid % 8) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long p0 = p_begin; p0 < p_end; p0 += DW_PIX) {
    for (int i = tid; i < DW_PIX * DW_BLK; i += DW_THREADS) {
      const int pp = i / DW_BLK, cc = i % DW_BLK;
      const long long p = p0 + pp;
      float xv = 0.f, dv = 0.f;
      if (p < p_end) {
        const int bi = (int)(p / ((long long)H * W));
        const int rem = (int)(p % ((long long)H * W));
        const int sy = rem / W + dy - 1, sx = rem % W + dx - 1;
        if (c0 + cc < CP && sy >= 0 && sy < H && sx >= 0 && sx < W)
          xv = to_f(pix[(((size_t)bi * H + sy) * W + sx) * CP + c0 + cc]);
        if (o0 + cc < CP) dv = to_f(du[(size_t)p * CP + o0 + cc]);
      }
      Xs[pp][cc] = xv;
      Ds[pp][cc] = dv;
    }
    __syncthreads();
#pragma unroll 8
    for (int pp = 0; pp < DW_PIX; ++pp) {
      const float xv = Xs[pp][ci];
      const float4 d = *reinterpret_cast<const float4*>(&Ds[pp][oj]);
      acc[0] = fmaf(xv, d.x, acc[0]);
      acc[1] = fmaf(xv, d.y, acc[1]);
      acc[2] = fmaf(xv, d.z, acc[2]);
      acc[3] = fmaf(xv, d.w, acc[3]);
    }
    __syncthreads();
  }
  if (c0 + ci >= CP) return;
  float* dst = dw1_part + (((size_t)s * 9 + tap) * CP + c0 + ci) * CP;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (o0 + oj + j < CP) dst[o0 + oj + j] = acc[j];
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


template <typename T>
int launch_wide_fwd(const void* pix, const void* w1, const void* b1,
                    const void* lns, const void* lnb, const void* w2,
                    const void* b2, void* out, void* u, int B, int H, int W,
                    int CP, int C, int approx, cudaStream_t st) {
  if (CP <= 128 || CP % 8 || C > CP || C < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = wide_smem_bytes();
  wide_fwd_kernel<T><<<grid_of(B, H, W), THREADS, smem, st>>>(
      static_cast<const T*>(pix), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(lns),
      static_cast<const T*>(lnb), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out),
      static_cast<float*>(u), H, W, CP, C, approx);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide_bwd(const void* pix, const void* go, const void* w1,
                    const void* w1t, const void* b1, const void* lns,
                    const void* lnb, const void* w2, void* u, void* du,
                    void* dpix, void* dw1_part, void* small_part, int B,
                    int H, int W, int CP, int C, int slices, int approx,
                    cudaStream_t st) {
  if (CP <= 128 || CP % 8 || C > CP || C < 1 || slices < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_of(B, H, W);
  const size_t smem = wide_smem_bytes();
  wide_du_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(pix), static_cast<const T*>(go),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(lns), static_cast<const T*>(lnb),
      static_cast<const T*>(w2), static_cast<float*>(u), static_cast<T*>(du),
      static_cast<float*>(small_part), H, W, CP, C, approx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wide_dpix_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(du), static_cast<const T*>(w1t),
      static_cast<float*>(u), static_cast<T*>(dpix), H, W, CP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (CP + DW_BLK - 1) / DW_BLK;
  wide_dw1_kernel<T><<<dim3(blocks, blocks, 9 * slices), DW_THREADS, 0,
                       st>>>(
      static_cast<const T*>(pix), static_cast<const T*>(du),
      static_cast<float*>(dw1_part), B, H, W, CP, slices);
  return (int)cudaGetLastError();
}

#define DTAIL_WIDTHS(X) X(8) X(16) X(32) X(64) X(128)

template <typename T>
int fwd_at(int cp, const void* pix, const void* w1, const void* b1,
           const void* lns, const void* lnb, const void* w2, const void* b2,
           void* out, int B, int H, int W, int C, int approx, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DTAIL_FWD(N)                                                     \
  if (cp == N)                                                           \
    return launch_fwd<T, N>(pix, w1, b1, lns, lnb, w2, b2, out, B, H, W, \
                            C, approx, st);
  DTAIL_WIDTHS(DTAIL_FWD)
#undef DTAIL_FWD
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_at(int cp, const void* pix, const void* go, const void* w1,
           const void* w1t, const void* b1, const void* lns, const void* lnb,
           const void* w2, void* du, void* dpix, void* dw1_part,
           void* small_part, int B, int H, int W, int C, int approx,
           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DTAIL_BWD(N)                                                        \
  if (cp == N)                                                              \
    return launch_bwd<T, N>(pix, go, w1, w1t, b1, lns, lnb, w2, du, dpix,   \
                            dw1_part, small_part, B, H, W, C, approx, st);
  DTAIL_WIDTHS(DTAIL_BWD)
#undef DTAIL_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// cp: the built width (8, 16, 32, 64 or 128) the inputs are padded to; C
// the real width (C <= cp). Weights as the ViT-L kernels take them, at
// cp: W1 (tap, c, o), b1, LN scale, LN bias (cp,), W2 (cp, 3), b2 (3,)
int decoder_tail_generic_fwd_bf16(const void* pix, const void* w1,
                                  const void* b1, const void* lns,
                                  const void* lnb, const void* w2,
                                  const void* b2, void* out, int B, int H,
                                  int W, int cp, int C, int approx,
                                  void* stream) {
  if (cp != 8) return (int)cudaErrorInvalidValue;  // C >= 9: the tc route
  return launch_fwd<bf16, 8>(pix, w1, b1, lns, lnb, w2, b2, out, B, H, W, C,
                             approx, static_cast<cudaStream_t>(stream));
}

int decoder_tail_generic_fwd_f32(const void* pix, const void* w1,
                                 const void* b1, const void* lns,
                                 const void* lnb, const void* w2,
                                 const void* b2, void* out, int B, int H,
                                 int W, int cp, int C, int approx,
                                 void* stream) {
  return fwd_at<float>(cp, pix, w1, b1, lns, lnb, w2, b2, out, B, H, W, C,
                       approx, stream);
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
  if (cp != 8) return (int)cudaErrorInvalidValue;  // C >= 9: the tc route
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
  return bwd_at<float>(cp, pix, go, w1, w1t, b1, lns, lnb, w2, du, dpix,
                       dw1_part, small_part, B, H, W, C, approx, stream);
}

// C > 128: cp, a multiple of 8 > 128, the width the inputs are padded to;
// u: a (B, H, W, cp) fp32 scratch
int decoder_tail_generic_wide_fwd_f32(const void* pix, const void* w1,
                                      const void* b1, const void* lns,
                                      const void* lnb, const void* w2,
                                      const void* b2, void* out, void* u,
                                      int B, int H, int W, int cp, int C,
                                      int approx, void* stream) {
  return launch_wide_fwd<float>(pix, w1, b1, lns, lnb, w2, b2, out, u, B, H,
                                W, cp, C, approx,
                                static_cast<cudaStream_t>(stream));
}

// u: (B, H, W, cp) fp32 scratch; du, dpix (B, H, W, cp) in the input type;
// small_part (ctas, 6 cp + 3) fp32, one row per CTA of the (ceil(W / 16),
// ceil(H / 8), B) grid; dw1_part (slices, 9 cp cp) fp32, one row per slice
// of the B H W pixels (ceil(B H W / slices) each, in order)
int decoder_tail_generic_wide_bwd_f32(
    const void* pix, const void* go, const void* w1, const void* w1t,
    const void* b1, const void* lns, const void* lnb, const void* w2,
    void* u, void* du, void* dpix, void* dw1_part, void* small_part, int B,
    int H, int W, int cp, int C, int slices, int approx, void* stream) {
  return launch_wide_bwd<float>(pix, go, w1, w1t, b1, lns, lnb, w2, u, du,
                                dpix, dw1_part, small_part, B, H, W, cp, C,
                                slices, approx,
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
