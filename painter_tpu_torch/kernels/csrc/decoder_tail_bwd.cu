// Fused decoder tail, backward (Hopper): recomputes the forward chain of
// decoder_tail_fwd.cu over a halo and emits the complete input gradient
// of its own pixels plus fp32 partials of the six parameter gradients.
//
// Replaces the TPU kernel painter_tpu/kernels/decoder_head.py:_bwd_impl
// (kernel _make_bwd_kernel, VJP _tail_bwd).
//
// Contract, with the forward's u, xhat, rstd, n (decoder_tail_fwd.cu) and
// go = the upstream gradient (B, H, W, 3) in the input type:
//   dg[c]  = sum_k go[k] * W2[c, k];   dn = dg * gelu'(n)
//   dxhat  = dn * ln_scale
//   du     = rstd * (dxhat - mean_c(dxhat) - xhat * mean_c(dxhat * xhat))
//   dpix[y, x, c] = sum_{dy,dx,o} du[y-dy+1, x-dx+1, o] * W1[dy,dx,c,o]
//   dW1[dy,dx,c,o] = sum_p pix[p + (dy-1, dx-1), c] * du[p, o]
//   db1 = sum_p du;  dln_scale = sum_p dn * xhat;  dln_bias = sum_p dn
//   dW2[c, k] = sum_p g[c] * go[k] (g rounded to the input type); db2 = sum go
// du is rounded to the input type before the two convolutions; db1, the
// LN sums and db2 are fp32. dpix is written whole; each CTA writes its
// fp32 partials of dW1 (9*64*64) and, per warp, of the six small ones,
// which the wrapper sums with torch.sum (the JAX package sums its
// per-block partials in XLA the same way).
//
// Tiling: a tile is 14 x 14 output pixels. Its du spans 16 x 16 (one-pixel
// halo, zero outside the image) and its pixels 18 x 18 (two-pixel halo).
// Only a tile's own 14 x 14 pixels add to the parameter sums; the halo
// belongs to the neighbours. A CTA walks TPC tiles down the image and
// keeps summing into the same partials, so there are B * ceil(W/14) *
// ceil(ceil(H/14)/TPC) partial sets (1024 of 147 KiB at (2, 896, 448)),
// not one per tile.
//
// What bounds it on an H100: operations. Three 3x3 convolutions' worth of
// products (the forward recompute, dpix and dW1), 2 * N * 64 * (27*64 +
// 6) FLOP with the 64 -> 3 pieces: 1.79e11 at (2, 896, 448), 0.181 ms at
// 989 TFLOP/s bf16. Its IO is pix, go and dpix, 210.4 MB in bf16 (0.063
// ms at 3.35 TB/s), plus the fp32 dW1 partials, 151 MB written and read
// once more by the sum.
//
// What this simple design does about it: all three products run on the
// tensor cores (WMMA bf16, fp32 accumulate) from shared memory: the conv
// weights are read once per CTA and serve both the recompute (as W1) and
// dpix (as W1 transposed, a column-major view of the same buffer); dW1
// takes the pixels as a column-major view. The LayerNorm backward is one
// lane per two channels with warp sums. What it does not do yet: the
// products' outputs go through shared memory, loads are synchronous, 2 of
// every 16 dpix columns computed are thrown away, and the products are
// WMMA, not wgmma. The fp32 instantiation runs scalar FMAs with its
// weights in global memory: it exists for tight fp32 comparisons.
//
// The launcher allocates nothing and does not synchronize; it returns
// cudaGetLastError() so the caller can raise on a refused launch.
// decoder_tail_bwd_partials gives the partial buffers' sizes, so the
// tiling is decided here alone.

#include "decoder_tail_common.cuh"

namespace {

using namespace dtail;

constexpr int TO = 14;             // output pixels per tile side
constexpr int DH = TO + 2;         // du rows / columns of a tile (16)
constexpr int DW = TO + 4;         // du buffer width: dpix reads 2 more
constexpr int PH = TO + 4, PW = TO + 4;  // pixels with the two-pixel halo
constexpr int TPC = 4;             // tiles per CTA (down the image)
constexpr int PRM = 3 * C + 3 * C; // b1, ln scale, ln bias, W2 (C, 3)
constexpr int SMALL = 6 * C + 3;   // db1, dln scale, dln bias, dW2, db2

template <typename T>
size_t smem_bytes() {
  size_t bytes = (size_t)PH * PW * Tile<T>::LD * sizeof(T)
      + (size_t)DH * DW * Tile<T>::LD * sizeof(T)
      + (size_t)WARPS * 16 * LDE * sizeof(float)
      + (size_t)DH * DH * 3 * sizeof(float)
      + (size_t)PRM * sizeof(float);
  if (Tile<T>::kSmemWeights)
    bytes += (size_t)9 * C * Tile<T>::LDW * sizeof(T);
  return bytes;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
decoder_tail_bwd_kernel(const T* __restrict__ pix, const T* __restrict__ go,
                        const T* __restrict__ w1, const T* __restrict__ b1,
                        const T* __restrict__ lns, const T* __restrict__ lnb,
                        const T* __restrict__ w2, T* __restrict__ dpix,
                        float* __restrict__ dw1_part,
                        float* __restrict__ small_part, int H, int W,
                        int approx_i) {
  constexpr int LD = Tile<T>::LD;
  constexpr int LDW = Tile<T>::LDW;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ps = reinterpret_cast<T*>(smem);           // PH*PW pixels
  T* Ds = Ps + PH * PW * LD;                    // DH*DW du values
  float* Es = reinterpret_cast<float*>(Ds + DH * DW * LD);
  float* Gs = Es + WARPS * 16 * LDE;            // DH*DH*3 upstream grads
  float* Prm = Gs + DH * DH * 3;
  T* Ws = reinterpret_cast<T*>(Prm + PRM);      // 9*C rows
  float* B1 = Prm;
  float* LNS = B1 + C;
  float* LNB = LNS + C;
  float* W2 = LNB + C;  // (C, 3)

  const bool approx = approx_i != 0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TO;
  const size_t cta =
      ((size_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const T* img = pix + (size_t)b * H * W * C;
  const T* gimg = go + (size_t)b * H * W * 3;
  float* dw1 = dw1_part + cta * 9 * C * C;  // (tap, c, o)

  for (int i = tid; i < C; i += THREADS) {
    B1[i] = to_f32(b1[i]);
    LNS[i] = to_f32(lns[i]);
    LNB[i] = to_f32(lnb[i]);
  }
  for (int i = tid; i < 3 * C; i += THREADS) W2[i] = to_f32(w2[i]);
  if (Tile<T>::kSmemWeights) load_weights(Ws, w1);
  const T* Wp = Tile<T>::kSmemWeights ? Ws : w1;
  float* Ew = Es + warp * 16 * LDE;
  const int c0 = 2 * lane;

  // this lane's parameter partials (channels c0, c0 + 1)
  float p_db1[2] = {0.f, 0.f}, p_dlns[2] = {0.f, 0.f}, p_dlnb[2] = {0.f, 0.f};
  float p_dw2[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  float p_db2[3] = {0.f, 0.f, 0.f};

  for (int t = 0; t < TPC; ++t) {
    const int y0 = (blockIdx.y * TPC + t) * TO;
    if (y0 >= H) break;
    __syncthreads();  // the previous tile's buffers are consumed
    load_pixels(Ps, img, H, W, y0 - 2, x0 - 2, PH, PW);
    for (int i = tid; i < DH * DH * 3; i += THREADS) {
      const int p = i / 3;
      const int y = y0 - 1 + p / DH, x = x0 - 1 + p % DH;
      Gs[i] = (y >= 0 && y < H && x >= 0 && x < W)
          ? to_f32(gimg[((size_t)y * W + x) * 3 + i % 3]) : 0.f;
    }
    for (int i = tid; i < DH * (DW - DH) * C; i += THREADS) {
      const int row = i / ((DW - DH) * C);
      const int rest = i % ((DW - DH) * C);
      Ds[(row * DW + DH + rest / C) * LD + rest % C] = from_f32<T>(0.f);
    }
    __syncthreads();

    // A: recompute the forward chain and form du over the 16 x 16 halo
    for (int i = warp; i < DH; i += WARPS) {
      const int y = y0 - 1 + i;
      const bool row_in = y >= 0 && y < H;
      const bool row_own = i >= 1 && i <= TO;
      if (row_in) {
        Acc<T> acc[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) zero(acc[n]);
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3;
          const T* a = Ps + ((i + dy) * PW + dx) * LD;
          const T* wt = Wp + tap * C * LDW;
#pragma unroll
          for (int cb = 0; cb < 4; ++cb)
            mma16x64<wmma::row_major, wmma::row_major>(
                acc, a + cb * 16, LD, wt + cb * 16 * LDW, LDW, 16, lane);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) store(Ew + n * 16, LDE, acc[n], lane);
      }
      __syncwarp();
      for (int j = 0; j < DH; ++j) {
        T* dst = Ds + (i * DW + j) * LD + c0;
        const int x = x0 - 1 + j;
        if (!row_in || x < 0 || x >= W) {
          store2(dst, 0.f, 0.f);
          continue;
        }
        float xh[2], dn[2], dxh[2], g[2];
        const float u0 = Ew[j * LDE + c0] + B1[c0];
        const float u1 = Ew[j * LDE + c0 + 1] + B1[c0 + 1];
        const float mean = warp_sum(u0 + u1) / C;
        const float d0 = u0 - mean, d1 = u1 - mean;
        const float var = warp_sum(d0 * d0 + d1 * d1) / C;
        const float rstd = rsqrtf(var + LN_EPS);
        xh[0] = d0 * rstd;
        xh[1] = d1 * rstd;
        const float* gp = Gs + (i * DH + j) * 3;
        const float go0 = gp[0], go1 = gp[1], go2 = gp[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + h;
          const float n = xh[h] * LNS[c] + LNB[c];
          g[h] = gelu(n, approx);
          const float dg = go0 * W2[c * 3] + go1 * W2[c * 3 + 1]
              + go2 * W2[c * 3 + 2];
          dn[h] = dg * gelu_grad(n, approx);
          dxh[h] = dn[h] * LNS[c];
        }
        const float mx = warp_sum(dxh[0] + dxh[1]) / C;
        const float mxx = warp_sum(dxh[0] * xh[0] + dxh[1] * xh[1]) / C;
        const float du0 = rstd * (dxh[0] - mx - xh[0] * mxx);
        const float du1 = rstd * (dxh[1] - mx - xh[1] * mxx);
        store2(dst, du0, du1);
        if (row_own && j >= 1 && j <= TO) {
          p_db1[0] += du0;
          p_db1[1] += du1;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            p_dlns[h] += dn[h] * xh[h];
            p_dlnb[h] += dn[h];
            const float gr = round_to<T>(g[h]);
            p_dw2[h][0] += gr * go0;
            p_dw2[h][1] += gr * go1;
            p_dw2[h][2] += gr * go2;
          }
          p_db2[0] += go0;
          p_db2[1] += go1;
          p_db2[2] += go2;
        }
      }
      __syncwarp();
    }
    __syncthreads();

    // B: dpix of the tile's own rows, du convolved with the rotated kernel
    // (W1 read transposed: column-major (o, c) from the (c, o) rows)
    for (int a = warp; a < TO; a += WARPS) {
      const int y = y0 + a;
      if (y >= H) break;
      Acc<T> acc[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) zero(acc[n]);
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const T* src = Ds + ((a + 2 - dy) * DW + (2 - dx)) * LD;
        const T* wt = Wp + tap * C * LDW;
#pragma unroll
        for (int ob = 0; ob < 4; ++ob)
          mma16x64<wmma::row_major, wmma::col_major>(
              acc, src + ob * 16, LD, wt + ob * 16, LDW, 16 * LDW, lane);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) store(Ew + n * 16, LDE, acc[n], lane);
      __syncwarp();
      for (int j = 0; j < TO; ++j) {
        const int x = x0 + j;
        if (x >= W) break;
        store2(dpix + ((size_t)(b * H + y) * W + x) * C + c0,
               Ew[j * LDE + c0], Ew[j * LDE + c0 + 1]);
      }
      __syncwarp();
    }
    __syncthreads();

    // C: dW1 from the tile's own du only: zero the halo columns (rows 0 and
    // 15 are left out by the loop), then pix^T . du per (tap, c block)
    for (int i = tid; i < DH * 2 * C; i += THREADS) {
      const int row = i / (2 * C);
      const int col = (i / C) % 2 ? DH - 1 : 0;
      Ds[(row * DW + col) * LD + i % C] = from_f32<T>(0.f);
    }
    __syncthreads();
    for (int pair = warp; pair < 9 * 4; pair += WARPS) {
      const int tap = pair / 4, cb = pair % 4;
      const int dy = tap / 3, dx = tap % 3;
      float* dst = dw1 + (tap * C + cb * 16) * C;
      Acc<T> acc[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (t == 0) zero(acc[n]);
        else load(acc[n], dst + n * 16, C, lane);
      }
      for (int i = 1; i <= TO; ++i)
        mma16x64<wmma::col_major, wmma::row_major>(
            acc, Ps + ((i + dy) * PW + dx) * LD + cb * 16, LD,
            Ds + i * DW * LD, LD, 16, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) store(dst + n * 16, C, acc[n], lane);
    }
  }

  float* sp = small_part + (cta * WARPS + warp) * SMALL;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sp[c0 + h] = p_db1[h];
    sp[C + c0 + h] = p_dlns[h];
    sp[2 * C + c0 + h] = p_dlnb[h];
#pragma unroll
    for (int k = 0; k < 3; ++k) sp[3 * C + (c0 + h) * 3 + k] = p_dw2[h][k];
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) sp[6 * C + k] = p_db2[k];
  }
}

dim3 grid_of(int B, int H, int W) {
  const int tiles_y = (H + TO - 1) / TO;
  return dim3((W + TO - 1) / TO, (tiles_y + TPC - 1) / TPC, B);
}

template <typename T>
int launch(const void* pix, const void* go, const void* w1, const void* b1,
           const void* lns, const void* lnb, const void* w2, void* dpix,
           void* dw1_part, void* small_part, int B, int H, int W, int approx,
           void* stream) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      decoder_tail_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = grid_of(B, H, W);
  decoder_tail_bwd_kernel<T><<<grid, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pix), static_cast<const T*>(go),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(lns), static_cast<const T*>(lnb),
      static_cast<const T*>(w2), static_cast<T*>(dpix),
      static_cast<float*>(dw1_part), static_cast<float*>(small_part), H, W,
      approx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int decoder_tail_bwd_bf16(const void* pix, const void* go, const void* w1,
                          const void* b1, const void* lns, const void* lnb,
                          const void* w2, void* dpix, void* dw1_part,
                          void* small_part, int B, int H, int W, int approx,
                          void* stream) {
  return launch<__nv_bfloat16>(pix, go, w1, b1, lns, lnb, w2, dpix, dw1_part,
                               small_part, B, H, W, approx, stream);
}

int decoder_tail_bwd_f32(const void* pix, const void* go, const void* w1,
                         const void* b1, const void* lns, const void* lnb,
                         const void* w2, void* dpix, void* dw1_part,
                         void* small_part, int B, int H, int W, int approx,
                         void* stream) {
  return launch<float>(pix, go, w1, b1, lns, lnb, w2, dpix, dw1_part,
                       small_part, B, H, W, approx, stream);
}

// The fp32 partial buffers the launch writes, as (rows, columns):
// shape[0:2] for dW1 (one (tap, c, o) set per CTA), shape[2:4] for the
// small sums (one row of SMALL per warp). The caller allocates from these.
void decoder_tail_bwd_partials(int B, int H, int W, int* shape) {
  const dim3 grid = grid_of(B, H, W);
  const int ctas = (int)(grid.x * grid.y * grid.z);
  shape[0] = ctas;
  shape[1] = 9 * C * C;
  shape[2] = ctas * WARPS;
  shape[3] = SMALL;
}

const char* decoder_tail_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
