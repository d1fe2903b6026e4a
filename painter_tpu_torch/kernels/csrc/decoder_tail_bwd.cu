// Fused decoder tail, backward (Hopper): recomputes the forward chain of
// decoder_tail_fwd.cu and emits the complete input gradient plus fp32
// partials of the six parameter gradients.
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
// LN sums and db2 are fp32. dpix is written whole; the launches write fp32
// partials of dW1 (9*64*64 per set) and of the six small ones (a row per
// warp), which the wrapper sums with torch.sum in a fixed order (the JAX
// package sums its per-block partials in XLA the same way).
//
// What bounds it on an H100: operations. Three 3x3 convolutions' worth of
// products (the forward recompute, dpix and dW1), 2 * N * 64 * (27*64 +
// 6) FLOP with the 64 -> 3 pieces: 1.79e11 at (2, 896, 448), 0.181 ms at
// 989 TFLOP/s bf16. Its IO is pix, go and dpix, 210.4 MB in bf16 (0.063
// ms at 3.35 TB/s).
//
// bf16 design: three sm_90a launches, each a warp-specialized implicit GEMM
// on wgmma m64n64k16 (fp32 accumulate) fed by TMA. An output row of 64
// pixels is one M = 64 tile, N = 64 channels, K = 9 taps x 64. The work is
// cut into strips of R output rows (16 at the main shape) of one 64-pixel
// column of one image, and one persistent CTA per SM walks strips. Every
// map is 4-D over (C, W, H, B) with 128-byte swizzle: a box of 64 pixels x
// 64 channels at (x0 + dx - 1, y + dy - 1) comes back with the SAME padding
// already in it, since TMA zero-fills what lies outside the image, and B is
// its own axis, so image b + 1's first row never lands in image b's bottom
// halo. A shift by one pixel is a shift by one 128-byte row, which would
// break the 128-byte swizzle phase of an A descriptor inside one box: each
// dx is its own box instead (three L2-served loads of the same row), and
// every descriptor starts on a 1024-byte boundary. (TMA's im2col mode would
// load fewer bytes but packs the taps along the pixel axis; the per-dx box
// keeps every operand a plain swizzled tile.) A ring stage holds one input
// row's three boxes, loaded once per strip and read by the three output
// rows that need it: (R + 2) x 3 boxes per R rows instead of 9 R.
//   (A) du: W1 (72 KiB, (tap, c, o) rows) stays resident in shared memory;
//       a producer warp fills a 6-stage ring; two consumer warpgroups take
//       a strip's even and odd output rows. u = pix * W1 + b1 is 9 x 4
//       wgmma with A K-major (pixels x c) and B the resident W1 read
//       MN-major (c rows, o contiguous). The LayerNorm and GELU backward
//       run on the accumulator fragments: a pixel's 64 channels lie in the
//       four threads of one quad, so every channel mean is two shuffles, and
//       one tanh (tanh.approx.f32, see gelu_and_grad) serves GELU and its
//       derivative. du goes to global memory in
//       bf16 (the rounding the contract names anyway); db1, the LN sums, dW2
//       and db2 accumulate in registers across the CTA's strips and are
//       reduced once at the end. du is computed once per pixel: no halo
//       recompute.
//   (B) dpix: the same ring over du's rows, taps (dy, dx) at (x0 - dx + 1,
//       y - dy + 1), against the same resident W1 now read K-major (c rows
//       are N, o is K): the rotated kernel without a transposed copy.
//   (C) dW1 = im2col(pix)^T . du as a split-K GEMM: a stage holds an input
//       row's three pix boxes and its du box; three consumer warpgroups own
//       one dy each, three m64n64 accumulators (dx) apiece, A a pix box read
//       MN-major (pixels are K, c is M), B the du box read MN-major. Each
//       CTA writes one fp32 (tap, c, o) partial set: 132 x 147 KiB stay in
//       L2 until the wrapper's sum reads them.
// No atomics and a static strip schedule: two runs give the same bits. The
// three launches count as one call of the wrapper.
//
// The fp32 instantiation keeps the scalar route (one CTA per 14 x 14
// output tile over a halo, FMAs from shared memory, weights through L1):
// it exists for tight fp32 comparisons, not speed.
//
// The launchers allocate nothing and do not synchronize: the bf16 one takes
// a (B, H, W, 64) bf16 scratch for du. They return cudaGetLastError() so
// the caller can raise on a refused launch. decoder_tail_bwd_partials gives
// the partial buffers' sizes, so the tiling is decided here alone.

#include <algorithm>

#include "decoder_tail_common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: the scalar route
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16: three wgmma + TMA launches
// ---------------------------------------------------------------------------

namespace hop {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int C = dtail::C;
constexpr int TILE = 64;                  // pixels per unit (one row segment)
constexpr int BOX = TILE * C * 2;         // a (64 pixels, 64 channels) box
constexpr int TAPS = 9;
constexpr int SMALL = 6 * C + 3;          // db1, dln scale, dln bias, dW2, db2

// (A) / (B): 2 consumer warpgroups + 1 producer warpgroup; a ring stage is
// one input row: its three boxes at x0 - 1, x0, x0 + 1
constexpr int ROW = 3 * BOX;
constexpr int AB_THREADS = 384;
constexpr int AB_CONSUMERS = 256;
constexpr int AB_STAGES = 6;
constexpr int AB_OFF_RING = TAPS * BOX;               // after the resident W1
constexpr int AB_OFF_BAR = AB_OFF_RING + AB_STAGES * ROW;
constexpr int AB_OFF_PRM = AB_OFF_BAR + 512;          // b1, lns, lnb, W2 fp32
constexpr int AB_SMEM = 1024 + AB_OFF_PRM + 6 * C * 4;
static_assert(AB_SMEM <= 232448, "du / dpix shared memory");

// (C): 3 consumer warpgroups (one per dy) + 1 producer warpgroup; a stage is
// one input row: du's box at x0, then pix's three boxes
constexpr int W_THREADS = 512;
constexpr int W_CONSUMERS = 384;
constexpr int W_STAGES = 5;
constexpr int W_STAGE = 4 * BOX;
constexpr int W_OFF_BAR = W_STAGES * W_STAGE;
constexpr int W_SMEM = 1024 + W_OFF_BAR + 128;
static_assert(W_SMEM <= 232448, "dW1 shared memory");

// The work is cut into strips: R output rows (R even) of one 64-pixel
// column of one image. A strip reads input rows y0 - 1 .. y0 + R, one ring
// stage each (stage q holds row y0 - 1 + q), so every row's boxes are loaded
// once per strip and serve the three output rows that read them.
struct Strips {
  int H, W, xt, ys, R, total;  // ys: strips down the image
  __device__ void decode(int s, int& b, int& y0, int& x0) const {
    const int col = s % xt;
    const int rest = s / xt;
    x0 = col * TILE;
    b = rest / ys;
    y0 = (rest - b * ys) * R;
  }
};

// gelu(n) and its derivative (decoder_tail_common.cuh's expressions) from
// one tanh or erf evaluation. The tanh flavour uses tanh.approx.f32
// (relative error about 2^-11): both values only reach bf16 outputs through
// du and the GELU output, which are rounded to bf16 (2^-9) first, and the
// accurate tanhf was the largest part of the du launch's epilogue.
__device__ __forceinline__ void gelu_and_grad(float x, bool approx, float& g,
                                              float& dg) {
  if (approx) {
    const float c = 0.7978845608028654f;
    const float a = 0.044715f;
    float th;
    asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(c * (x + a * (x * x * x))));
    g = 0.5f * x * (1.0f + th);
    dg = 0.5f * (1.0f + th)
        + 0.5f * x * (1.0f - th * th) * c * (1.0f + 3.0f * a * x * x);
    return;
  }
  const float cdf = 0.5f * (1.0f + erff(x * 0.7071067811865476f));
  g = x * cdf;
  dg = cdf + x * (expf(-0.5f * x * x) * 0.3989422804014327f);
}

// quad (four threads of one accumulator row) sum: every lane of the quad
// ends with the same bits
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// sum over the eight accumulator rows g of a warp (lanes 4g + tq)
__device__ __forceinline__ float rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// (A) du and the small partials (DPIX = false) or (B) dpix (DPIX = true).
// Persistent: CTA i takes strips i, i + G, ...; in a strip, warpgroup w
// takes the output rows j = w, w + 2, ... Output row j reads stages j, j + 1,
// j + 2. A warpgroup releases stages j and j + 1 after its row j (its last
// use of both), and j + 2 too after its last row; the stage the other
// warpgroup alone reads (0 for warpgroup 1, R + 1 for warpgroup 0) it
// releases unused, after waiting for it to be filled, so that no arrival
// lands on an earlier round of a stage's barrier.
template <bool DPIX>
__global__ void __launch_bounds__(AB_THREADS, 1)
conv_kernel(const __grid_constant__ CUtensorMap tm_in,
            const __grid_constant__ CUtensorMap tm_w1,
            const bf16* __restrict__ go, const bf16* __restrict__ b1,
            const bf16* __restrict__ lns, const bf16* __restrict__ lnb,
            const bf16* __restrict__ w2, bf16* __restrict__ out,
            float* __restrict__ small_part, Strips sp, int approx_i) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_w1 = smem_u32(smem);
  const uint32_t s_ring = s_w1 + AB_OFF_RING;
  const uint32_t bar_full = s_w1 + AB_OFF_BAR;
  const uint32_t bar_empty = bar_full + 8 * AB_STAGES;
  const uint32_t bar_w1 = bar_empty + 8 * AB_STAGES;
  float* B1 = reinterpret_cast<float*>(smem + AB_OFF_PRM);
  float* LNS = B1 + C;
  float* LNB = LNS + C;
  float* W2T = LNB + C;  // (3, C): W2 transposed, channel pairs adjacent

  const int tid = threadIdx.x;
  const int R = sp.R;
  if (tid == AB_CONSUMERS) {
    for (int s = 0; s < AB_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, AB_CONSUMERS);
    }
    mbar_init(bar_w1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!DPIX) {
    for (int i = tid; i < C; i += AB_THREADS) {
      B1[i] = __bfloat162float(b1[i]);
      LNS[i] = __bfloat162float(lns[i]);
      LNB[i] = __bfloat162float(lnb[i]);
    }
    for (int i = tid; i < 3 * C; i += AB_THREADS)
      W2T[(i % 3) * C + i / 3] = __bfloat162float(w2[i]);
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == AB_CONSUMERS) {
      mbar_expect_tx(bar_w1, TAPS * BOX);
      for (int t = 0; t < TAPS; ++t)
        tma_load_2d(s_w1 + t * BOX, &tm_w1, 0, t * C, bar_w1);
      int g = 0;
      for (int st = blockIdx.x; st < sp.total; st += gridDim.x) {
        int b, y0, x0;
        sp.decode(st, b, y0, x0);
        for (int q = 0; q < R + 2; ++q, ++g) {
          const int s = g % AB_STAGES;
          mbar_wait(bar_empty + 8 * s, ((g / AB_STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * s, ROW);
          for (int d = 0; d < 3; ++d)
            tma_load_4d(s_ring + s * ROW + d * BOX, &tm_in, 0, x0 - 1 + d,
                        y0 - 1 + q, b, bar_full + 8 * s);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const bool approx = approx_i != 0;
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    // this thread's partials of channels 8j + 2tq + e (A only)
    float p_db1[16], p_dlns[16], p_dlnb[16], p_dw2[16][3], p_db2[3];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      p_db1[i] = p_dlns[i] = p_dlnb[i] = 0.f;
      p_dw2[i][0] = p_dw2[i][1] = p_dw2[i][2] = 0.f;
    }
    p_db2[0] = p_db2[1] = p_db2[2] = 0.f;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    // wait for stage q of the strip at ring index gb to be filled, release it
    auto release = [&](int gq) {
      mbar_wait(bar_full + 8 * (gq % AB_STAGES), (gq / AB_STAGES) & 1);
      mbar_arrive(bar_empty + 8 * (gq % AB_STAGES));
    };

    mbar_wait(bar_w1, 0);
    int gb = 0;
    for (int st = blockIdx.x; st < sp.total; st += gridDim.x, gb += R + 2) {
      int b, y0, x0;
      sp.decode(st, b, y0, x0);
      if (wg == 1) release(gb);
      for (int r = wg; r < R; r += 2) {
        fence_regs(acc);
#pragma unroll 1
        for (int t = 0; t < TAPS; ++t) {
          // u: pix row y + dy - 1, box x + dx - 1; dpix: du row y - dy + 1,
          // box x - dx + 1
          const int dyi = t / 3, dxi = t % 3;
          const int gq = gb + r + (DPIX ? 2 - dyi : dyi);
          const int s = gq % AB_STAGES;
          mbar_wait(bar_full + 8 * s, (gq / AB_STAGES) & 1);
          const uint64_t da = desc_sw128(
              s_ring + s * ROW + (DPIX ? 2 - dxi : dxi) * BOX, 16, 1024);
          const uint64_t dw = desc_sw128(s_w1 + t * BOX, 16, 1024);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < C / 16; ++kk) {
            if (DPIX)  // B = W1 K-major: (c rows, o along k)
              wgmma_m64n64k16_ss<0, 0>(acc, da + 2 * kk, dw + 2 * kk,
                                       t > 0 || kk > 0);
            else       // B = W1 MN-major: (c rows along k, o along n)
              wgmma_m64n64k16_ss<0, 1>(acc, da + 2 * kk, dw + 128 * kk,
                                       t > 0 || kk > 0);
          }
          wgmma_commit();
        }
        wgmma_wait0();
        fence_regs(acc);
        mbar_arrive(bar_empty + 8 * ((gb + r) % AB_STAGES));
        mbar_arrive(bar_empty + 8 * ((gb + r + 1) % AB_STAGES));
        if (r + 2 >= R) mbar_arrive(bar_empty + 8 * ((gb + r + 2) % AB_STAGES));

        const int y = y0 + r;
        const size_t prow = ((size_t)b * sp.H + y) * sp.W;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = x0 + warp * 16 + g + 8 * h;
        const bool valid = x < sp.W && y < sp.H;
        bf16* dst = out + (prow + x) * C + 2 * tq;
        if (DPIX) {
          if (valid) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
                  __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                        acc[4 * j + 2 * h + 1]);
          }
          continue;
        }
        float gk[3] = {0.f, 0.f, 0.f};
        if (valid) {
          const bf16* gp = go + (prow + x) * 3;
          gk[0] = __bfloat162float(gp[0]);
          gk[1] = __bfloat162float(gp[1]);
          gk[2] = __bfloat162float(gp[2]);
        }
        // element i = 2 j + e is channel 8 j + 2 tq + e
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
        float dn[16], dxh[16];
        float s1 = 0.f, s2 = 0.f;
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
            const int i = 2 * j + e;
            const float lsc = e ? sc.y : sc.x;
            v[i] *= rstd;  // xhat
            const float n = v[i] * lsc + (e ? sh.y : sh.x);
            const float dg = gk[0] * (e ? wa.y : wa.x) +
                             gk[1] * (e ? wb.y : wb.x) +
                             gk[2] * (e ? wc.y : wc.x);
            float gl, gd;
            gelu_and_grad(n, approx, gl, gd);
            dn[i] = dg * gd;
            dxh[i] = dn[i] * lsc;
            s1 += dxh[i];
            s2 += dxh[i] * v[i];
            if (valid) {
              const float gr = __bfloat162float(__float2bfloat16(gl));
              p_dw2[i][0] += gr * gk[0];
              p_dw2[i][1] += gr * gk[1];
              p_dw2[i][2] += gr * gk[2];
            }
          }
        }
        const float mx = quad_sum(s1) / C;
        const float mxx = quad_sum(s2) / C;
        float* du = dxh;  // in place
#pragma unroll
        for (int i = 0; i < 16; ++i) du[i] = rstd * (dxh[i] - mx - v[i] * mxx);
        if (valid) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
                __floats2bfloat162_rn(du[2 * j], du[2 * j + 1]);
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            p_db1[i] += du[i];
            p_dlns[i] += dn[i] * v[i];
            p_dlnb[i] += dn[i];
          }
          if (tq == 0) {
            p_db2[0] += gk[0];
            p_db2[1] += gk[1];
            p_db2[2] += gk[2];
          }
        }
      }
      }
      if (wg == 0) release(gb + R + 1);
    }

    if (!DPIX) {
      // one row of partials per consumer warp: sums over its eight rows g
      float* part = small_part + ((size_t)blockIdx.x * 8 + wg * 4 + warp) * SMALL;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = 8 * (i / 2) + 2 * tq + (i % 2);
        const float a = rows_sum(p_db1[i]);
        const float bs = rows_sum(p_dlns[i]);
        const float cs = rows_sum(p_dlnb[i]);
        const float d0 = rows_sum(p_dw2[i][0]);
        const float d1 = rows_sum(p_dw2[i][1]);
        const float d2 = rows_sum(p_dw2[i][2]);
        if (g == 0) {
          part[c] = a;
          part[C + c] = bs;
          part[2 * C + c] = cs;
          part[3 * C + 3 * c] = d0;
          part[3 * C + 3 * c + 1] = d1;
          part[3 * C + 3 * c + 2] = d2;
        }
      }
#pragma unroll
      for (int kq = 0; kq < 3; ++kq) {
        const float t = rows_sum(p_db2[kq]);
        if (lane == 0) part[6 * C + kq] = t;
      }
    }
  }
}

// (C) dW1 partials: CTA i takes strips i, i + G, ...; all three consumer
// warpgroups work on each output row r of a strip: warpgroup dy multiplies
// the three pix boxes of stage r + dy (taps (dy, 0..2)) by the du box of
// stage r + 1. After row r every warpgroup is done with stage r, and after
// the strip's last row with stages R and R + 1. A warpgroup waits for a
// stage to be filled before it releases it, the stages it never reads
// included, so that no arrival lands on an earlier round of the barrier.
__global__ void __launch_bounds__(W_THREADS, 1)
dw1_kernel(const __grid_constant__ CUtensorMap tm_pix,
           const __grid_constant__ CUtensorMap tm_du,
           float* __restrict__ dw1_part, Strips sp) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_ring = smem_u32(smem);
  const uint32_t bar_full = s_ring + W_OFF_BAR;
  const uint32_t bar_empty = bar_full + 8 * W_STAGES;

  const int tid = threadIdx.x;
  const int R = sp.R;
  if (tid == W_CONSUMERS) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, W_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 3) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == W_CONSUMERS) {
      int g = 0;
      for (int st = blockIdx.x; st < sp.total; st += gridDim.x) {
        int b, y0, x0;
        sp.decode(st, b, y0, x0);
        for (int q = 0; q < R + 2; ++q, ++g) {
          const int s = g % W_STAGES;
          mbar_wait(bar_empty + 8 * s, ((g / W_STAGES) & 1) ^ 1);
          const uint32_t dst = s_ring + s * W_STAGE;
          mbar_expect_tx(bar_full + 8 * s, W_STAGE);
          tma_load_4d(dst, &tm_du, 0, x0, y0 - 1 + q, b, bar_full + 8 * s);
          for (int d = 0; d < 3; ++d)
            tma_load_4d(dst + (1 + d) * BOX, &tm_pix, 0, x0 - 1 + d,
                        y0 - 1 + q, b, bar_full + 8 * s);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n");
    float acc[3][32];
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[d][i] = 0.f;
    auto wait_full = [&](int gq) {
      mbar_wait(bar_full + 8 * (gq % W_STAGES), (gq / W_STAGES) & 1);
    };
    auto release = [&](int gq) {
      wait_full(gq);
      mbar_arrive(bar_empty + 8 * (gq % W_STAGES));
    };
    int gb = 0;
    for (int st = blockIdx.x; st < sp.total; st += gridDim.x, gb += R + 2) {
      for (int r = 0; r < R; ++r) {
        const int gp = gb + r + wg, gd = gb + r + 1;
        wait_full(gp);
        wait_full(gd);
        // du box of row y: pixels x o, read with o as N
        const uint64_t dd =
            desc_sw128(s_ring + (gd % W_STAGES) * W_STAGE, 16, 1024);
#pragma unroll
        for (int d = 0; d < 3; ++d) fence_regs(acc[d]);
        wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          // pix box of tap (wg, dx): pixels x c, read with c as M
          const uint64_t dp = desc_sw128(
              s_ring + (gp % W_STAGES) * W_STAGE + (1 + dx) * BOX, 16, 1024);
#pragma unroll
          for (int kk = 0; kk < TILE / 16; ++kk)
            wgmma_m64n64k16_ss<1, 1>(acc[dx], dp + 128 * kk, dd + 128 * kk, 1);
        }
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int d = 0; d < 3; ++d) fence_regs(acc[d]);
        release(gb + r);
      }
      release(gb + R);
      release(gb + R + 1);
    }

    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    float* part = dw1_part + (size_t)blockIdx.x * TAPS * C * C;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      float* tap = part + (size_t)(3 * wg + dx) * C * C;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = warp * 16 + g + 8 * h;
          *reinterpret_cast<float2*>(tap + c * C + 8 * j + 2 * tq) =
              make_float2(acc[dx][4 * j + 2 * h], acc[dx][4 * j + 2 * h + 1]);
        }
    }
  }
}

// strips of 16 output rows, or fewer where that leaves SMs without a strip
Strips strips_of(int B, int H, int W) {
  const int sms = sm_count();
  Strips sp;
  sp.H = H;
  sp.W = W;
  sp.xt = (W + TILE - 1) / TILE;
  sp.R = 16;
  while (sp.R > 2 && B * sp.xt * ((H + sp.R - 1) / sp.R) < sms) sp.R /= 2;
  sp.ys = (H + sp.R - 1) / sp.R;
  sp.total = B * sp.xt * sp.ys;
  return sp;
}

// one persistent CTA per SM, at most one per strip (all three launches)
int persistent_grid(const Strips& sp) {
  return std::min(sm_count(), sp.total);
}

// a (B, H, W, 64) bf16 tensor as 4-D TMA boxes of (64 channels, 64 pixels)
bool map_pixels(CUtensorMap* map, const void* ptr, int B, int H, int W) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {C, TILE, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims,
                    strides, box);
}

int launch(const void* pix, const void* go, const void* w1, const void* b1,
           const void* lns, const void* lnb, const void* w2, void* dpix,
           void* dw1_part, void* small_part, void* du, int B, int H, int W,
           int approx, cudaStream_t st) {
  const Strips sp = strips_of(B, H, W);
  CUtensorMap m_pix, m_du, m_w1;
  const cuuint64_t wdims[2] = {(cuuint64_t)C, (cuuint64_t)TAPS * C};
  const cuuint64_t wstrides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t wbox[2] = {C, C};
  if (!map_pixels(&m_pix, pix, B, H, W) || !map_pixels(&m_du, du, B, H, W) ||
      !encode_map(&m_w1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w1, wdims,
                  wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  const bf16* pb1 = static_cast<const bf16*>(b1);
  const bf16* plns = static_cast<const bf16*>(lns);
  const bf16* plnb = static_cast<const bf16*>(lnb);
  const bf16* pw2 = static_cast<const bf16*>(w2);
  const int grid = persistent_grid(sp);

  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      AB_SMEM);
  if (err != cudaSuccess) return (int)err;
  conv_kernel<false><<<grid, AB_THREADS, AB_SMEM, st>>>(
      m_pix, m_w1, static_cast<const bf16*>(go), pb1, plns, plnb, pw2,
      static_cast<bf16*>(du), static_cast<float*>(small_part), sp, approx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(conv_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             AB_SMEM);
  if (err != cudaSuccess) return (int)err;
  conv_kernel<true><<<grid, AB_THREADS, AB_SMEM, st>>>(
      m_du, m_w1, nullptr, pb1, plns, plnb, pw2, static_cast<bf16*>(dpix),
      nullptr, sp, approx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(dw1_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             W_SMEM);
  if (err != cudaSuccess) return (int)err;
  dw1_kernel<<<grid, W_THREADS, W_SMEM, st>>>(
      m_pix, m_du, static_cast<float*>(dw1_part), sp);
  return (int)cudaGetLastError();
}

}  // namespace hop

extern "C" {

int decoder_tail_bwd_bf16(const void* pix, const void* go, const void* w1,
                          const void* b1, const void* lns, const void* lnb,
                          const void* w2, void* dpix, void* dw1_part,
                          void* small_part, void* du, int B, int H, int W,
                          int approx, void* stream) {
  return hop::launch(pix, go, w1, b1, lns, lnb, w2, dpix, dw1_part,
                     small_part, du, B, H, W, approx,
                     static_cast<cudaStream_t>(stream));
}

// du is not used: the scalar route keeps it on the SM
int decoder_tail_bwd_f32(const void* pix, const void* go, const void* w1,
                         const void* b1, const void* lns, const void* lnb,
                         const void* w2, void* dpix, void* dw1_part,
                         void* small_part, void*, int B, int H, int W,
                         int approx, void* stream) {
  return launch<float>(pix, go, w1, b1, lns, lnb, w2, dpix, dw1_part,
                       small_part, B, H, W, approx, stream);
}

// The fp32 partial buffers the bf16 (bf16 != 0) or fp32 launch writes, as
// (rows, columns): shape[0:2] for dW1 (one (tap, c, o) set per CTA),
// shape[2:4] for the small sums (one row of SMALL per warp). The caller
// allocates from these.
void decoder_tail_bwd_partials(int B, int H, int W, int bf16, int* shape) {
  if (bf16) {
    const int grid = hop::persistent_grid(hop::strips_of(B, H, W));
    shape[0] = grid;
    shape[2] = grid * 8;
  } else {
    const dim3 grid = grid_of(B, H, W);
    const int ctas = (int)(grid.x * grid.y * grid.z);
    shape[0] = ctas;
    shape[2] = ctas * WARPS;
  }
  shape[1] = 9 * C * C;
  shape[3] = SMALL;
}

const char* decoder_tail_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
