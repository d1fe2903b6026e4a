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
// on wgmma m64n64k16 (fp32 accumulate) fed by TMA over strips of R output
// rows (16 at the main shape) x 64 pixels of one image, one persistent CTA
// per SM; every map is 4-D over (C, W, H, B), whose zero fill is the SAME
// padding, and a ring stage holds one input row's three dx boxes, loaded
// once per strip. (A) and (B) are strip_kernel of decoder_tail_hopper.cuh
// (the mainloop K3 runs too) with their own epilogues; (C) has its own
// loop.
//   (A) du: u = pix * W1 + b1 on the shared mainloop (B the resident W1
//       read MN-major). The LayerNorm and GELU backward run on the
//       accumulator fragments: a pixel's 64 channels lie in the four
//       threads of one quad, so every channel mean is two shuffles, and one
//       tanh (tanh.approx.f32, see gelu_and_grad) serves GELU and its
//       derivative. du goes to global memory in bf16 (the rounding the
//       contract names anyway); db1, the LN sums, dW2 and db2 accumulate in
//       registers across the CTA's strips and are reduced once at the end.
//       du is computed once per pixel: no halo recompute.
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
// The fp32 route is scalar (one CTA per 14 x 14 output tile over a halo,
// FMAs from shared memory, weights through L1): it exists for tight fp32
// comparisons, not speed.
//
// The launchers allocate nothing and do not synchronize: the bf16 one takes
// a (B, H, W, 64) bf16 scratch for du. They return cudaGetLastError() so
// the caller can raise on a refused launch. decoder_tail_bwd_partials gives
// the partial buffers' sizes, so the tiling is decided here alone.

#include "decoder_tail_hopper.cuh"

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

constexpr size_t SMEM_BYTES =
    ((size_t)PH * PW * LD + (size_t)DH * DW * LD + (size_t)WARPS * 16 * LDE
     + (size_t)DH * DH * 3 + PRM) * sizeof(float);

__global__ void __launch_bounds__(THREADS, 1)
decoder_tail_bwd_kernel(const float* __restrict__ pix,
                        const float* __restrict__ go,
                        const float* __restrict__ w1,
                        const float* __restrict__ b1,
                        const float* __restrict__ lns,
                        const float* __restrict__ lnb,
                        const float* __restrict__ w2, float* __restrict__ dpix,
                        float* __restrict__ dw1_part,
                        float* __restrict__ small_part, int H, int W,
                        int approx_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);   // PH*PW pixels
  float* Ds = Ps + PH * PW * LD;                // DH*DW du values
  float* Es = Ds + DH * DW * LD;
  float* Gs = Es + WARPS * 16 * LDE;            // DH*DH*3 upstream grads
  float* Prm = Gs + DH * DH * 3;
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
  const float* img = pix + (size_t)b * H * W * C;
  const float* gimg = go + (size_t)b * H * W * 3;
  float* dw1 = dw1_part + cta * 9 * C * C;  // (tap, c, o)

  for (int i = tid; i < C; i += THREADS) {
    B1[i] = b1[i];
    LNS[i] = lns[i];
    LNB[i] = lnb[i];
  }
  for (int i = tid; i < 3 * C; i += THREADS) W2[i] = w2[i];
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
          ? gimg[((size_t)y * W + x) * 3 + i % 3] : 0.f;
    }
    for (int i = tid; i < DH * (DW - DH) * C; i += THREADS) {
      const int row = i / ((DW - DH) * C);
      const int rest = i % ((DW - DH) * C);
      Ds[(row * DW + DH + rest / C) * LD + rest % C] = 0.f;
    }
    __syncthreads();

    // A: recompute the forward chain and form du over the 16 x 16 halo
    for (int i = warp; i < DH; i += WARPS) {
      const int y = y0 - 1 + i;
      const bool row_in = y >= 0 && y < H;
      const bool row_own = i >= 1 && i <= TO;
      if (row_in) {
        Acc acc[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) zero(acc[n]);
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3;
          const float* a = Ps + ((i + dy) * PW + dx) * LD;
          const float* wt = w1 + tap * C * C;
#pragma unroll
          for (int cb = 0; cb < 4; ++cb)
            mma16x64<true, true>(acc, a + cb * 16, LD, wt + cb * 16 * C, C,
                                 16, lane);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) store(Ew + n * 16, LDE, acc[n], lane);
      }
      __syncwarp();
      for (int j = 0; j < DH; ++j) {
        float* dst = Ds + (i * DW + j) * LD + c0;
        const int x = x0 - 1 + j;
        if (!row_in || x < 0 || x >= W) {
          dst[0] = dst[1] = 0.f;
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
        dst[0] = du0;
        dst[1] = du1;
        if (row_own && j >= 1 && j <= TO) {
          p_db1[0] += du0;
          p_db1[1] += du1;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            p_dlns[h] += dn[h] * xh[h];
            p_dlnb[h] += dn[h];
            p_dw2[h][0] += g[h] * go0;
            p_dw2[h][1] += g[h] * go1;
            p_dw2[h][2] += g[h] * go2;
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
      Acc acc[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) zero(acc[n]);
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const float* src = Ds + ((a + 2 - dy) * DW + (2 - dx)) * LD;
        const float* wt = w1 + tap * C * C;
#pragma unroll
        for (int ob = 0; ob < 4; ++ob)
          mma16x64<true, false>(acc, src + ob * 16, LD, wt + ob * 16, C,
                                16 * C, lane);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) store(Ew + n * 16, LDE, acc[n], lane);
      __syncwarp();
      for (int j = 0; j < TO; ++j) {
        const int x = x0 + j;
        if (x >= W) break;
        float* dst = dpix + ((size_t)(b * H + y) * W + x) * C + c0;
        dst[0] = Ew[j * LDE + c0];
        dst[1] = Ew[j * LDE + c0 + 1];
      }
      __syncwarp();
    }
    __syncthreads();

    // C: dW1 from the tile's own du only: zero the halo columns (rows 0 and
    // 15 are left out by the loop), then pix^T . du per (tap, c block)
    for (int i = tid; i < DH * 2 * C; i += THREADS) {
      const int row = i / (2 * C);
      const int col = (i / C) % 2 ? DH - 1 : 0;
      Ds[(row * DW + col) * LD + i % C] = 0.f;
    }
    __syncthreads();
    for (int pair = warp; pair < 9 * 4; pair += WARPS) {
      const int tap = pair / 4, cb = pair % 4;
      const int dy = tap / 3, dx = tap % 3;
      float* dst = dw1 + (tap * C + cb * 16) * C;
      Acc acc[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (t == 0) zero(acc[n]);
        else load(acc[n], dst + n * 16, C, lane);
      }
      for (int i = 1; i <= TO; ++i)
        mma16x64<false, true>(acc, Ps + ((i + dy) * PW + dx) * LD + cb * 16,
                              LD, Ds + i * DW * LD, LD, 16, lane);
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

int launch_f32(const void* pix, const void* go, const void* w1,
               const void* b1, const void* lns, const void* lnb,
               const void* w2, void* dpix, void* dw1_part, void* small_part,
               int B, int H, int W, int approx, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decoder_tail_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = grid_of(B, H, W);
  decoder_tail_bwd_kernel<<<grid, THREADS, SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pix), static_cast<const float*>(go),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(lns), static_cast<const float*>(lnb),
      static_cast<const float*>(w2), static_cast<float*>(dpix),
      static_cast<float*>(dw1_part), static_cast<float*>(small_part), H, W,
      approx);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16: the du and dpix strip epilogues and the dW1 launch
// ---------------------------------------------------------------------------

namespace hop {

constexpr int SMALL = 6 * C + 3;          // db1, dln scale, dln bias, dW2, db2

// (C): 3 consumer warpgroups (one per dy) + 1 producer warpgroup; a stage is
// one input row: du's box at x0, then pix's three boxes
constexpr int W_THREADS = 512;
constexpr int W_CONSUMERS = 384;
constexpr int W_STAGES = 5;
constexpr int W_STAGE = 4 * BOX;
constexpr int W_OFF_BAR = W_STAGES * W_STAGE;
constexpr int W_SMEM = 1024 + W_OFF_BAR + 128;
static_assert(W_SMEM <= 232448, "dW1 shared memory");

// gelu(n) and its derivative (decoder_tail_common.cuh's expressions) from
// one tanh or erf evaluation. The tanh flavour uses tanh.approx.f32: both
// values only reach bf16 outputs through du and the GELU output, which are
// rounded to bf16 first, and the accurate tanhf was the largest part of the
// du launch's epilogue.
__device__ __forceinline__ void gelu_and_grad(float x, bool approx, float& g,
                                              float& dg) {
  if (approx) {
    const float c = 0.7978845608028654f;
    const float a = 0.044715f;
    const float th = tanh_approx(c * (x + a * (x * x * x)));
    g = 0.5f * x * (1.0f + th);
    dg = 0.5f * (1.0f + th)
        + 0.5f * x * (1.0f - th * th) * c * (1.0f + 3.0f * a * x * x);
    return;
  }
  const float cdf = 0.5f * (1.0f + erff(x * 0.7071067811865476f));
  g = x * cdf;
  dg = cdf + x * (expf(-0.5f * x * x) * 0.3989422804014327f);
}

// sum over the eight accumulator rows g of a warp (lanes 4g + tq)
__device__ __forceinline__ float rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// the du and dpix launches' kernel argument (the strip kernel's aux is go,
// its out du (A) or dpix (B))
struct BwdParams {
  const bf16* b1;
  const bf16* lns;
  const bf16* lnb;
  const bf16* w2;
  float* small_part;   // (A): one row of SMALL per consumer warp
  int approx;
};

// (A) du and the small partials
struct DuEpi {
  static constexpr bool kRotated = false;
  static constexpr int kPrmBytes = 6 * C * 4;  // b1, lns, lnb, W2T fp32
  typedef BwdParams Params;

  static __device__ __forceinline__ void load(const Params& p,
                                              unsigned char* prm, int tid) {
    float* B1 = reinterpret_cast<float*>(prm);
    float* LNS = B1 + C;
    float* LNB = LNS + C;
    float* W2T = LNB + C;
    for (int i = tid; i < C; i += AB_THREADS) {
      B1[i] = __bfloat162float(p.b1[i]);
      LNS[i] = __bfloat162float(p.lns[i]);
      LNB[i] = __bfloat162float(p.lnb[i]);
    }
    for (int i = tid; i < 3 * C; i += AB_THREADS)
      W2T[(i % 3) * C + i / 3] = __bfloat162float(p.w2[i]);
  }

  const float* B1;
  const float* LNS;
  const float* LNB;
  const float* W2T;  // (3, C): W2 transposed, channel pairs adjacent
  float* small_part;
  bool approx;
  int wg, warp, lane, g, tq;
  // this thread's partials of channels 8j + 2tq + e
  float p_db1[16], p_dlns[16], p_dlnb[16], p_dw2[16][3], p_db2[3];

  __device__ __forceinline__ DuEpi(const Params& p, unsigned char* prm)
      : B1(reinterpret_cast<const float*>(prm)), LNS(B1 + C), LNB(LNS + C),
        W2T(LNB + C), small_part(p.small_part),
        approx(p.approx != 0), wg(threadIdx.x >> 7),
        warp((threadIdx.x & 127) >> 5), lane(threadIdx.x & 31),
        g(lane >> 2), tq(lane & 3) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      p_db1[i] = p_dlns[i] = p_dlnb[i] = 0.f;
      p_dw2[i][0] = p_dw2[i][1] = p_dw2[i][2] = 0.f;
    }
    p_db2[0] = p_db2[1] = p_db2[2] = 0.f;
  }

  __device__ __forceinline__ void row(const float (&acc)[32], int b, int y,
                                      int x0, const Strips& sp,
                                      const bf16* __restrict__ go,
                                      bf16* __restrict__ out) {
    if (approx) row_as<true>(acc, b, y, x0, sp, go, out);
    else row_as<false>(acc, b, y, x0, sp, go, out);
  }

  // the row for one GELU flavour: a branch per element on the flavour
  // kept the compiler from interleaving the elements' epilogues
  template <bool APPROX>
  __device__ __forceinline__ void row_as(const float (&acc)[32], int b, int y,
                                         int x0, const Strips& sp,
                                         const bf16* __restrict__ go,
                                         bf16* __restrict__ out) {
    const size_t prow = ((size_t)b * sp.H + y) * sp.W;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + warp * 16 + g + 8 * h;
      const bool valid = x < sp.W && y < sp.H;
      bf16* dst = out + (prow + x) * C + 2 * tq;
      float gk[3] = {0.f, 0.f, 0.f};
      if (valid) {
        const bf16* gp = go + (prow + x) * 3;
        gk[0] = __bfloat162float(__ldg(gp));
        gk[1] = __bfloat162float(__ldg(gp + 1));
        gk[2] = __bfloat162float(__ldg(gp + 2));
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
          gelu_and_grad(n, APPROX, gl, gd);
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

  // one row of partials per consumer warp: sums over its eight rows g
  __device__ __forceinline__ void finish() {
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
};

// (B) dpix: the accumulator is the output
struct DpixEpi {
  static constexpr bool kRotated = true;
  static constexpr int kPrmBytes = 0;
  typedef BwdParams Params;

  static __device__ __forceinline__ void load(const Params&, unsigned char*,
                                              int) {}

  int warp, g, tq;

  __device__ __forceinline__ DpixEpi(const Params&, unsigned char*)
      : warp((threadIdx.x & 127) >> 5), g((threadIdx.x & 31) >> 2),
        tq(threadIdx.x & 3) {}

  __device__ __forceinline__ void row(const float (&acc)[32], int b, int y,
                                      int x0, const Strips& sp,
                                      const bf16* __restrict__,
                                      bf16* __restrict__ out) {
    const size_t prow = ((size_t)b * sp.H + y) * sp.W;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + warp * 16 + g + 8 * h;
      if (x < sp.W && y < sp.H) {
        bf16* dst = out + (prow + x) * C + 2 * tq;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
      }
    }
  }

  __device__ __forceinline__ void finish() {}
};

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

int launch(const void* pix, const void* go, const void* w1, const void* b1,
           const void* lns, const void* lnb, const void* w2, void* dpix,
           void* dw1_part, void* small_part, void* du, int B, int H, int W,
           int approx, cudaStream_t st) {
  const Strips sp = strips_of(B, H, W);
  CUtensorMap m_pix, m_du, m_w1;
  if (!map_pixels(&m_pix, pix, B, H, W) || !map_pixels(&m_du, du, B, H, W) ||
      !map_w1(&m_w1, w1))
    return (int)cudaErrorInvalidValue;
  const BwdParams p = {static_cast<const bf16*>(b1),
                       static_cast<const bf16*>(lns),
                       static_cast<const bf16*>(lnb),
                       static_cast<const bf16*>(w2),
                       static_cast<float*>(small_part), approx};
  int err = launch_strips<DuEpi>(m_pix, m_w1, static_cast<const bf16*>(go),
                                 static_cast<bf16*>(du), p, sp, st);
  if (err != cudaSuccess) return err;
  err = launch_strips<DpixEpi>(m_du, m_w1, nullptr, static_cast<bf16*>(dpix),
                               p, sp, st);
  if (err != cudaSuccess) return err;

  cudaError_t e = cudaFuncSetAttribute(
      dw1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (e != cudaSuccess) return (int)e;
  dw1_kernel<<<persistent_grid(sp), W_THREADS, W_SMEM, st>>>(
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
  return launch_f32(pix, go, w1, b1, lns, lnb, w2, dpix, dw1_part,
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
