// Fused decoder tail, backward (Hopper, bf16): recomputes the forward chain of
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
// The fp32 route at C = 64 runs the tensor-core kernels of
// decoder_tail_tc_bwd.cu in 3xTF32 (kernels/decoder_head.py
// fused_decoder_tail_bwd): this file is bf16 only.
//
// The launchers allocate nothing and do not synchronize: the bf16 one takes
// a (B, H, W, 64) bf16 scratch for du. They return cudaGetLastError() so
// the caller can raise on a refused launch. decoder_tail_bwd_partials gives
// the partial buffers' sizes, so the tiling is decided here alone.

#include "decoder_tail_hopper.cuh"

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

// The fp32 partial buffers the launch writes, as (rows, columns):
// shape[0:2] for dW1 (one (tap, c, o) set per CTA), shape[2:4] for the
// small sums (one row of SMALL per warp). The caller allocates from these.
// (bf16 is 1: the file is bf16 only; the argument keeps the signature that
// other builds of the file share.)
void decoder_tail_bwd_partials(int B, int H, int W, int bf16, int* shape) {
  (void)bf16;
  const int grid = hop::persistent_grid(hop::strips_of(B, H, W));
  shape[0] = grid;
  shape[2] = grid * 8;
  shape[1] = 9 * hop::C * hop::C;
  shape[3] = hop::SMALL;
}

const char* decoder_tail_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
