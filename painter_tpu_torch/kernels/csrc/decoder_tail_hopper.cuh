// The bf16 strip mainloop of the fused decoder-tail kernels (Hopper): an
// implicit-GEMM 3x3 convolution on wgmma m64n64k16 (fp32 accumulate) fed by
// TMA, shared by the forward (decoder_tail_fwd.cu) and the backward's du and
// dpix launches (decoder_tail_bwd.cu). Each caller supplies only the
// epilogue that turns a row's accumulator into its output.
//
// An output row of 64 pixels is one M = 64 tile, N = 64 channels, K = 9 taps
// x 64. The work is cut into strips of R output rows (16 at the main shape)
// of one 64-pixel column of one image, and one persistent CTA per SM walks
// strips. The input map is 4-D over (C, W, H, B) with 128-byte swizzle: a box
// of 64 pixels x 64 channels at (x0 + dx - 1, y + dy - 1) comes back with the
// SAME padding already in it, since TMA zero-fills what lies outside the
// image, and B is its own axis, so image b + 1's first row never lands in
// image b's bottom halo. A shift by one pixel is a shift by one 128-byte row,
// which would break the 128-byte swizzle phase of an A descriptor inside one
// box: each dx is its own box instead (three L2-served loads of the same
// row), and every descriptor starts on a 1024-byte boundary. (TMA's im2col
// mode would load fewer bytes but packs the taps along the pixel axis; the
// per-dx box keeps every operand a plain swizzled tile.) A ring stage
// holds one input row's three boxes, loaded once per strip and read by the
// three output rows that need it: (R + 2) x 3 boxes per R rows instead of
// 9 R. W1 (72 KiB, (tap, c, o) rows) stays resident in shared memory, loaded
// once per CTA; a producer warp fills a 6-stage ring; two consumer
// warpgroups take a strip's even and odd output rows, so one warpgroup's
// epilogue runs while the other's products do.
#pragma once

#include <algorithm>

#include "decoder_tail_common.cuh"
#include "hopper.cuh"

namespace hop {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int C = dtail::C;
constexpr int TILE = 64;                  // pixels per unit (one row segment)
constexpr int BOX = TILE * C * 2;         // a (64 pixels, 64 channels) box
constexpr int TAPS = 9;

// 2 consumer warpgroups + 1 producer warpgroup; a ring stage is one input
// row: its three boxes at x0 - 1, x0, x0 + 1
constexpr int ROW = 3 * BOX;
constexpr int AB_THREADS = 384;
constexpr int AB_CONSUMERS = 256;
constexpr int AB_STAGES = 6;
constexpr int AB_OFF_RING = TAPS * BOX;               // after the resident W1
constexpr int AB_OFF_BAR = AB_OFF_RING + AB_STAGES * ROW;
constexpr int AB_OFF_PRM = AB_OFF_BAR + 512;          // the epilogue's own
// dynamic shared memory of a strip kernel whose epilogue keeps prm bytes
constexpr int ab_smem(int prm) { return 1024 + AB_OFF_PRM + prm; }

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

// quad (four threads of one accumulator row) sum: every lane of the quad
// ends with the same bits
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

using dtail::tanh_approx;

// An epilogue E supplies:
//   E::kRotated   taps (dy, dx) read input row y - dy + 1, box x - dx + 1 and
//                 W1 K-major (dpix: the rotated kernel without a transposed
//                 copy); otherwise row y + dy - 1, box x + dx - 1 and W1
//                 MN-major (c rows along k, o along n)
//   E::kPrmBytes  its shared memory after the barriers
//   E::Params     its kernel argument (parameter pointers, options)
//   E::load(p, prm, tid)      every thread, before the CTA's first barrier
//   E(p, prm)                 a consumer thread's state
//   e.row(acc, b, y, x0, sp, aux, out)  output row y of the 64-pixel unit
//                                       at x0
//   e.finish()                after the CTA's last strip
// The row's output tensor and a second input read per pixel (K4's upstream
// gradient) come as __restrict__ kernel parameters.
//
// Persistent: CTA i takes strips i, i + G, ...; in a strip, warpgroup w
// takes the output rows j = w, w + 2, ... Output row j reads stages j, j + 1,
// j + 2. A warpgroup releases stages j and j + 1 after its row j (its last
// use of both), and j + 2 too after its last row; the stage the other
// warpgroup alone reads (0 for warpgroup 1, R + 1 for warpgroup 0) it
// releases unused, after waiting for it to be filled, so that no arrival
// lands on an earlier round of a stage's barrier.
template <class E>
__global__ void __launch_bounds__(AB_THREADS, 1)
strip_kernel(const __grid_constant__ CUtensorMap tm_in,
             const __grid_constant__ CUtensorMap tm_w1,
             const bf16* __restrict__ aux, bf16* __restrict__ out,
             const typename E::Params p, Strips sp) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_w1 = smem_u32(smem);
  const uint32_t s_ring = s_w1 + AB_OFF_RING;
  const uint32_t bar_full = s_w1 + AB_OFF_BAR;
  const uint32_t bar_empty = bar_full + 8 * AB_STAGES;
  const uint32_t bar_w1 = bar_empty + 8 * AB_STAGES;
  unsigned char* prm = smem + AB_OFF_PRM;

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
  E::load(p, prm, tid);
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
    E epi(p, prm);
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    int gb = 0;  // ring index of the current strip's stage 0
    // wait for stage gq to be filled, release it
    auto release = [&](int gq) {
      mbar_wait(bar_full + 8 * (gq % AB_STAGES), (gq / AB_STAGES) & 1);
      mbar_arrive(bar_empty + 8 * (gq % AB_STAGES));
    };
    // issue the 9 taps of the strip's output row r into a, one commit group
    // per tap; the caller waits
    auto issue = [&](float (&a)[32], int r) {
      fence_regs(a);
#pragma unroll 1
      for (int t = 0; t < TAPS; ++t) {
        const int dyi = t / 3, dxi = t % 3;
        const int gq = gb + r + (E::kRotated ? 2 - dyi : dyi);
        const int s = gq % AB_STAGES;
        mbar_wait(bar_full + 8 * s, (gq / AB_STAGES) & 1);
        const uint64_t da = desc_sw128(
            s_ring + s * ROW + (E::kRotated ? 2 - dxi : dxi) * BOX, 16, 1024);
        const uint64_t dw = desc_sw128(s_w1 + t * BOX, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk) {
          if (E::kRotated)  // B = W1 K-major: (c rows, o along k)
            wgmma_m64n64k16_ss<0, 0>(a, da + 2 * kk, dw + 2 * kk,
                                     t > 0 || kk > 0);
          else              // B = W1 MN-major: (c rows along k, o along n)
            wgmma_m64n64k16_ss<0, 1>(a, da + 2 * kk, dw + 128 * kk,
                                     t > 0 || kk > 0);
        }
        wgmma_commit();
      }
    };
    // after row r's products: release the stages it was the last reader of
    auto retire = [&](int r) {
      mbar_arrive(bar_empty + 8 * ((gb + r) % AB_STAGES));
      mbar_arrive(bar_empty + 8 * ((gb + r + 1) % AB_STAGES));
      if (r + 2 >= R) mbar_arrive(bar_empty + 8 * ((gb + r + 2) % AB_STAGES));
    };

    mbar_wait(bar_w1, 0);
    for (int st = blockIdx.x; st < sp.total; st += gridDim.x, gb += R + 2) {
      int b, y0, x0;
      sp.decode(st, b, y0, x0);
      if (wg == 1) release(gb);
      for (int r = wg; r < R; r += 2) {
        issue(acc, r);
        wgmma_wait0();
        fence_regs(acc);
        retire(r);
        epi.row(acc, b, y0 + r, x0, sp, aux, out);
      }
      if (wg == 0) release(gb + R + 1);
    }
    epi.finish();
  }
}

// strips of 16 output rows, or fewer where that leaves SMs without a strip
inline Strips strips_of(int B, int H, int W) {
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

// one persistent CTA per SM, at most one per strip
inline int persistent_grid(const Strips& sp) {
  return std::min(sm_count(), sp.total);
}

// a (B, H, W, 64) bf16 tensor as 4-D TMA boxes of (64 channels, 64 pixels)
inline bool map_pixels(CUtensorMap* map, const void* ptr, int B, int H,
                       int W) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {C, TILE, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims,
                    strides, box);
}

// the packed (tap, c, o) bf16 W1 as 2-D boxes of one tap's (64 c, 64 o)
inline bool map_w1(CUtensorMap* map, const void* w1) {
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)TAPS * C};
  const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t box[2] = {C, C};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w1, dims,
                    strides, box);
}

// launch strip_kernel<E> over the strips of a (B, H, W, 64) input
template <class E>
int launch_strips(const CUtensorMap& m_in, const CUtensorMap& m_w1,
                  const bf16* aux, bf16* out, const typename E::Params& p,
                  const Strips& sp, cudaStream_t st) {
  constexpr int smem = ab_smem(E::kPrmBytes);
  static_assert(smem <= 232448, "strip kernel shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      strip_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  strip_kernel<E><<<persistent_grid(sp), AB_THREADS, smem, st>>>(
      m_in, m_w1, aux, out, p, sp);
  return (int)cudaGetLastError();
}

}  // namespace hop
