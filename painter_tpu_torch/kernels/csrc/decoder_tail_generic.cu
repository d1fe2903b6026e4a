// Width-generic fused decoder tail at narrow widths: forward (K3g) and
// backward (K4g) at decoder widths C <= 8, in bf16 and fp32, on the tensor
// cores (mma.sync). C >= 9 runs decoder_tail_tc_fwd.cu /
// decoder_tail_tc_bwd.cu, whose 64-channel K chunks and 64-wide warpgroup
// tiles would multiply mostly zeros here.
//
// Replaces the TPU kernels painter_tpu/kernels/decoder_head.py:_fwd_impl
// (K3g) and _bwd_impl (K4g) at the widths the kernels of
// decoder_tail_fwd.cu / decoder_tail_bwd.cu are not built for (they take
// C = 64, the presets' ViT-L width); the wrapper (kernels/decoder_head.py
// decoder_route, generic_tail_route's "narrow") sends a width here by its
// shape and type alone.
//
// Contracts: those of decoder_tail_fwd.cu and decoder_tail_bwd.cu at C
// real channels. The parameters come in their torch layouts and fp32 (conv1
// (C, C, 3, 3), the row vectors (C,), conv2 (3, C, 1, 1)); each CTA casts
// them to the input type and zero-pads them to CP = 8 channels in shared
// memory. The pixels are read unpadded (C values a pixel) and padded to 8
// in shared memory. LayerNorm runs over the real C (eps 1e-6, fp32
// statistics, the biased variance); the GELU output is rounded to the
// input type before the 1x1 conv, du before dpix and dW1; the padded
// channels of u, n, g, dn and du are held at zero. The tanh GELU runs on
// tanh.approx.f32 in bf16 (as the bf16 tails of decoder_tail_fwd.cu and
// decoder_tail_tc.cuh: g and du are rounded to bf16 next), on tanhf in
// fp32. No atomics and a fixed summation order: two runs give the same
// bits.
//
// What bounds it on an H100: bytes. Per pixel the forward reads C values
// and writes 3 and does 2 C (9 C + 3) FLOP: at C = 8 in bf16, 22 bytes
// against 1200 FLOP, 17.7 MB (5.3 us at 3.35 TB/s) against 0.96 GFLOP
// (about 1 us on the tensor cores, 14 us in fp32 FMAs) at (2, 896, 448,
// 8). The backward reads pix and go and writes dpix (2 C + 3 values a
// pixel, 9.1 us there) and does about 3x the forward's FLOP.
//
// Design (one warp computes 16 pixels x 8 channels at a time):
//   The conv3x3 is one tensor-core product with the taps packed into K:
//   M = 16 pixels of a row, K = 9 taps x 8 channels, N = 8 output
//   channels. bf16: mma.sync m16n8k16, two taps per k16 step (K padded to
//   80 by a zero tap), A gathered by ldmatrix straight from the pixel tile
//   -- each lane gives one pixel's 16-byte channel row at a tap offset, so
//   the im2col matrix is never written out. fp32: 3xTF32 mma.sync m16n8k8,
//   one tap per k8 step, A by ldmatrix of 16-byte half rows (4 fp32 each,
//   the halves of a pixel swizzled against bank conflicts) split in
//   registers into big and small tf32 parts, small terms first into a
//   zeroed accumulator that is added in registers (the tensor cores'
//   accumulation truncates). W1 stays in registers as B fragments, the
//   row vectors of the lane's two channels too.
//   In the m16n8 accumulator a pixel's 8 channels lie in the four lanes
//   of a quad, so the LayerNorm sums and mean(dxhat), mean(dxhat xhat) are
//   two xor shuffles each; in bf16 the 1x1 conv is one more product (the
//   accumulator layout of g is the A layout), in fp32 three quad sums.
//   Each warp keeps two M tiles in flight.
//   Tiles: TW = 32 output columns (two 16-pixel M tiles a row) by th rows,
//   th the most of 16, 8, 4, 2 that gives two tiles per SM (the wrapper's
//   narrow_tiling): 16 x 32 pixels at 896x448 (the pixel halo 1.2x the
//   tile), 2 x 32 at tiny_test's 64x32 (64 CTAs). The pixel tile is loaded
//   with 16-byte cp.async where C = 8 (zero-filled outside the image: the
//   SAME padding), element by element below that. Both kernels are
//   persistent: CTA i takes tiles i, i + grid, ... (the wrapper's
//   narrow_grid: as few rounds as the CTAs an SM holds allow, which
//   decoder_tail_generic_ctas_per_sm_* reads from the kernel's registers
//   and shared memory).
//   K3g: one launch of fwd_kernel: the next tile's pixels load into a
//   second buffer while this tile's are computed.
//   K4g: one launch of bwd_kernel: from a (th + 4) x (TW + 4) pixel tile
//   it recomputes the forward and du on the (th + 2) x (TW + 2) ring, so
//   du never goes to device memory (rounded to the input type into shared
//   memory, zero outside the image); then per own M tile dpix (the same
//   product on du with the taps rotated and W1 transposed) and dW1 (the
//   80 x 8 product patch^T . du over the 16 pixels, both operands by
//   ldmatrix.trans in bf16). The CTA keeps its partial sums over its
//   tiles' own pixels -- db1, dLN scale, dLN bias, dW2 and db2 in
//   registers, dW1's accumulators in its warps' rows of shared memory
//   between the dpix phases -- and writes one row of them; reduce_kernel,
//   the second launch, sums the rows in a fixed order into the gradients
//   in their torch layouts. At 128 registers a thread the backward holds
//   4 CTAs an SM; capped lower (5, 6, 8 CTAs) it spilled or ran slower.
//
// The launchers allocate nothing and do not synchronize; they return
// cudaGetLastError() so the caller can raise on a refused launch.

#include "decoder_tail_common.cuh"

namespace narrow {

typedef __nv_bfloat16 bf16;

constexpr int CP = 8;             // channels a pixel holds in shared memory
constexpr int TW = 32;            // output columns of a tile: two M tiles
constexpr int TH_MAX = 16;        // output rows of a tile at most
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TAPS = 10;          // 9 taps and a zero one (k16 steps of 2)
constexpr int FW = TW + 2;        // forward pixel tile / backward ring pitch
constexpr int PW = TW + 4;        // backward pixel tile pitch
// a CTA's row of partial sums: dW1 (tap, c, o), db1, dLN scale, dLN bias
// (c), dW2 (c, k), db2 (k)
constexpr int NPART = 9 * CP * CP + 6 * CP + 3;
constexpr int P_DB1 = 9 * CP * CP, P_DLNS = P_DB1 + CP, P_DLNB = P_DLNS + CP,
              P_DW2 = P_DLNB + CP, P_DB2 = P_DW2 + 3 * CP;
constexpr int RED_ROW = NPART + 1;  // a warp's row in red: 8-byte aligned
constexpr int RED_WARPS = 32;     // reduce_kernel: warps a column block
constexpr float LN_EPS = dtail::LN_EPS;

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

// two values as bf16 (lo in the low half): an mma.sync operand register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of 16-byte chunk h of pixel p in a tile: bf16 pixels are one
// chunk (8 channels); fp32 pixels two (channels 4h..4h + 3), swapped in
// every other group of four pixels so that the 8 rows of an ldmatrix (8
// consecutive pixels' same half) fall on distinct banks
template <typename T>
__device__ __forceinline__ uint32_t chunk(int p, int h) {
  if constexpr (sizeof(T) == 2) {
    return (uint32_t)p * 16;
  } else {
    return (uint32_t)p * 32 + ((uint32_t)(h ^ ((p >> 2) & 1)) << 4);
  }
}

// byte offset of channel c of pixel p
template <typename T>
__device__ __forceinline__ uint32_t chan(int p, int c) {
  constexpr int PER = 16 / (int)sizeof(T);
  return chunk<T>(p, c / PER) + (uint32_t)(c % PER) * sizeof(T);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes into shared memory; the bytes past `src_bytes` (0 or 16) are zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

// d += a . b, m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b, m16n8k8, tf32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// round to nearest, ties away from zero, to tf32 (as flash_relpos_tf32.cuh)
__device__ __forceinline__ uint32_t tf32_rn(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both tf32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rn(x);
  small = tf32_rn(x - __uint_as_float(big));
}

__device__ __forceinline__ void split4(const uint32_t (&x)[4],
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(x[i]), big[i], small[i]);
}

// d += a . b in 3xTF32: the small terms, then the big one, into a zeroed
// accumulator that is added to d in registers
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, as, bb[0], bb[1]);
  mma_tf32(t, ab, bs[0], bs[1]);
  mma_tf32(t, ab, bb[0], bb[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// the sum over a quad's four lanes, (v0 + v1) + (v2 + v3) in every lane
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the sum over the 8 quads of a warp (lanes of one q), in every lane
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// the GELU's flavour of tanh: tanh.approx.f32 in bf16, tanhf in fp32
template <typename T>
constexpr bool EXACT = sizeof(T) == 4;

// The parameters in shared memory, cast to the input type and zero past C
template <typename T>
struct __align__(16) Params {
  T w1[TAPS * CP * CP];  // (tap, o, c); tap 9 zero
  float b1[CP], lns[CP], lnb[CP];
  float w2[3][CP];
  float b2[4];
};

template <typename T>
__host__ __device__ constexpr size_t params_bytes() {
  return (sizeof(Params<T>) + 127) / 128 * 128;
}

// one of the forward's two pixel tiles, (th + 2) x FW
template <typename T>
__host__ __device__ constexpr size_t fwd_tile_bytes(int th) {
  return (size_t)(th + 2) * FW * sizeof(T) * CP;
}

template <typename T>
__device__ void stage_params(Params<T>& s, const float* __restrict__ w1,
                             const float* __restrict__ b1,
                             const float* __restrict__ lns,
                             const float* __restrict__ lnb,
                             const float* __restrict__ w2,
                             const float* __restrict__ b2, int C) {
  for (int i = threadIdx.x; i < TAPS * CP * CP; i += THREADS) {
    const int tap = i / (CP * CP), o = i / CP % CP, c = i % CP;
    s.w1[i] = from_f<T>(tap < 9 && o < C && c < C
                            ? __ldg(w1 + (o * C + c) * 9 + tap) : 0.f);
  }
  if (threadIdx.x < CP) {
    const int c = threadIdx.x;
    const bool in = c < C;
    s.b1[c] = in ? rounded<T>(__ldg(b1 + c)) : 0.f;
    s.lns[c] = in ? rounded<T>(__ldg(lns + c)) : 0.f;
    s.lnb[c] = in ? rounded<T>(__ldg(lnb + c)) : 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      s.w2[k][c] = in ? rounded<T>(__ldg(w2 + k * C + c)) : 0.f;
    if (c < 4) s.b2[c] = b2 != nullptr && c < 3 ? rounded<T>(__ldg(b2 + c))
                                                : 0.f;
  }
}

// this lane's channels (2q, 2q + 1) of the row vectors, in registers: the
// shared-memory copies would be read again after every ldmatrix
struct Lane {
  float b1[2], lns[2], lnb[2], w2[3][2];

  template <typename T>
  __device__ explicit Lane(const Params<T>& s) {
    const int q = threadIdx.x & 3;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      b1[e] = s.b1[2 * q + e];
      lns[e] = s.lns[2 * q + e];
      lnb[e] = s.lnb[2 * q + e];
#pragma unroll
      for (int k = 0; k < 3; ++k) w2[k][e] = s.w2[k][2 * q + e];
    }
  }
};

// rows x COLS pixels of one (H, W, C) image from (gy0, gx0) into the tile
// at dst: zero outside the image and past C. 16-byte cp.async where a
// pixel is 8 channels and the image 16-byte aligned (the caller commits
// and waits); else element by element.
template <typename T, int COLS>
__device__ void load_tile(unsigned char* dst, const T* __restrict__ img,
                          int H, int W, int C, int gy0, int gx0, int rows) {
  const int n = rows * COLS;
  if (C == CP && (reinterpret_cast<uintptr_t>(img) & 15) == 0) {
    constexpr int CH = (int)sizeof(T) * CP / 16;  // chunks a pixel: 1 or 2
    const uint32_t base = smem_u32(dst);
    for (int i = threadIdx.x; i < n * CH; i += THREADS) {
      const int p = i / CH, h = i % CH;
      const int y = gy0 + p / COLS, x = gx0 + p % COLS;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      const T* src = in ? img + ((size_t)y * W + x) * CP + h * (CP / CH)
                        : img;
      cp_async16(base + chunk<T>(p, h), src, in ? 16 : 0);
    }
  } else {
    for (int p = threadIdx.x; p < n; p += THREADS) {
      const int y = gy0 + p / COLS, x = gx0 + p % COLS;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      const T* src = in ? img + ((size_t)y * W + x) * C : img;
#pragma unroll
      for (int c = 0; c < CP; ++c)
        *reinterpret_cast<T*>(dst + chan<T>(p, c)) =
            in && c < C ? src[c] : from_f<T>(0.f);
    }
  }
}

// The conv3x3's W1 as B fragments of this lane, and the product of one M
// tile: acc (+)= A . W1 where A's row m is pixel row + m of a tile of
// PITCH pixels a row, shifted by each tap (dy, dx) by +(dy PITCH + dx), or
// by -(dy PITCH + dx) with ROT (dpix: du at the rotated taps, W1
// transposed). `row` is the pixel of this lane's ldmatrix row: m = (lane &
// 7) + 8 ((lane >> 3) & 1).
template <typename T>
struct Frags;

template <>
struct Frags<bf16> {
  uint32_t b[5][2];  // k16 step s: taps 2s (b[s][0]) and 2s + 1

  // B (k = (tap, c), n = o) = W1[o][c][tap]; transposed (k = (tap, o),
  // n = c) = W1[o][c][tap] for dpix
  __device__ void load(const bf16* w1, bool transposed) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bf16* wt = w1 + (2 * s + h) * CP * CP;
        if (!transposed) {
          b[s][h] = *reinterpret_cast<const uint32_t*>(wt + g * CP + 2 * q);
        } else {
          __nv_bfloat162 v;
          v.x = wt[(2 * q) * CP + g];
          v.y = wt[(2 * q + 1) * CP + g];
          b[s][h] = *reinterpret_cast<uint32_t*>(&v);
        }
      }
    }
  }

  template <int PITCH, bool ROT>
  __device__ __forceinline__ void conv(float (&acc)[4], uint32_t tile,
                                       int row) const {
    // this lane's ldmatrix matrix: pixels (lane >> 3) & 1 of the two
    // halves, tap 2s + (lane >> 4)
    const int half = (threadIdx.x >> 4) & 1;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int tap = min(2 * s + half, 8);  // tap 9: zero weights
      const int off = tap / 3 * PITCH + tap % 3;
      uint32_t a[4];
      ldsm_x4(a, tile + (uint32_t)(ROT ? row - off : row + off) * 16);
      mma_bf16(acc, a, b[s]);
    }
  }
};

template <>
struct Frags<float> {
  uint32_t bb[9][2], bs[9][2];  // tap t's big and small tf32 parts

  // B (k = c, n = o) = W1[o][c][tap]; transposed (k = o, n = c)
  __device__ void load(const float* w1, bool transposed) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = q + 4 * h;
        const float w = transposed ? w1[(t * CP + k) * CP + g]
                                   : w1[(t * CP + g) * CP + k];
        split(w, bb[t][h], bs[t][h]);
      }
    }
  }

  template <int PITCH, bool ROT>
  __device__ __forceinline__ void conv(float (&acc)[4], uint32_t tile,
                                       int row) const {
    // this lane's ldmatrix matrix: pixels (lane >> 3) & 1 of the two
    // halves, channels 4 (lane >> 4)..+3
    const int h = (threadIdx.x >> 4) & 1;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int off = t / 3 * PITCH + t % 3;
      uint32_t a[4], ab[4], as[4];
      ldsm_x4(a, tile + chunk<float>(ROT ? row - off : row + off, h));
      split4(a, ab, as);
      mma3(acc, ab, as, bb[t], bs[t]);
    }
  }
};

// acc[i] (+)= the dW1 product of 16 own pixels (oy, ox0 + 0..15) of a
// backward tile, M tile i = taps 2i, 2i + 1 (tap 9 discarded) x 8
// channels, n = o: A (m = (tap, c), k = pixel) the pixel tile P at the
// pixels' tap offsets, B (k = pixel, n = o) du in the ring D
template <typename T>
__device__ void dw1_product(float (&acc)[5][4], const unsigned char* P,
                            const unsigned char* D, int oy, int ox0);

template <>
__device__ void dw1_product<bf16>(float (&acc)[5][4], const unsigned char* P,
                                  const unsigned char* D, int oy, int ox0) {
  const int lane = threadIdx.x & 31, j = lane >> 3;
  // ldmatrix.trans matrices: (tap 2i, pixels 0-7), (2i + 1, 0-7),
  // (2i, 8-15), (2i + 1, 8-15)
  const int pixel = (lane & 7) + 8 * (j >> 1), odd = j & 1;
  uint32_t b[2];
  ldsm_x2_t(b, smem_u32(D) +
                   (uint32_t)((oy + 1) * FW + ox0 + 1 + (lane & 15)) * 16);
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int tap = min(2 * i + odd, 8);
    const int p = (oy + 1 + tap / 3) * PW + ox0 + 1 + tap % 3 + pixel;
    uint32_t a[4];
    ldsm_x4_t(a, smem_u32(P) + (uint32_t)p * 16);
    mma_bf16(acc[i], a, b);
  }
}

__device__ __forceinline__ float lds_f(const unsigned char* tile, int p,
                                       int c) {
  return *reinterpret_cast<const float*>(tile + chan<float>(p, c));
}

template <>
__device__ void dw1_product<float>(float (&acc)[5][4],
                                   const unsigned char* P,
                                   const unsigned char* D, int oy, int ox0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float d[5][4] = {};
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int px = ox0 + 8 * kk + q;  // k = q; k = q + 4 is px + 4
    uint32_t bb[2], bs[2];
    const int dr = (oy + 1) * FW + px + 1;
    split(lds_f(D, dr, g), bb[0], bs[0]);
    split(lds_f(D, dr + 4, g), bb[1], bs[1]);
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int t0 = 2 * i, t1 = min(2 * i + 1, 8);
      const int p0 = (oy + 1 + t0 / 3) * PW + px + 1 + t0 % 3;
      const int p1 = (oy + 1 + t1 / 3) * PW + px + 1 + t1 % 3;
      uint32_t a[4] = {__float_as_uint(lds_f(P, p0, g)),
                       __float_as_uint(lds_f(P, p1, g)),
                       __float_as_uint(lds_f(P, p0 + 4, g)),
                       __float_as_uint(lds_f(P, p1 + 4, g))};
      uint32_t ab[4], as[4];
      split4(a, ab, as);
      mma3(d[i], ab, as, bb, bs);
    }
  }
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += d[i][e];
}

// LayerNorm statistics of one pixel held by a quad (u: channels 2q, 2q + 1
// of this lane, b1 added): u centred (zero past C); returns rstd. inv_c =
// 1 / C, rounded once
__device__ __forceinline__ float ln_stats(float (&u)[2], int C, float inv_c,
                                          int q) {
  const bool m0 = 2 * q < C, m1 = 2 * q + 1 < C;
  const float mean =
      quad_sum((m0 ? u[0] : 0.f) + (m1 ? u[1] : 0.f)) * inv_c;
  u[0] = m0 ? u[0] - mean : 0.f;
  u[1] = m1 ? u[1] - mean : 0.f;
  // the variance plus eps is never subnormal: the approximation alone
  const float v = quad_sum(u[0] * u[0] + u[1] * u[1]) * inv_c + LN_EPS;
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// K3g: persistent, CTA i takes tiles i, i + grid, ...; the next tile's
// pixels load into the other buffer while this one's are computed; a warp
// takes a tile row (its two M tiles) at a time
template <typename T, bool APPROX>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ pix, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ lns,
           const float* __restrict__ lnb, const float* __restrict__ w2,
           const float* __restrict__ b2, T* __restrict__ out, int B, int H,
           int W, int C, int th) {
  extern __shared__ __align__(128) unsigned char smem[];
  Params<T>& prm = *reinterpret_cast<Params<T>*>(smem);
  unsigned char* const buf0 = smem + params_bytes<T>();
  const size_t buf_bytes = fwd_tile_bytes<T>(th);  // two buffers
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + th - 1) / th;
  const int ntiles = tiles_x * tiles_y * B;
  const float inv_c = 1.f / C;
  auto load = [&](unsigned char* dst, int t) {
    const int x0 = t % tiles_x * TW, y0 = t / tiles_x % tiles_y * th;
    const int b = t / (tiles_x * tiles_y);
    load_tile<T, FW>(dst, pix + (size_t)b * H * W * C, H, W, C, y0 - 1,
                     x0 - 1, th + 2);
    cp_async_commit();
  };
  stage_params<T>(prm, w1, b1, lns, lnb, w2, b2, C);
  if ((int)blockIdx.x < ntiles) load(buf0, blockIdx.x);
  __syncthreads();  // the parameters

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1);
  Frags<T> f;
  f.load(prm.w1, false);
  const Lane ln(prm);
  // bf16: W2 as the B fragment of the 1x1 conv (k = c, n = output
  // channel); b2 of the outputs this lane stores
  const uint32_t w2f[2] = {
      g < 3 ? pack_bf16(prm.w2[g][2 * q], prm.w2[g][2 * q + 1]) : 0u, 0u};
  const float b2q[2] = {prm.b2[sizeof(T) == 2 ? min(2 * q, 3) : q],
                        prm.b2[1]};
  int i = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
    if (t + (int)gridDim.x < ntiles) {
      load(buf0 + ((i + 1) & 1) * buf_bytes, t + gridDim.x);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's pixels
    const uint32_t tile = smem_u32(buf0 + (i & 1) * buf_bytes);
    const int x0 = t % tiles_x * TW, y0 = t / tiles_x % tiles_y * th;
    const int b = t / (tiles_x * tiles_y);
    for (int oy = warp; oy < th && y0 + oy < H; oy += WARPS) {
      // this lane's output pixel (y0 + oy, x0 + g), its first value
      T* const orow = out + (((size_t)b * H + y0 + oy) * W + x0 + g) * 3;
      float acc[2][4] = {};
#pragma unroll
      for (int m = 0; m < 2; ++m)
        f.template conv<FW, false>(acc[m], tile, oy * FW + 16 * m + arow);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // rows g + 8 hh, channels 2q + e; rounded to bf16 by the packing
        // for the product (fp32 takes them as they are)
        float gl[2][2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float u[2] = {acc[m][2 * hh] + ln.b1[0],
                        acc[m][2 * hh + 1] + ln.b1[1]};
          const float rstd = ln_stats(u, C, inv_c, q);
#pragma unroll
          for (int e = 0; e < 2; ++e)
            gl[hh][e] = dtail::gelu<APPROX, EXACT<T>>(
                u[e] * rstd * ln.lns[e] + ln.lnb[e]);
        }
        const int x = x0 + 16 * m + g;
        if constexpr (sizeof(T) == 2) {
          // the 1x1 conv as one more product: the accumulator layout of
          // g is the A layout (k = channel), B = W2 (k = c, n = output
          // channel): lanes q 0 and 1 get outputs 2q, 2q + 1
          const uint32_t a[4] = {pack_bf16(gl[0][0], gl[0][1]),
                                 pack_bf16(gl[1][0], gl[1][1]), 0u, 0u};
          float o[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(o, a, w2f);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            if (q < 2 && x + 8 * hh < W) {
              T* dst = orow + (16 * m + 8 * hh) * 3 + 2 * q;
              dst[0] = from_f<T>(o[2 * hh] + b2q[0]);
              if (q == 0) dst[1] = from_f<T>(o[2 * hh + 1] + b2q[1]);
            }
          }
        } else {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float o[3];
#pragma unroll
            for (int k = 0; k < 3; ++k)
              o[k] = quad_sum(gl[hh][0] * ln.w2[k][0] +
                              gl[hh][1] * ln.w2[k][1]);
            if (q < 3 && x + 8 * hh < W) {
              const float v = q == 0 ? o[0] : q == 1 ? o[1] : o[2];
              orow[(16 * m + 8 * hh) * 3 + q] = from_f<T>(v + b2q[0]);
            }
          }
        }
      }
    }
    __syncthreads();  // this buffer is read before the load two tiles on
  }
}

// K4g's tiles and CTAs: the pixel tile P ((th + 4) x PW), du on the ring D
// ((th + 2) x FW, the input type), go on the ring G (float4), the warps'
// partial rows
template <typename T>
__host__ __device__ constexpr size_t bwd_p_bytes(int th) {
  return (size_t)(th + 4) * PW * sizeof(T) * CP;
}
template <typename T>
__host__ __device__ constexpr size_t bwd_d_bytes(int th) {
  return (size_t)(th + 2) * FW * sizeof(T) * CP;
}
template <typename T>
__host__ __device__ constexpr size_t bwd_smem_bytes(int th) {
  return params_bytes<T>() + bwd_p_bytes<T>(th) + bwd_d_bytes<T>(th) +
         (size_t)(th + 2) * FW * 16 + (size_t)WARPS * RED_ROW * 4;
}

// dW1's accumulators of this lane (M tile i = taps 2i, 2i + 1; rows g, g +
// 8; o 2q, 2q + 1) from (LOAD) or into its warp's row of red, (tap, c, o);
// tap 9's rows are none of dW1's: zero, and dropped
template <bool LOAD>
__device__ __forceinline__ void dw1_acc(float (&aw1)[5][4], float* rw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int tap = 2 * i + hh;
      float2* at =
          reinterpret_cast<float2*>(rw + (tap * CP + g) * CP + 2 * q);
      if (tap == 9) {
        if (LOAD) aw1[i][2 * hh] = aw1[i][2 * hh + 1] = 0.f;
      } else if (LOAD) {
        const float2 v = *at;
        aw1[i][2 * hh] = v.x;
        aw1[i][2 * hh + 1] = v.y;
      } else {
        *at = make_float2(aw1[i][2 * hh], aw1[i][2 * hh + 1]);
      }
    }
}

// go (3 a pixel) of rows x FW ring pixels from (gy0, gx0) into G, zero
// outside the image
template <typename T>
__device__ void load_go(float4* G, const T* __restrict__ go, int H, int W,
                        int gy0, int gx0, int rows) {
  for (int p = threadIdx.x; p < rows * FW; p += THREADS) {
    const int y = gy0 + p / FW, x = gx0 + p % FW;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const T* s = go + ((size_t)y * W + x) * 3;
      v.x = to_f(s[0]);
      v.y = to_f(s[1]);
      v.z = to_f(s[2]);
    }
    G[p] = v;
  }
}

// K4g: dpix, and one row of partial sums per CTA (part, NPART a row).
// Persistent: CTA i takes tiles i, i + grid, ...
template <typename T, bool APPROX>
__global__ void __launch_bounds__(THREADS, 4)
bwd_kernel(const T* __restrict__ pix, const T* __restrict__ go,
           const float* __restrict__ w1, const float* __restrict__ b1,
           const float* __restrict__ lns, const float* __restrict__ lnb,
           const float* __restrict__ w2, T* __restrict__ dpix,
           float* __restrict__ part, int B, int H, int W, int C, int th) {
  extern __shared__ __align__(128) unsigned char smem[];
  Params<T>& prm = *reinterpret_cast<Params<T>*>(smem);
  unsigned char* P = smem + params_bytes<T>();
  unsigned char* D = P + bwd_p_bytes<T>(th);
  float4* G = reinterpret_cast<float4*>(D + bwd_d_bytes<T>(th));
  float* red = reinterpret_cast<float*>(G + (th + 2) * FW);
  stage_params<T>(prm, w1, b1, lns, lnb, w2, nullptr, C);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + th - 1) / th;
  const int ntiles = tiles_x * tiles_y * B;
  const int nring = (th + 2) * FW;
  // this lane's partial sums over its tiles' own pixels: for channels 2q,
  // 2q + 1 db1, dLN scale, dLN bias, dW2 (c, k), db2 (k) in registers;
  // dW1's accumulators in the warp's row of red between the dpix phases
  // (in registers they would crowd the ring phase)
  float sdb1[2] = {}, sdlns[2] = {}, sdlnb[2] = {}, sdw2[2][3] = {},
        sdb2[3] = {};
  float* rw = red + warp * RED_ROW;
  for (int j = lane; j < P_DB1; j += 32) rw[j] = 0.f;
  const float inv_c = 1.f / C;
  __syncthreads();  // the parameters
  const Lane ln(prm);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int x0 = t % tiles_x * TW, y0 = t / tiles_x % tiles_y * th;
    const int b = t / (tiles_x * tiles_y);
    __syncthreads();  // the last tile's readers are done
    load_tile<T, PW>(P, pix + (size_t)b * H * W * C, H, W, C, y0 - 2,
                     x0 - 2, th + 4);
    cp_async_commit();
    load_go<T>(G, go + (size_t)b * H * W * 3, H, W, y0 - 1, x0 - 1, th + 2);
    cp_async_wait<0>();
    __syncthreads();

    // du on the ring, two M tiles (ring pixels 16 mt ..) at a time: the
    // forward recomputed, then the LayerNorm backward
    {
      Frags<T> f;
      f.load(prm.w1, false);
      for (int pr = warp; 32 * pr < nring; pr += WARPS) {
        float acc[2][4] = {};
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int r = min((2 * pr + m) * 16 + arow, nring - 1);
          f.template conv<PW, false>(acc[m], smem_u32(P),
                                     r / FW * PW + r % FW);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int rp = (2 * pr + m) * 16 + g + 8 * hh;
            const int ry = rp / FW, rx = rp % FW;
            const int y = y0 - 1 + ry, x = x0 - 1 + rx;
            const bool in = rp < nring && y >= 0 && y < H && x >= 0 && x < W;
            const float4 gv = G[min(rp, nring - 1)];
            float u[2] = {acc[m][2 * hh] + ln.b1[0],
                          acc[m][2 * hh + 1] + ln.b1[1]};
            const float rstd = ln_stats(u, C, inv_c, q);
            float xh[2], dn[2], dx[2], gl[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              xh[e] = u[e] * rstd;
              float gd;
              dtail::gelu_and_grad<APPROX, EXACT<T>>(
                  xh[e] * ln.lns[e] + ln.lnb[e], gl[e], gd);
              gl[e] = rounded<T>(gl[e]);
              const float dg = gv.x * ln.w2[0][e] + gv.y * ln.w2[1][e] +
                               gv.z * ln.w2[2][e];
              dn[e] = dg * gd;
              dx[e] = dn[e] * ln.lns[e];
            }
            const float mx = quad_sum(dx[0] + dx[1]) * inv_c;
            const float mxx = quad_sum(dx[0] * xh[0] + dx[1] * xh[1]) * inv_c;
            float du[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              du[e] = in && 2 * q + e < C
                          ? rstd * (dx[e] - mx - xh[e] * mxx) : 0.f;
            if (in && ry >= 1 && ry <= th && rx >= 1 && rx <= TW) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                sdb1[e] += du[e];
                sdlns[e] += dn[e] * xh[e];
                sdlnb[e] += dn[e];
                sdw2[e][0] += gl[e] * gv.x;
                sdw2[e][1] += gl[e] * gv.y;
                sdw2[e][2] += gl[e] * gv.z;
              }
              sdb2[0] += gv.x;
              sdb2[1] += gv.y;
              sdb2[2] += gv.z;
            }
            if (rp < nring) {
              unsigned char* dst = D + chan<T>(rp, 2 * q);
              if constexpr (sizeof(T) == 2) {
                *reinterpret_cast<uint32_t*>(dst) = pack_bf16(du[0], du[1]);
              } else {
                *reinterpret_cast<float2*>(dst) = make_float2(du[0], du[1]);
              }
            }
          }
      }
    }
    __syncthreads();

    // dpix and dW1, a tile row (two M tiles) at a time
    {
      Frags<T> f;
      f.load(prm.w1, true);
      float aw1[5][4];
      dw1_acc<true>(aw1, rw);
      for (int oy = warp; oy < th && y0 + oy < H; oy += WARPS) {
        // this lane's dpix pixel (y0 + oy, x0 + g), its channel 2q
        T* const drow = dpix + (((size_t)b * H + y0 + oy) * W + x0 + g) * C +
                        2 * q;
        float acc[2][4] = {};
#pragma unroll
        for (int m = 0; m < 2; ++m)
          f.template conv<FW, true>(acc[m], smem_u32(D),
                                    (oy + 2) * FW + 16 * m + 2 + arow);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            if (x0 + 16 * m + g + 8 * hh >= W) continue;
            T* dst = drow + (16 * m + 8 * hh) * C;
            if (C == CP) {  // one 4-byte (bf16) or 8-byte (fp32) store
              if constexpr (sizeof(T) == 2) {
                *reinterpret_cast<uint32_t*>(dst) =
                    pack_bf16(acc[m][2 * hh], acc[m][2 * hh + 1]);
              } else {
                *reinterpret_cast<float2*>(dst) =
                    make_float2(acc[m][2 * hh], acc[m][2 * hh + 1]);
              }
            } else {
              if (2 * q < C) dst[0] = from_f<T>(acc[m][2 * hh]);
              if (2 * q + 1 < C) dst[1] = from_f<T>(acc[m][2 * hh + 1]);
            }
          }
#pragma unroll
        for (int m = 0; m < 2; ++m) dw1_product<T>(aw1, P, D, oy, 16 * m);
      }
      dw1_acc<false>(aw1, rw);
    }
  }

  // this CTA's row: each warp's partials in red (dW1 there already, the
  // small ones summed over its quads), then the warps' in order
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float v1 = column_sum(sdb1[e]), v2 = column_sum(sdlns[e]),
                v3 = column_sum(sdlnb[e]);
    float v4[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) v4[k] = column_sum(sdw2[e][k]);
    if (g == 0) {
      const int c = 2 * q + e;
      rw[P_DB1 + c] = v1;
      rw[P_DLNS + c] = v2;
      rw[P_DLNB + c] = v3;
#pragma unroll
      for (int k = 0; k < 3; ++k) rw[P_DW2 + c * 3 + k] = v4[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float v = column_sum(sdb2[k]);
    if (lane == 0) rw[P_DB2 + k] = v;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < NPART; j += THREADS) {
    float s = red[j];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[w * RED_ROW + j];
    part[(size_t)blockIdx.x * NPART + j] = s;
  }
}

// the column of a partial row that gradient j sums: the gradients are
// dW1 (o, c, 3, 3), db1, dLN scale, dLN bias (C), dW2 (3, C), db2 (3)
__device__ __forceinline__ int part_col(int j, int C) {
  if (j < 9 * C * C) {
    const int o = j / (9 * C), c = j / 9 % C, tap = j % 9;
    return (tap * CP + c) * CP + o;
  }
  j -= 9 * C * C;
  if (j < 3 * C) return P_DB1 + j / C * CP + j % C;
  j -= 3 * C;
  if (j < 3 * C) return P_DW2 + j % C * 3 + j / C;
  return P_DB2 + j - 3 * C;
}

// K4g's second launch: grads[j] = the sum of column part_col(j) over the
// rows of part, in a fixed order: warp w of a CTA adds rows w, w + 32, ...
// in order, then the 32 warps' sums are added in order
__global__ void __launch_bounds__(32 * RED_WARPS)
reduce_kernel(const float* __restrict__ part, float* __restrict__ grads,
              int rows, int C) {
  __shared__ float sums[RED_WARPS][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = 9 * C * C + 6 * C + 3;
  const int j = blockIdx.x * 32 + lane;
  const int col = j < n ? part_col(j, C) : 0;
  float s = 0.f;
#pragma unroll 8
  for (int r = warp; r < rows; r += RED_WARPS)
    s += __ldg(part + (size_t)r * NPART + col);
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < n) {
    float t = sums[0][lane];
#pragma unroll
    for (int w = 1; w < RED_WARPS; ++w) t += sums[w][lane];
    grads[j] = t;
  }
}

int n_tiles(int B, int H, int W, int th) {
  return (W + TW - 1) / TW * ((H + th - 1) / th) * B;
}

bool bad_shape(int B, int H, int W, int C, int th) {
  return B < 1 || H < 1 || W < 1 || C < 1 || C > CP || th < 1 ||
         th > TH_MAX;
}

template <typename T, bool APPROX>
int launch_fwd(const void* pix, const void* w1, const void* b1,
               const void* lns, const void* lnb, const void* w2,
               const void* b2, void* out, int B, int H, int W, int C, int th,
               int grid, cudaStream_t st) {
  const size_t smem = params_bytes<T>() + 2 * fwd_tile_bytes<T>(th);
  fwd_kernel<T, APPROX><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(pix), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(out), B, H, W, C, th);
  return (int)cudaGetLastError();
}

template <typename T, bool APPROX>
int launch_bwd(const void* pix, const void* go, const void* w1,
               const void* b1, const void* lns, const void* lnb,
               const void* w2, void* dpix, void* part, void* grads, int B,
               int H, int W, int C, int th, int grid, cudaStream_t st) {
  // past 48 KB of dynamic shared memory a kernel has to opt in (fp32)
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<T, APPROX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bwd_smem_bytes<T>(th));
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<T, APPROX><<<grid, THREADS, bwd_smem_bytes<T>(th), st>>>(
      static_cast<const T*>(pix), static_cast<const T*>(go),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(lns), static_cast<const float*>(lnb),
      static_cast<const float*>(w2), static_cast<T*>(dpix),
      static_cast<float*>(part), B, H, W, C, th);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = 9 * C * C + 6 * C + 3;
  reduce_kernel<<<(n + 31) / 32, 32 * RED_WARPS, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(grads), grid, C);
  return (int)cudaGetLastError();
}

// the CTAs of the forward (bwd 0) or backward kernel at th rows a tile
// that one SM holds at once, into *ctas
template <typename T, bool APPROX>
int occupancy(int bwd, int th, int* ctas) {
  if (!bwd)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, fwd_kernel<T, APPROX>, THREADS,
        params_bytes<T>() + 2 * fwd_tile_bytes<T>(th));
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<T, APPROX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bwd_smem_bytes<T>(th));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, bwd_kernel<T, APPROX>, THREADS, bwd_smem_bytes<T>(th));
}

template <typename T>
int ctas_per_sm(int bwd, int th, int approx, int* ctas) {
  if (th < 1 || th > TH_MAX) return (int)cudaErrorInvalidValue;
  const int err = approx ? occupancy<T, true>(bwd, th, ctas)
                         : occupancy<T, false>(bwd, th, ctas);
  return err == 0 && *ctas < 1 ? (int)cudaErrorInvalidConfiguration : err;
}

template <typename T>
int fwd(const void* pix, const void* w1, const void* b1, const void* lns,
        const void* lnb, const void* w2, const void* b2, void* out, int B,
        int H, int W, int C, int th, int grid, int approx, void* stream) {
  if (bad_shape(B, H, W, C, th) || grid < 1 ||
      grid > n_tiles(B, H, W, th))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return approx ? launch_fwd<T, true>(pix, w1, b1, lns, lnb, w2, b2, out, B,
                                      H, W, C, th, grid, st)
                : launch_fwd<T, false>(pix, w1, b1, lns, lnb, w2, b2, out, B,
                                       H, W, C, th, grid, st);
}

template <typename T>
int bwd(const void* pix, const void* go, const void* w1, const void* b1,
        const void* lns, const void* lnb, const void* w2, void* dpix,
        void* part, void* grads, int B, int H, int W, int C, int th,
        int grid, int approx, void* stream) {
  if (bad_shape(B, H, W, C, th) || grid < 1 ||
      grid > n_tiles(B, H, W, th))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return approx ? launch_bwd<T, true>(pix, go, w1, b1, lns, lnb, w2, dpix,
                                      part, grads, B, H, W, C, th, grid, st)
                : launch_bwd<T, false>(pix, go, w1, b1, lns, lnb, w2, dpix,
                                       part, grads, B, H, W, C, th, grid,
                                       st);
}

}  // namespace narrow

extern "C" {

// pix (B, H, W, C) and out (B, H, W, 3) in the input type, C <= 8; the
// parameters fp32 in their torch layouts: w1 (C, C, 3, 3), b1, lns, lnb
// (C,), w2 (3, C), b2 (3,). th: output rows of a tile (1..16); the tiles
// (ceil(W / 32) ceil(H / th) B) go to `grid` persistent CTAs (1 <= grid
// <= the tiles).
int decoder_tail_generic_fwd_bf16(const void* pix, const void* w1,
                                  const void* b1, const void* lns,
                                  const void* lnb, const void* w2,
                                  const void* b2, void* out, int B, int H,
                                  int W, int C, int th, int grid, int approx,
                                  void* stream) {
  return narrow::fwd<narrow::bf16>(pix, w1, b1, lns, lnb, w2, b2, out, B, H,
                                   W, C, th, grid, approx, stream);
}

int decoder_tail_generic_fwd_f32(const void* pix, const void* w1,
                                 const void* b1, const void* lns,
                                 const void* lnb, const void* w2,
                                 const void* b2, void* out, int B, int H,
                                 int W, int C, int th, int grid, int approx,
                                 void* stream) {
  return narrow::fwd<float>(pix, w1, b1, lns, lnb, w2, b2, out, B, H, W, C,
                            th, grid, approx, stream);
}

// go (B, H, W, 3) and dpix (B, H, W, C) in the input type; part (grid,
// NPART) fp32 scratch, one row a CTA of the persistent grid (1 <= grid <=
// the tiles); grads fp32 (9 C C + 6 C + 3): dW1 (C, C, 3, 3), db1, dLN
// scale, dLN bias, dW2 (3, C), db2 (3)
int decoder_tail_generic_bwd_bf16(const void* pix, const void* go,
                                  const void* w1, const void* b1,
                                  const void* lns, const void* lnb,
                                  const void* w2, void* dpix, void* part,
                                  void* grads, int B, int H, int W, int C,
                                  int th, int grid, int approx,
                                  void* stream) {
  return narrow::bwd<narrow::bf16>(pix, go, w1, b1, lns, lnb, w2, dpix,
                                   part, grads, B, H, W, C, th, grid, approx,
                                   stream);
}

int decoder_tail_generic_bwd_f32(const void* pix, const void* go,
                                 const void* w1, const void* b1,
                                 const void* lns, const void* lnb,
                                 const void* w2, void* dpix, void* part,
                                 void* grads, int B, int H, int W, int C,
                                 int th, int grid, int approx,
                                 void* stream) {
  return narrow::bwd<float>(pix, go, w1, b1, lns, lnb, w2, dpix, part,
                            grads, B, H, W, C, th, grid, approx, stream);
}

// the persistent CTAs an SM holds of the forward (bwd 0) or backward
// kernel at th rows a tile (1..16), into *ctas (the wrapper's grid)
int decoder_tail_generic_ctas_per_sm_bf16(int bwd, int th, int approx,
                                          int* ctas) {
  return narrow::ctas_per_sm<narrow::bf16>(bwd, th, approx, ctas);
}

int decoder_tail_generic_ctas_per_sm_f32(int bwd, int th, int approx,
                                         int* ctas) {
  return narrow::ctas_per_sm<float>(bwd, th, approx, ctas);
}

const char* decoder_tail_generic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
