// The width-generic decoder tail on Hopper's tensor cores: K3g / K4g in
// bf16 at C >= 9 but 64, and the fp32 tail at every C >= 9 (K3 / K4's fp32
// route at C = 64 included) in 3xTF32. The shared pieces of
// decoder_tail_tc_fwd.cu and decoder_tail_tc_bwd.cu.
//
// The conv3x3 is an implicit GEMM on wgmma (fp32 accumulate) fed by TMA:
//   M  a unit: 64 output pixels of one image row (x0 .. x0 + 63);
//   N  the output channels, NW = 64, 128, 192 or 256 a warpgroup (fp32: 64
//      or 128);
//   K  9 taps x the input channels in 128-byte chunks (KCH = 64 bf16 or 32
//      fp32 channels), tap major. A (tap, chunk) step reads one pixel box
//      of the 4-D (C, W, H, B) map at (chunk, x0 + dx - 1, y + dy - 1, b),
//      whose zero fill is both the SAME padding and the channel padding
//      (channels past the tensor's CD read as zero), and one W1 slab of the
//      packed (tap, row, KCH channels) weights, both with 128-byte swizzle.
//      The slabs stream through the ring beside the pixel boxes: W1 is 9 CD^2
//      values (1.2 MB in bf16 at C = 256; 288 KiB split in fp32 at C = 64),
//      past shared memory.
// bf16: each step is KCH / 16 wgmma m64nNWk16, A and B from shared memory,
// summed in the tensor cores' accumulator over the whole K.
// fp32 (3xTF32, the split and products of flash_relpos_tf32.cuh): the packing
// launch writes W1 pre-split into big and small tf32 parts (two slabs a
// step, K-major as tf32 wgmma needs them); each consumer thread loads its
// A fragments from the pixel box (K-major: NHWC's channels are K) and splits
// them in registers; a step is 4 k8 x 3 wgmma m64nNWk8 (A from registers:
// all small terms, then the big ones) into an accumulator zeroed by the
// step's first product, waited for and added into fp32 register totals.
// The tensor cores' fp32 accumulation truncates (the fp32 attention kernels
// drifted ~1e-5 toward zero over ~600 products); a step adds 96 terms.
// NW stops at 128 in fp32: accumulator and totals are 2 x NW / 2 registers.
// One persistent CTA per SM walks work items in a static order; a producer
// warp keeps TMA loads in flight through a ring of stages (as many as fit
// beside the epilogue's shared memory), two consumer warpgroups issue the
// wgmma. Three modes, chosen on the host by the width and the unit count:
//   whole rows (split 0): an item is two units, one a warpgroup, each
//      warpgroup the whole row of N = NW >= C channels (C <= 256 in bf16:
//      m64n256 keeps 128 fp32 accumulators a thread; C <= 128 in fp32); the
//      W1 slab of a step serves both units (128 pixels per slab).
//   split rows (split 1): an item is one unit, warpgroup w its channels
//      [w NW, (w + 1) NW): past the whole-rows width (C <= 2 NW max), and
//      wherever whole rows would leave SMs without an item (tiny_test's
//      (2, 64, 32) has 128 units). A pixel's LayerNorm sums and output dots
//      are exchanged between the two warpgroups through shared memory (named
//      barrier 1), each total summed as wg0 + wg1 on both sides.
//   N tiles (C > MAX_ROW_C: 512 in bf16, 256 in fp32; split rows of the
//      widest NW): an item is one unit and one tile of 2 NW output channels.
//      A pixel's row no longer fits two warpgroups' registers, so the
//      epilogue writes u = conv + b1 to an fp32 (B, H, W, CD) scratch (each
//      quad row's 8 channels a 32-byte sector) and a row kernel, one warp a
//      pixel, runs the LayerNorm and what follows it (decoder_tail_tc_fwd.cu
//      / _bwd.cu).
// Every epilogue works on the accumulator fragments: a pixel's channels of
// a warpgroup lie in the four threads of one quad, so a channel sum is a
// thread's NW / 4 values and two shuffles. No atomics, a static schedule
// and fixed summation orders: two runs give the same bits.
#pragma once

#include <algorithm>
#include <type_traits>

#include "decoder_tail_common.cuh"
#include "flash_relpos_tf32.cuh"
#include "hopper.cuh"

namespace tc {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int TILE = 64;             // pixels per unit
constexpr int KCH = 64;              // bf16 input channels per K chunk (128 B)
constexpr int BOX = TILE * 128;      // a (64 pixels, 128 bytes) box
constexpr int TAPS = 9;
constexpr int THREADS = 384;         // 2 consumer warpgroups + 1 producer
constexpr int CONSUMERS = 256;
constexpr int SMEM_MAX = 232448;
constexpr int BAR_BYTES = 256;       // ring barriers (at most 16 stages)
constexpr int MAX_STAGES = 8;
constexpr int MAX_ROW_C = 512;       // two warpgroups of m64n256
constexpr float LN_EPS = dtail::LN_EPS;

// per type: channels per 128-byte K chunk, W1 parts (fp32: big and small
// tf32), the widest warpgroup N, and the widest C of whole rows and of
// split rows (past it: N tiles)
template <class T>
struct Ty;
template <>
struct Ty<bf16> {
  static constexpr int KCH = 64, PARTS = 1, NW_MAX = 256, WHOLE_C = 256,
                       ROW_C = MAX_ROW_C;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Ty<float> {
  static constexpr int KCH = 32, PARTS = 2, NW_MAX = 128, WHOLE_C = 128,
                       ROW_C = 256;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <class T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

// --- the packed parameters ----------------------------------------------------
// One buffer of the input type written by decoder_tail_tc_pack, every part
// zero-padded to CD = C rounded up to 8 (TMA's 16-byte row strides), W1 in
// `parts` planes of 9 (fp32: big, then small tf32 parts, each rounded to
// nearest with ties away as cvt.rna.tf32.f32 rounds):
//   W1P (parts, 9, CD, CD) = (tap, o, c): the forward's and du's B, K-major
//   W1T (parts, 9, CD, CD) = (tap, c, o): dpix's B, K-major
//   b1, LN scale, LN bias (CD each), W2 (CD, 3) = (c, k), b2 (3)
__host__ __device__ inline size_t off_w1t(int cd, int parts = 1) {
  return (size_t)9 * cd * cd * parts;
}
__host__ __device__ inline size_t off_b1(int cd, int parts = 1) {
  return (size_t)18 * cd * cd * parts;
}
__host__ __device__ inline size_t off_lns(int cd, int parts = 1) {
  return off_b1(cd, parts) + cd;
}
__host__ __device__ inline size_t off_lnb(int cd, int parts = 1) {
  return off_b1(cd, parts) + 2 * cd;
}
__host__ __device__ inline size_t off_w2(int cd, int parts = 1) {
  return off_b1(cd, parts) + 3 * cd;
}
__host__ __device__ inline size_t off_b2(int cd, int parts = 1) {
  return off_b1(cd, parts) + 6 * cd;
}
__host__ __device__ inline size_t packed_size(int cd, int parts = 1) {
  return off_b2(cd, parts) + 3;
}

// --- wgmma m64nNk16 bf16 (N = 64, 128, 192, 256), A and B in shared memory,
// picked by the accumulator's size (hopper.cuh's wrappers); TA / TB = 1
// reads A / B MN-major, 0 K-major
template <int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db,
                                    int acc) {
  wgmma_m64n64k16_ss<TA, TB>(d, da, db, acc);
}
template <int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                                    int acc) {
  wgmma_m64n128k16_ss<TA, TB>(d, da, db, acc);
}
template <int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[96], uint64_t da, uint64_t db,
                                    int acc) {
  wgmma_m64n192k16_ss<TA, TB>(d, da, db, acc);
}
template <int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db,
                                    int acc) {
  wgmma_m64n256k16_ss<TA, TB>(d, da, db, acc);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// the two consumer warpgroups' named barrier
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// quad (the four threads of one accumulator row) sum: every lane of the
// quad ends with the same bits
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// sum over a warp's 32 lanes: every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// the GELU output as the contract rounds it: to bf16 in bf16, not in fp32
__device__ __forceinline__ float round_as(float x, const bf16*) {
  return bf16_round(x);
}
__device__ __forceinline__ float round_as(float x, const float*) { return x; }

// gelu and its derivative as the other tails take them (tanhf in fp32,
// tanh.approx.f32 in bf16, whose result is rounded to bf16 next)
using dtail::gelu;
using dtail::gelu_and_grad;

// v[h][k] += the other warpgroup's v[h][k] for this thread's rows row0 and
// row0 + 8 (split mode): written to xch[buf] by lane tq 0, read after the
// consumers' barrier. Alternate buffers need one barrier an exchange: a
// warpgroup reaches exchange n + 2's write only after barrier n + 1, which
// the other passes only after its read of exchange n. a + b == b + a, so
// both warpgroups end with the same bits.
template <int K>
__device__ __forceinline__ void exchange(float (&v)[2][K], float* xch,
                                         int& buf, int wg, int row0, int tq) {
  float* mine = xch + (buf * 2 + wg) * 64 * 4;
  const float* other = xch + (buf * 2 + (wg ^ 1)) * 64 * 4;
  if (tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < K; ++k) mine[(row0 + 8 * h) * 4 + k] = v[h][k];
  }
  consumers_sync();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < K; ++k) v[h][k] += other[(row0 + 8 * h) * 4 + k];
  buf ^= 1;
}
constexpr int XCH_BYTES = 2 * 2 * 64 * 4 * 4;

template <int K>
__device__ __forceinline__ void quad_sums(float (&v)[2][K]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < K; ++k) v[h][k] = quad_sum(v[h][k]);
}

// LayerNorm of a unit's rows on the fragments, in place: acc (the conv)
// + b1 -> xhat over the real C (mean and the centred variance over c < C,
// each a quad sum, exchanged in split mode); padded channels come out 0.
// Element i = 4 j + 2 h + e is channel n0 + 8 j + 2 tq + e of row h; B1
// points at channel n0; lim = C - n0 - 2 tq (element (j, e) is real iff
// 8 j + e < lim). Returns rstd per row.
template <int NW>
__device__ __forceinline__ void layer_norm(float (&acc)[NW / 2],
                                           const float* B1, int C, int lim,
                                           bool split, float* xch, int& buf,
                                           int wg, int row0, int tq,
                                           float (&rstd)[2]) {
  float s[2][1] = {{0.f}, {0.f}};
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(B1 + 8 * j + 2 * tq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[4 * j + 2 * h] += bb.x;
      acc[4 * j + 2 * h + 1] += bb.y;
      s[h][0] += acc[4 * j + 2 * h] + acc[4 * j + 2 * h + 1];
    }
  }
  quad_sums(s);
  if (split) exchange(s, xch, buf, wg, row0, tq);
  float q[2][1] = {{0.f}, {0.f}};
  const float mean[2] = {s[0][0] / C, s[1][0] / C};
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = acc[4 * j + 2 * h + e] - mean[h];
        acc[4 * j + 2 * h + e] = d;
        q[h][0] += 8 * j + e < lim ? d * d : 0.f;
      }
  quad_sums(q);
  if (split) exchange(q, xch, buf, wg, row0, tq);
#pragma unroll
  for (int h = 0; h < 2; ++h) rstd[h] = rsqrtf(q[h][0] / C + LN_EPS);
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        acc[4 * j + 2 * h + e] =
            8 * j + e < lim ? acc[4 * j + 2 * h + e] * rstd[h] : 0.f;
}

// --- the work ------------------------------------------------------------------

struct Geo {
  int H, W, C, CD;
  int xt;           // units per image row
  int units;        // B H xt
  int items;        // split ? units x ntiles : ceil(units / 2)
  int split;        // 1: one unit an item, N halves; 0: two units, whole rows
  int kc;           // 128-byte K chunks: ceil(CD / KCH)
  int ntiles;       // N tiles of 2 NW channels an item (split rows only)
  int rot;          // dpix: taps (dy, dx) read (y - dy + 1, x - dx + 1)
  int stages, stage_bytes, b_off;  // ring; B's offset in a stage
  int grid;         // persistent CTAs
  int prm_bytes;    // the epilogue's shared memory
  // unit u -> image b, row y, first pixel x0
  __host__ __device__ __forceinline__ void unit(int u, int& b, int& y,
                                                int& x0) const {
    x0 = (u % xt) * TILE;
    const int r = u / xt;
    y = r % H;
    b = r / H;
  }
  // channels the CTA's epilogue parameters cover
  __host__ __device__ __forceinline__ int nt(int nw) const {
    return split ? 2 * nw : nw;
  }
};

// the warpgroup width for C channels in a mode: NW >= C (whole rows) or
// >= C / 2 (split), a multiple of 64
inline int nw_for(int C, int split) {
  const int n = split ? (C + 1) / 2 : C;
  return (n + 63) / 64 * 64;
}

// the mode: whole rows up to Ty<T>::WHOLE_C channels unless they leave SMs
// idle
template <class T>
inline int split_for(int B, int H, int W, int C) {
  const int units = B * H * ((W + TILE - 1) / TILE);
  return C > Ty<T>::WHOLE_C || (units + 1) / 2 < sm_count() ? 1 : 0;
}

// the warpgroup width of C channels in a mode (the widest past
// Ty<T>::ROW_C: N tiles)
template <class T>
inline int width_for(int C, int split) {
  return C > Ty<T>::ROW_C ? Ty<T>::NW_MAX : nw_for(C, split);
}

// the ring for an epilogue of prm_bytes (0 stages where none fits): a stage
// holds the item's one or two pixel boxes, then per warpgroup half (split)
// the W1 slab's parts, NW rows of 128 bytes each
template <class T>
inline Geo plan(int B, int H, int W, int C, int CD, int split, int nw,
                int rot, int prm_bytes) {
  Geo g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.CD = CD;
  g.xt = (W + TILE - 1) / TILE;
  g.units = B * H * g.xt;
  g.split = split;
  g.ntiles = split ? (CD + 2 * nw - 1) / (2 * nw) : 1;
  g.items = split ? g.units * g.ntiles : (g.units + 1) / 2;
  g.kc = (CD + Ty<T>::KCH - 1) / Ty<T>::KCH;
  g.rot = rot;
  g.b_off = (split ? 1 : 2) * BOX;
  g.stage_bytes = g.b_off + (split ? 2 : 1) * Ty<T>::PARTS * nw * 128;
  g.prm_bytes = prm_bytes;
  const int room = SMEM_MAX - 1024 - BAR_BYTES - prm_bytes;
  g.stages = std::min(MAX_STAGES, std::max(0, room / g.stage_bytes));
  g.grid = std::min(sm_count(), g.items);
  return g;
}

inline int smem_of(const Geo& g) {
  return 1024 + g.stages * g.stage_bytes + BAR_BYTES + g.prm_bytes;
}

// a (B, H, W, CD) tensor as 4-D boxes of (128 bytes of channels, 64 pixels)
template <class T>
inline bool map_pixels(CUtensorMap* map, const void* ptr, int B, int H,
                       int W, int CD) {
  const int es = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)CD, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)CD * es, (cuuint64_t)W * CD * es,
                                 (cuuint64_t)H * W * CD * es};
  const cuuint32_t box[4] = {(cuuint32_t)Ty<T>::KCH, TILE, 1, 1};
  return encode_map(map, Ty<T>::MAP, 4, ptr, dims, strides, box);
}

// a packed (parts x 9, CD, CD) W1 as 3-D boxes of (128 bytes of channels,
// rows rows, 1 plane): plane t is tap t's big (or only) part, plane 9 + t
// its small part
template <class T>
inline bool map_w1(CUtensorMap* map, const void* w1, int CD, int rows) {
  const int es = sizeof(T);
  const cuuint64_t dims[3] = {(cuuint64_t)CD, (cuuint64_t)CD,
                              (cuuint64_t)TAPS * Ty<T>::PARTS};
  const cuuint64_t strides[2] = {(cuuint64_t)CD * es,
                                 (cuuint64_t)CD * CD * es};
  const cuuint32_t box[3] = {(cuuint32_t)Ty<T>::KCH, (cuuint32_t)rows, 1};
  return encode_map(map, Ty<T>::MAP, 3, w1, dims, strides, box);
}

// fp32: this thread's A fragments of one 32-channel K chunk (4 k8 steps)
// from a K-major swizzled box of 64 rows, split into big and small tf32
// parts: rows r0 and r0 + 8 (r0 = warp 16 + g), columns 8 kk + tq and
// 8 kk + tq + 4, in wgmma_tf32_rs's register order
template <int K8>
__device__ __forceinline__ void a_frags(const unsigned char* box, int r0,
                                        int tq, uint32_t (&big)[K8][4],
                                        uint32_t (&small)[K8][4]) {
#pragma unroll
  for (int kk = 0; kk < K8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 8 * (i & 1), k = 8 * kk + tq + 4 * (i >> 1);
      const float v = *reinterpret_cast<const float*>(
          box + tf32x3::sw_off(r, k, TILE));
      tf32x3::split(v, big[kk][i], small[kk][i]);
    }
}

// An epilogue E (a template over NW and the input type T) supplies
//   E::Params, E::kNW, E::T    its kernel argument, warpgroup width, type
//   E::load(p, geo, prm, tid)  every thread, before the first barrier
//   E(p, geo, prm)             a consumer thread's state
//   e.unit(acc, b, y, x0, valid, wg, n0)  the unit's fp32 sums (valid:
//                              a real unit, not the ghost second unit of
//                              the last whole-rows item); the warpgroup's
//                              channels start at n0 (tile t, split rows:
//                              t 2 NW + wg NW; whole rows: 0)
//   e.finish()                 after the CTA's last item
//
// The ring: the producer thread fills stage g % S with step g's boxes (the
// item's one or two pixel boxes, then the W1 slab: NW rows, or 2 NW in two
// boxes in split mode, each in Ty<T>::PARTS parts); both consumer
// warpgroups read every stage. bf16: a stage's four k16 products are one
// commit group, and the previous stage is released once its group has
// completed (wait_group 1), so one group is in flight while the next
// stage's barrier is awaited. fp32: the A fragments are loaded and split,
// the step's 3 x 4 k8 products are one group, waited for (wait_group 0)
// and added into the totals; the stage is released then.
template <class E>
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const __grid_constant__ CUtensorMap tm_a,
            const __grid_constant__ CUtensorMap tm_b,
            const typename E::Params p, const Geo geo) {
  constexpr int NW = E::kNW;
  typedef typename E::T T;
  constexpr int KCH_T = Ty<T>::KCH, PARTS = Ty<T>::PARTS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int S = geo.stages;
  const uint32_t s_ring = smem_u32(smem);
  const uint32_t bar_full = s_ring + S * geo.stage_bytes;
  const uint32_t bar_empty = bar_full + 8 * S;
  unsigned char* prm = smem + S * geo.stage_bytes + BAR_BYTES;

  const int tid = threadIdx.x;
  if (tid == CONSUMERS) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  E::load(p, geo, prm, tid);
  __syncthreads();

  const int wg = tid >> 7;
  const int ksteps = TAPS * geo.kc;
  const int n_a = geo.split ? 1 : 2;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      int g = 0;
      for (int it = blockIdx.x; it < geo.items; it += gridDim.x) {
        int ub[2], uy[2], ux[2];
        for (int a = 0; a < n_a; ++a) {
          const int u = geo.split ? it / geo.ntiles : 2 * it + a;
          // the ghost second unit reloads the first one's boxes
          geo.unit(u < geo.units ? u : 2 * it, ub[a], uy[a], ux[a]);
        }
        const int row0 = (geo.split ? it % geo.ntiles : 0) * 2 * NW;
        for (int k = 0; k < ksteps; ++k, ++g) {
          const int t = k / geo.kc, ck = (k - t * geo.kc) * KCH_T;
          const int dy = t / 3 - 1, dx = t % 3 - 1;
          const int oy = geo.rot ? -dy : dy, ox = geo.rot ? -dx : dx;
          const int s = g % S;
          mbar_wait(bar_empty + 8 * s, ((g / S) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * s, geo.stage_bytes);
          const uint32_t dst = s_ring + s * geo.stage_bytes;
          for (int a = 0; a < n_a; ++a)
            tma_load_4d(dst + a * BOX, &tm_a, ck, ux[a] + ox, uy[a] + oy,
                        ub[a], bar_full + 8 * s);
          for (int h = 0; h < 2 - n_a + 1; ++h)
            for (int q = 0; q < PARTS; ++q)
              tma_load_3d(dst + geo.b_off + (h * PARTS + q) * NW * 128,
                          &tm_b, ck, row0 + h * NW, t + q * TAPS,
                          bar_full + 8 * s);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    E epi(p, geo, prm);
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    const uint32_t a_off = geo.split ? 0 : wg * BOX;
    const uint32_t b_off =
        geo.b_off + (geo.split ? wg * PARTS * NW * 128 : 0);
    int g = 0;
    for (int it = blockIdx.x; it < geo.items; it += gridDim.x) {
      if constexpr (PARTS == 1) {
        fence_regs(acc);
        for (int k = 0; k < ksteps; ++k, ++g) {
          const int s = g % S;
          mbar_wait(bar_full + 8 * s, (g / S) & 1);
          const uint32_t st = s_ring + s * geo.stage_bytes;
          const uint64_t da = desc_sw128(st + a_off, 16, 1024);
          const uint64_t db = desc_sw128(st + b_off, 16, 1024);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KCH / 16; ++kk)
            mma<0, 0>(acc, da + 2 * kk, db + 2 * kk, k > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<1>();
          if (k > 0) mbar_arrive(bar_empty + 8 * ((g - 1) % S));
        }
        wgmma_wait0();
        fence_regs(acc);
        mbar_arrive(bar_empty + 8 * ((g - 1) % S));
      } else {
        // the totals live in acc; the step's products land in part
        float part[NW / 2];
        const int r0 = ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2);
        const int tq = tid & 3;
#pragma unroll
        for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
        for (int k = 0; k < ksteps; ++k, ++g) {
          const int s = g % S;
          mbar_wait(bar_full + 8 * s, (g / S) & 1);
          const uint32_t st = s_ring + s * geo.stage_bytes;
          uint32_t ab[4][4], as[4][4];
          a_frags<4>(smem + s * geo.stage_bytes + a_off, r0, tq, ab, as);
          const uint64_t db = desc_sw128(st + b_off, 16, 1024);
          const uint64_t dbs = desc_sw128(st + b_off + NW * 128, 16, 1024);
          wgmma_fence();
          tf32x3::mma3_rs<NW, 4>(part, ab, as, db, dbs, NW, 0);
          wgmma_commit();
          wgmma_wait0();
          fence_regs(part);
          mbar_arrive(bar_empty + 8 * s);
#pragma unroll
          for (int i = 0; i < NW / 2; ++i) acc[i] += part[i];
        }
      }
      const int u = geo.split ? it / geo.ntiles : 2 * it + wg;
      const int n0 = geo.split ? (it % geo.ntiles) * 2 * NW + wg * NW : 0;
      int b, y, x0;
      geo.unit(u < geo.units ? u : 0, b, y, x0);
      epi.unit(acc, b, y, x0, u < geo.units, wg, n0);
    }
    epi.finish();
  }
}

// (C > Ty<T>::ROW_C) u = conv + b1 into the fp32 (B, H, W, CD) scratch
template <int NW, class T_>
struct UEpi {
  static constexpr int kNW = NW;
  typedef T_ T;
  struct Params {
    const T* packed;
    float* u;
  };
  static int prm_bytes(int) { return 0; }
  static __device__ __forceinline__ void load(const Params&, const Geo&,
                                              unsigned char*, int) {}

  const T* b1;
  float* u;
  int CD, H, W, warp, g, tq;

  __device__ __forceinline__ UEpi(const Params& p, const Geo& geo,
                                  unsigned char*)
      : b1(p.packed + off_b1(geo.CD, Ty<T>::PARTS)), u(p.u), CD(geo.CD),
        H(geo.H), W(geo.W), warp((threadIdx.x & 127) >> 5),
        g((threadIdx.x & 31) >> 2), tq(threadIdx.x & 3) {}

  __device__ __forceinline__ void unit(float (&acc)[NW / 2], int b, int y,
                                       int x0, bool valid, int, int n0) {
    if (!valid) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + warp * 16 + g + 8 * h;
      if (x >= W) continue;
      float* dst = u + (((size_t)b * H + y) * W + x) * CD;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int c = n0 + 8 * j + 2 * tq;
        if (c < CD)
          *reinterpret_cast<float2*>(dst + c) =
              make_float2(acc[4 * j + 2 * h] + to_f(b1[c]),
                          acc[4 * j + 2 * h + 1] + to_f(b1[c + 1]));
      }
    }
  }

  __device__ __forceinline__ void finish() {}
};

// the row kernels past Ty<T>::ROW_C: one warp a pixel, ROW_WARPS warps a
// CTA, warp w of the grid taking pixels w, w + all warps, ...
constexpr int ROW_WARPS = 8;

// launch conv_kernel<E> (its ring planned for E's shared memory)
template <class E>
int launch_conv(const CUtensorMap& m_a, const CUtensorMap& m_b,
                const typename E::Params& p, const Geo& geo,
                cudaStream_t st) {
  if (geo.stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = smem_of(geo);
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  conv_kernel<E><<<geo.grid, THREADS, smem, st>>>(m_a, m_b, p, geo);
  return (int)cudaGetLastError();
}

// dispatch on NW: f(std::integral_constant<int, NW>) for 64 .. 256 in bf16,
// 64 and 128 in fp32
template <class T, class F>
int with_nw(int nw, F&& f) {
  switch (nw) {
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
  }
  if constexpr (Ty<T>::NW_MAX == 256) {
    switch (nw) {
      case 192: return f(std::integral_constant<int, 192>());
      case 256: return f(std::integral_constant<int, 256>());
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc
