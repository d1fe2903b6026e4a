// Width-generic attention with a decomposed relative-position bias on
// Hopper's tensor cores: forward (K1g) and backward (K2g), at every head
// dim and key grid of the JAX kernel's domain.
//
// Replaces the TPU kernels painter_tpu/kernels/flash_relpos.py:_fwd_impl
// (K1g) and _bwd_impl (K2g) at the shapes the ViT-L kernels of
// flash_relpos_fwd.cu / flash_relpos_bwd.cu are not built for: head dims
// other than 64, and key grids past their rel-term limits (K1: kh + kw <=
// 190; K2: kh + kw <= 127, in bf16 a grid width in [10, 40], in fp32 kw
// <= 48). The wrapper (kernels/flash_relpos.py attention_route) sends a
// shape here by its shape alone; the JAX kernel's domain, hd + min(kh, kw)
// <= 128, is the domain of this file: no limit on kh + kw or on kw.
//
// Contracts: those of flash_relpos_fwd.cu and flash_relpos_bwd.cu, at a
// head dim D in {16, 32, 64, 128} (templates, each in bf16 and fp32). The
// wrapper zero-pads q, k, v and dout to the next D (8 -> 16, 80 or 120 ->
// 128): zero columns add nothing to q.k or dout.v, the padded columns of
// out, dq, dk and dv come out zero and are sliced off, and the scale stays
// the real head dim's. The softmax runs in fp32 (online, exp2 domain); P is
// rounded to the input type before P.V and dv, dS before dq, dk and both
// rel-bias sums; lse is the forward's natural-log row logsumexp.
//
// What bounds it on an H100: operations, as the ViT-L kernels (4 BH L^2 D
// FLOP forward, 10 BH L^2 D backward -- this design recomputes S and dP in
// both backward kernels, 14 -- against a few MB of IO per head). bf16 runs
// on wgmma bf16 (989 TFLOP/s), fp32 on wgmma tf32 in three products per
// product (3xTF32, flash_relpos_tf32.cuh: each operand split into big +
// small tf32 parts, all small terms first; 495 / 3 TFLOP/s of
// fp32-accurate products, against 67 for fp32 FMAs).
//
// Design: one CTA of one warpgroup (128 threads) per 64 rows of its own
// side (queries in K1g and in K2g's dq kernel, keys in its dk/dv kernel),
// one to three CTAs per SM (by their registers, and shared memory of
// 43-208 KB), which take turns at the tensor cores while another stages
// its next tile. The CTA's own
// rows are copied once, raw, into shared memory, and each product's A
// fragments are read from there as it is issued (fp32: split in registers
// four k8 steps at a time, each such chunk's three products into a zeroed
// accumulator added into the register total: the tensor cores' fp32
// accumulation truncates). The other side streams through one buffer in
// tiles of BN rows (64 where a row of D fits one 128-byte swizzle row,
// else 32), loaded by all threads through registers and written K-major
// with the 128-byte swizzle -- as is (the B of S = Q.K^T and dP = dO.V^T,
// summed over D) and transposed (the B of P.V, dS.K, P^T.dO and dS^T.Q,
// summed over the tile's rows; fp32 wgmma reads tf32 K-major only), fp32
// split into its two tf32 parts and its transposed rows in perm_col order,
// so that an accumulator is the A fragment of the next product as it is
// (bf16: packed pairs; fp32: frag_from_acc). Every product is a wgmma with
// A from registers and B from shared memory: m64nBNk16 / k8 for S and dP,
// m64nDk16 (fp32: N chunks of at most 64) for the outputs.
//   The rel terms: per tile, the CTA stages the bias of its (query, key)
//   cells into shared memory, bias = (rel_h[q, kr] + rel_w[q, kc]) log2(e),
//   neighbouring threads on neighbouring keys of one query row (coalesced
//   rel_w loads, rel_h broadcast); a thread takes one key of the tile for
//   all its rows, so a tile costs each thread one division for the key's
//   grid cell (kr, kc). Nothing is staged whole: no limit on kh + kw. A
//   thread issues all of a tile's bias loads into registers first and
//   stores them after the tile's operands are staged, so their latency
//   (L2: in the dk/dv kernel every query tile brings new rows) runs under
//   the staging's. On an H100 at 80x40 BH 16 in bf16 the dk/dv kernel
//   took 2.75 ms with the loads and stores interleaved, 1.07 ms with the
//   loads first, 0.80 ms with no bias at all.
//   K1g: online softmax on S's accumulator (quad shuffles for the row max,
//        row sums per thread until the end), O = O alpha + P.V.
//   K2g: two kernels, as K2 -- (a) dq and the rel-bias gradients per query
//        tile, walking the key tiles; (b) dk and dv per key tile, walking
//        the query tiles in the transposed orientation (S^T = K.Q^T) -- so
//        nothing needs atomics and two runs give the same bits. In (a) the
//        rounded dS tile goes to shared memory (over the tile's bias) and
//        two threads own each query row: one walks its keys in order and
//        sums d rel_h per grid row in a register (a grid row's sum is
//        written when its last key passes, straight to d_rel_h), the other
//        adds each key's dS in key order into the row's d rel_w totals (in
//        shared memory up to kw = 64, else in the row's fp32 scratch
//        (bh, L, kw) in global memory), written to d_rel_w at the end.
//        Every sum runs in a fixed order: key by key.
// Ragged L: rows past L are zero-filled, and P and dS are forced to 0 for
// keys and queries past L.
//
// The launchers allocate nothing and do not synchronize; they return
// cudaGetLastError() (or cudaErrorInvalidValue for a shared-memory layout
// past what a block may opt into) so the caller can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "flash_relpos_tf32.cuh"

namespace {
namespace gtc {  // "generic, tensor cores": the kernels' names in a profile

using namespace tf32x3;

typedef __nv_bfloat16 bf16;

constexpr int REL_SMEM_MAX = 64;  // d rel_w totals in shared memory up to kw
constexpr size_t SMEM_OPTIN = 232448;  // dynamic shared memory of a block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <typename T>
struct Ty;
template <>
struct Ty<bf16> {
  static constexpr int PARTS = 1, PAD = 8;  // PAD: own-row padding, elements
};
template <>
struct Ty<float> {
  static constexpr int PARTS = 2, PAD = 4;
};
template <typename T>
constexpr bool is_f32 = std::is_same<T, float>::value;

// BN: rows of the streamed tiles, 64 where a row of D fits one 128-byte
// swizzle row, else 32; BM: a CTA's own rows, one consumer warpgroup of
// NT threads (two warpgroups sharing each staged tile halve the staging
// per row but leave one CTA per SM, whose staging then runs under no
// other CTA's products: no faster on an H100)
// FWD_CTAS: the forward's registers are capped for three CTAs per SM at
// D <= 64 (168 a thread): on an H100 its time fell ~10% at 80x40 and 90x45
// in both types; the backward kernels lost to the spills such a cap makes.
template <typename T, int D>
struct Cfg {
  static constexpr int BN = D * (int)sizeof(T) <= 128 ? 64 : 32;
  static constexpr int BM = 64;
  static constexpr int NT = 2 * BM;
  static constexpr int FWD_CTAS = D <= 64 ? 3 : 1;
};

__host__ __device__ constexpr int round128(int bytes) {
  return (bytes + 127) / 128 * 128;
}

// bytes of one part of a K-major tile of `rows` rows, K extent `kbytes`:
// 128-byte column blocks of `rows` rows each
__host__ __device__ constexpr int tile_part(int rows, int kbytes) {
  return rows * round128(kbytes);
}

// byte offset of (row r, byte kb along K) in such a tile, 16-byte chunks
// XOR-ed with r & 7 (the 128-byte swizzle). k8_step (32 bytes of K: a k16
// step of bf16, a k8 step of tf32) walks its descriptors.
__device__ __forceinline__ uint32_t swz(int r, int kb, int rows) {
  return (uint32_t)((kb >> 7) * rows * 128 + r * 128 +
                    ((((kb & 127) >> 4) ^ (r & 7)) << 4) + (kb & 15));
}

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
// x rounded to the input type, as fp32
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return to_f(from_f<T>(x));
}

// component i (a constant after unrolling) of a 16-byte vector
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint4 ld16(const void* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint4*>(p))
            : make_uint4(0u, 0u, 0u, 0u);
}

// --- wgmma bf16, A from registers, B K-major (imm-trans-b 0) ---------------

template <int N>
__device__ void wgmma_bf16_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                              uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_bf16_rs<16>(float (&d)[8],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<32>(float (&d)[16],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<64>(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<128>(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// --- staging ------------------------------------------------------------------

// Rows [row0, row0 + N) of a (L, D) matrix (zero past L) into `plain` (N
// rows, K = the D columns) and / or `trans` (D rows, K = the N rows, in
// perm_col order in fp32), each K-major with the 128-byte swizzle, fp32 as
// its big and small tf32 parts (part bytes apart). A thread takes one
// 16-byte column chunk of a row pair; the pairs of a chunk sit on
// neighbouring lanes, so the transposed stores of one column hit distinct
// banks (bf16 packs the pair into one 4-byte word).
template <typename T, int D, int N, int NT>
__device__ __forceinline__ void stage(const T* __restrict__ src, int row0,
                                      int L, unsigned char* plain,
                                      unsigned char* trans, int tid) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CH = D / VEC;
  constexpr int PAIRS = N / 2;
  constexpr int UNITS = PAIRS * CH;
  constexpr int PER = (UNITS + NT - 1) / NT;
  constexpr int PP = tile_part(N, D * (int)sizeof(T));
  constexpr int TP = tile_part(D, N * (int)sizeof(T));
  uint4 x[PER][2];
#pragma unroll
  for (int b = 0; b < PER; ++b) {
    const int u = tid + b * NT;
    const int p = u % PAIRS, c = u / PAIRS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + 2 * p + h;
      x[b][h] = ld16(src + (size_t)gr * D + c * VEC, u < UNITS && gr < L);
    }
  }
#pragma unroll
  for (int b = 0; b < PER; ++b) {
    const int u = tid + b * NT;
    if (UNITS % NT && u >= UNITS) break;
    const int p = u % PAIRS, c = u / PAIRS;
    if (plain) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t off = swz(2 * p + h, 16 * c, N);
        if constexpr (is_f32<T>) {
          uint4 big, small;
          split(__uint_as_float(x[b][h].x), big.x, small.x);
          split(__uint_as_float(x[b][h].y), big.y, small.y);
          split(__uint_as_float(x[b][h].z), big.z, small.z);
          split(__uint_as_float(x[b][h].w), big.w, small.w);
          *reinterpret_cast<uint4*>(plain + off) = big;
          *reinterpret_cast<uint4*>(plain + PP + off) = small;
        } else {
          *reinterpret_cast<uint4*>(plain + off) = x[b][h];
        }
      }
    }
    if (trans) {
      if constexpr (is_f32<T>) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kb = 4 * perm_col(2 * p + h);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t off = swz(c * 4 + e, kb, D);
            uint32_t big, small;
            split(__uint_as_float(word(x[b][h], e)), big, small);
            *reinterpret_cast<uint32_t*>(trans + off) = big;
            *reinterpret_cast<uint32_t*>(trans + TP + off) = small;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t lo = (word(x[b][0], e >> 1) >> (16 * (e & 1))) & 0xffffu;
          const uint32_t hi = (word(x[b][1], e >> 1) >> (16 * (e & 1))) & 0xffffu;
          *reinterpret_cast<uint32_t*>(trans + swz(c * 8 + e, 4 * p, D)) =
              lo | (hi << 16);
        }
      }
    }
  }
}

// the CTA's own rows [row0, row0 + BM) of a (L, D) matrix, raw, row
// stride D + PAD (conflict-free fragment loads); zero past L
template <typename T, int D, int BM, int NT>
__device__ __forceinline__ void load_own(T* dst, const T* __restrict__ src,
                                         int row0, int L, int tid) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CH = D / VEC;
  constexpr int LDO = D + Ty<T>::PAD;
  for (int i = tid; i < BM * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    *reinterpret_cast<uint4*>(dst + r * LDO + c * VEC) =
        ld16(src + (size_t)(row0 + r) * D + c * VEC, row0 + r < L);
  }
}

// The bias of a tile's (query, key) cells, bias[r * (C + 1) + c] =
// (rel_h[q, kr] + rel_w[q, kc]) log2(e) of query q0 + r (R rows) and key
// key0 + c (C columns), 0 past L, in two steps: load() issues every load
// of the thread's cells into registers, store() writes them once they
// arrive, so that the tile's operand staging runs between the two. A
// thread keeps one key (c = tid % C: one division for its grid cell) and
// walks rows; neighbouring threads read neighbouring keys of one query
// row (coalesced rel_w, broadcast rel_h).
template <typename T, int R, int C, int NT>
struct BiasTile {
  static constexpr int STEP = NT / C;
  static constexpr int N = R / STEP;  // cells per thread
  T h[N], w[N];

  __device__ __forceinline__ void load(const T* __restrict__ rel_h,
                                       const T* __restrict__ rel_w,
                                       size_t rbase, int q0, int key0,
                                       int L, int kh, int kw, int tid) {
    const int key = key0 + tid % C;
    const bool kok = key < L;
    const int kr = kok ? key / kw : 0;
    const int kc = key - kr * kw;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int q = q0 + tid / C + i * STEP;
      const bool ok = kok && q < L;
      const size_t row = rbase + (ok ? q : 0);
      h[i] = ok ? rel_h[row * kh + kr] : from_f<T>(0.f);
      w[i] = ok ? rel_w[row * kw + kc] : from_f<T>(0.f);
    }
  }
  __device__ __forceinline__ void store(float* bias, int tid) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
      bias[(tid / C + i * STEP) * (C + 1) + tid % C] =
          (to_f(h[i]) + to_f(w[i])) * LOG2E;
  }
};

// --- products -------------------------------------------------------------------

// bf16 A fragments of every k16 step of the own rows: the warp's rows
// 16 w + g and + 8, columns 16 kk + 2 t (+ 8)
template <int D>
__device__ __forceinline__ void own_frags(uint32_t (&a)[D / 16][4],
                                          const bf16* own, int w, int g,
                                          int t) {
  constexpr int LDO = D + Ty<bf16>::PAD;
  const bf16* r0 = own + (16 * w + g) * LDO + 2 * t;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = *reinterpret_cast<const uint32_t*>(r0 + 16 * kk);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LDO + 16 * kk);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 16 * kk + 8);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LDO + 16 * kk + 8);
  }
}

// bf16: D (+)= A . B over K16 k16 steps, A from registers
template <int N, int K16>
__device__ __forceinline__ void mma_bf16(float (&d)[N / 2],
                                         const uint32_t (&a)[K16][4],
                                         uint64_t db, int rows, int acc) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk)
    wgmma_bf16_rs<N>(d, a[kk], db + k8_step(kk, rows), acc | kk);
}

// fp32: acc = own rows . tile^T over D (S or dP in 3xTF32): the own rows'
// A fragments split four k8 steps at a time, each chunk's three products
// into a zeroed accumulator, waited for and added into acc
template <int D, int N>
__device__ __forceinline__ void own_product_f32(float (&acc)[N / 2],
                                                const float* own,
                                                uint32_t tile, int w, int g,
                                                int t) {
  constexpr int LDO = D + Ty<float>::PAD;
  constexpr int K8 = D / 8;
  constexpr int KC = K8 < 4 ? K8 : 4;
  constexpr int PP = tile_part(N, D * 4);
  const uint64_t db = desc_sw128(tile, 16, 1024);
  const uint64_t ds = desc_sw128(tile + PP, 16, 1024);
  const float* r0 = own + (16 * w + g) * LDO + t;
#pragma unroll
  for (int c0 = 0; c0 < K8; c0 += KC) {
    uint32_t ab[KC][4], as[KC][4];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const int col = 8 * (c0 + kk);
      split(r0[col], ab[kk][0], as[kk][0]);
      split(r0[8 * LDO + col], ab[kk][1], as[kk][1]);
      split(r0[col + 4], ab[kk][2], as[kk][2]);
      split(r0[8 * LDO + col + 4], ab[kk][3], as[kk][3]);
    }
    float tmp[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) tmp[i] = 0.f;
    fence_regs(tmp);
    wgmma_fence();
    mma3_rs<N, KC>(tmp, ab, as, db + k8_step(c0, N), ds + k8_step(c0, N), N,
                   0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(tmp);
    fence_u32(ab);
    fence_u32(as);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = c0 ? acc[i] + tmp[i] : tmp[i];
  }
}

// the bf16 A fragments of a product summed over the tile's rows: an m64nN
// accumulator (P or dS) packed in pairs, each rounded to bf16
template <int N>
__device__ __forceinline__ void pack_frags(const float (&s)[N / 2],
                                           uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// fp32: acc (+)= A . trans over the tile's N rows, in N chunks of at most
// 64 columns of D, A the split fragments of an m64nN accumulator; each
// chunk in a zeroed accumulator, waited for and added into acc (RESCALE:
// acc = acc * alpha + chunk, alpha per row: a0 rows g, a1 rows g + 8)
template <int D, int N, bool RESCALE>
__device__ __forceinline__ void out_product_f32(float (&acc)[D / 2],
                                                const float (&s)[N / 2],
                                                uint32_t trans, float a0,
                                                float a1) {
  constexpr int NC = D < 64 ? D : 64;
  constexpr int TP = tile_part(D, N * 4);
  uint32_t ab[N / 8][4], as[N / 8][4];
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) frag_from_acc(s, kk, ab[kk], as[kk]);
  const uint64_t db = desc_sw128(trans, 16, 1024);
  const uint64_t ds = desc_sw128(trans + TP, 16, 1024);
#pragma unroll
  for (int nc = 0; nc < D / NC; ++nc) {
    float tmp[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) tmp[i] = 0.f;
    const uint64_t off = (uint64_t)((nc * NC * 128) >> 4);
    fence_regs(tmp);
    wgmma_fence();
    mma3_rs<NC, N / 8>(tmp, ab, as, db + off, ds + off, D, 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(tmp);
    fence_u32(ab);
    fence_u32(as);
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) {
      float& o = acc[nc * NC / 2 + i];
      o = RESCALE ? fmaf(o, (i & 2) ? a1 : a0, tmp[i]) : o + tmp[i];
    }
  }
}

// rows (row0 + r0, + 8) of a (L, D) output from an m64nD accumulator,
// times mul0 / mul1
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, int row0, int L,
                                           const float (&o)[D / 2],
                                           float mul0, float mul1, int r0,
                                           int t) {
  const int ga = row0 + r0, gb = ga + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if constexpr (is_f32<T>) {
      if (ga < L)
        *reinterpret_cast<float2*>(dst + (size_t)ga * D + c) =
            make_float2(o[4 * j] * mul0, o[4 * j + 1] * mul0);
      if (gb < L)
        *reinterpret_cast<float2*>(dst + (size_t)gb * D + c) =
            make_float2(o[4 * j + 2] * mul1, o[4 * j + 3] * mul1);
    } else {
      if (ga < L)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)ga * D + c) =
            __floats2bfloat162_rn(o[4 * j] * mul0, o[4 * j + 1] * mul0);
      if (gb < L)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)gb * D + c) =
            __floats2bfloat162_rn(o[4 * j + 2] * mul1, o[4 * j + 3] * mul1);
    }
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---------------------------------------------------------------------------
// K1g: forward
// ---------------------------------------------------------------------------

// shared memory: [K | V^T | own Q | bias]
template <typename T, int D>
struct FwdSmem {
  static constexpr int BN = Cfg<T, D>::BN, BM = Cfg<T, D>::BM;
  static constexpr int P = Ty<T>::PARTS;
  static constexpr int K = 0;
  static constexpr int VT = K + P * tile_part(BN, D * (int)sizeof(T));
  static constexpr int OWN = VT + P * tile_part(D, BN * (int)sizeof(T));
  static constexpr int BIAS = OWN + BM * (D + Ty<T>::PAD) * (int)sizeof(T);
  static constexpr int END = BIAS + BM * (BN + 1) * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::NT, Cfg<T, D>::FWD_CTAS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ rel_h,
           const T* __restrict__ rel_w, T* __restrict__ out,
           float* __restrict__ lse, int L, int kh, int kw, float scale) {
  using S = FwdSmem<T, D>;
  constexpr int BN = S::BN, BM = S::BM, NT = Cfg<T, D>::NT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t s_base = smem_u32(smem);
  T* own = reinterpret_cast<T*>(smem + S::OWN);
  float* bias = reinterpret_cast<float*>(smem + S::BIAS);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int r0 = 16 * w + g, r1 = r0 + 8;
  const size_t rbase = (size_t)bh * L;
  const size_t base = rbase * D;
  const float sc = scale * LOG2E;

  load_own<T, D, BM, NT>(own, q + base, q0, L, tid);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < L; k0 += BN) {
    __syncthreads();  // the previous tile is consumed
    BiasTile<T, BM, BN, NT> bt;
    bt.load(rel_h, rel_w, rbase, q0, k0, L, kh, kw, tid);
    stage<T, D, BN, NT>(k + base, k0, L, smem + S::K, nullptr, tid);
    stage<T, D, BN, NT>(v + base, k0, L, nullptr, smem + S::VT, tid);
    bt.store(bias, tid);
    fence_proxy_async();  // the generic stores, then wgmma's reads
    __syncthreads();

    // S = Q . K^T
    float s[BN / 2];
    if constexpr (is_f32<T>) {
      own_product_f32<D, BN>(s, own, s_base + S::K, w, g, t);
    } else {
      uint32_t a[D / 16][4];
      own_frags<D>(a, own, w, g, t);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
      mma_bf16<BN, D / 16>(s, a, desc_sw128(s_base + S::K, 16, 1024), BN, 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      fence_u32(a);
    }

    // logits in the exp2 domain, the online max, P = exp2(logit - max)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const bool ok = k0 + c < L;  // ragged tail: masked before the max
        float& x0 = s[4 * j + e];
        float& x1 = s[4 * j + 2 + e];
        x0 = ok ? fmaf(x0, sc, bias[r0 * (BN + 1) + c]) : -INFINITY;
        x1 = ok ? fmaf(x1, sc, bias[r1 * (BN + 1) + c]) : -INFINITY;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // key k0 < L is valid in every tile, so the new maxima are finite
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = exp2f(s[4 * j + e] - n0);
        s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - n1);
        ps0 += s[4 * j + e];
        ps1 += s[4 * j + 2 + e];
      }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;

    // O = O alpha + P . V
    if constexpr (is_f32<T>) {
      out_product_f32<D, BN, true>(o, s, s_base + S::VT, a0, a1);
    } else {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? a1 : a0;
      uint32_t pa[BN / 16][4];
      pack_frags<BN>(s, pa);
      fence_regs(o);
      wgmma_fence();
      mma_bf16<D, BN / 16>(o, pa, desc_sw128(s_base + S::VT, 16, 1024), D,
                           1);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      fence_u32(pa);
    }
  }

  // the row sums over the quad, then O / l
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  store_rows<T, D>(out + base, q0, L, o, 1.f / l0, 1.f / l1, r0, t);
  if (t == 0) {
    if (q0 + r0 < L) lse[rbase + q0 + r0] = (m0 + log2f(l0)) * LN2;
    if (q0 + r1 < L) lse[rbase + q0 + r1] = (m1 + log2f(l1)) * LN2;
  }
}

// ---------------------------------------------------------------------------
// K2g (a): dq and the rel-bias gradients of one 64-row query tile
// ---------------------------------------------------------------------------

// shared memory: [K | V | K^T | own Q | own dO | bias, then dS | d rel_w
// totals (kw <= REL_SMEM_MAX: 64 rows of kw | 1 floats)]
template <typename T, int D>
struct DqSmem {
  static constexpr int BN = Cfg<T, D>::BN, BM = Cfg<T, D>::BM;
  static constexpr int P = Ty<T>::PARTS;
  static constexpr int PLAIN = P * tile_part(BN, D * (int)sizeof(T));
  static constexpr int K = 0;
  static constexpr int V = K + PLAIN;
  static constexpr int KT = V + PLAIN;
  static constexpr int Q = KT + P * tile_part(D, BN * (int)sizeof(T));
  static constexpr int OWN = BM * (D + Ty<T>::PAD) * (int)sizeof(T);
  static constexpr int DO = Q + OWN;
  static constexpr int DS = DO + OWN;
  static constexpr int TW = DS + BM * (BN + 1) * 4;
  static size_t bytes(int kw) {
    return 1024 + (size_t)TW +
           (kw <= REL_SMEM_MAX ? (size_t)BM * (kw | 1) * 4 : 0);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ rel_h,
          const T* __restrict__ rel_w, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, T* __restrict__ drel_h, T* __restrict__ drel_w,
          float* __restrict__ gw, int L, int kh, int kw, float scale) {
  using S = DqSmem<T, D>;
  constexpr int BN = S::BN, BM = S::BM, NT = Cfg<T, D>::NT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t s_base = smem_u32(smem);
  T* qown = reinterpret_cast<T*>(smem + S::Q);
  T* down = reinterpret_cast<T*>(smem + S::DO);
  float* dsb = reinterpret_cast<float*>(smem + S::DS);  // bias, then dS

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int r0 = 16 * w + g, r1 = r0 + 8;
  const size_t rbase = (size_t)bh * L;
  const size_t base = rbase * D;
  const float sc = scale * LOG2E;

  load_own<T, D, BM, NT>(qown, q + base, q0, L, tid);
  load_own<T, D, BM, NT>(down, dout + base, q0, L, tid);
  const bool v0 = q0 + r0 < L, v1 = q0 + r1 < L;
  // padded query rows read no lse / delta: their P and dS are forced to 0
  const float lse0 = v0 ? lse[rbase + q0 + r0] * LOG2E : 0.f;
  const float lse1 = v1 ? lse[rbase + q0 + r1] * LOG2E : 0.f;
  const float dl0 = v0 ? delta[rbase + q0 + r0] : 0.f;
  const float dl1 = v1 ? delta[rbase + q0 + r1] : 0.f;

  // the rel-bias sums: threads 0-63 own row tid's d rel_h (a running
  // grid-row sum in registers), threads 64-127 row tid - 64's d rel_w
  // totals (shared memory, or the row's fp32 scratch past REL_SMEM_MAX)
  const int orow = tid & (BM - 1);
  const bool own_h = tid < BM;
  const bool ovalid = q0 + orow < L;
  const size_t grow = rbase + (ovalid ? q0 + orow : 0);
  float* tw = kw <= REL_SMEM_MAX
                  ? reinterpret_cast<float*>(smem + S::TW) + orow * (kw | 1)
                  : gw + grow * kw;
  if (!own_h && ovalid)
    for (int i = 0; i < kw; ++i) tw[i] = 0.f;
  float hsum = 0.f;  // the open grid row's sum (own_h)

  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BN) {
    __syncthreads();  // the previous tile is consumed
    BiasTile<T, BM, BN, NT> bt;
    bt.load(rel_h, rel_w, rbase, q0, k0, L, kh, kw, tid);
    stage<T, D, BN, NT>(k + base, k0, L, smem + S::K, smem + S::KT, tid);
    stage<T, D, BN, NT>(v + base, k0, L, smem + S::V, nullptr, tid);
    bt.store(dsb, tid);
    fence_proxy_async();
    __syncthreads();

    // S = Q . K^T, dP = dO . V^T
    float s[BN / 2], dp[BN / 2];
    if constexpr (is_f32<T>) {
      own_product_f32<D, BN>(s, qown, s_base + S::K, w, g, t);
      own_product_f32<D, BN>(dp, down, s_base + S::V, w, g, t);
    } else {
      uint32_t aq[D / 16][4], ad[D / 16][4];
      own_frags<D>(aq, qown, w, g, t);
      own_frags<D>(ad, down, w, g, t);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      mma_bf16<BN, D / 16>(s, aq, desc_sw128(s_base + S::K, 16, 1024), BN,
                           0);
      mma_bf16<BN, D / 16>(dp, ad, desc_sw128(s_base + S::V, 16, 1024), BN,
                           0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      fence_regs(dp);
      fence_u32(aq);
      fence_u32(ad);
    }

    // P = exp2(logit - lse), dS = P (dP - delta) rounded; dS over the bias
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const bool ok = k0 + c < L;
        float* b0 = dsb + r0 * (BN + 1) + c;
        float* b1 = dsb + r1 * (BN + 1) + c;
        const float p0 =
            ok && v0 ? exp2f(fmaf(s[4 * j + e], sc, *b0) - lse0) : 0.f;
        const float p1 =
            ok && v1 ? exp2f(fmaf(s[4 * j + 2 + e], sc, *b1) - lse1) : 0.f;
        const float d0 = rounded<T>(p0 * (dp[4 * j + e] - dl0));
        const float d1 = rounded<T>(p1 * (dp[4 * j + 2 + e] - dl1));
        s[4 * j + e] = d0;
        s[4 * j + 2 + e] = d1;
        *b0 = d0;
        *b1 = d1;
      }

    // dq += dS . K (bf16: its A fragments live until the wait below)
    uint32_t pa[BN / 16][4];
    if constexpr (is_f32<T>) {
      out_product_f32<D, BN, false>(dqa, s, s_base + S::KT, 0.f, 0.f);
    } else {
      pack_frags<BN>(s, pa);
      fence_regs(dqa);
      wgmma_fence();
      mma_bf16<D, BN / 16>(dqa, pa, desc_sw128(s_base + S::KT, 16, 1024), D,
                           1);
      wgmma_commit();  // waited for after the rel-bias sums
    }
    __syncthreads();  // the dS tile is whole

    // the rel-bias sums of the tile, each in key order
    if (ovalid) {
      const float* ds = dsb + orow * (BN + 1);
      const int n = min(BN, L - k0);
      if (own_h) {
        // the tile's keys in runs of one grid row; a run joins the open
        // row's sum, written when the row's last key passes
        int kr = k0 / kw;
        for (int c = 0; c < n;) {
          const int end = min(n, (kr + 1) * kw - k0);
          float a = hsum;
#pragma unroll 8
          for (; c < end; ++c) a += ds[c];
          hsum = a;
          if (k0 + c == (kr + 1) * kw) {
            drel_h[grow * kh + kr++] = from_f<T>(hsum);
            hsum = 0.f;
          }
        }
      } else {
        // each key's dS into its column's total; eight keys at a time
        // hit eight distinct columns (kw >= 8), so their loads go out
        // before their stores
        int kc = k0 % kw;
        int c = 0;
        if (kw >= 8) {
          for (; c + 8 <= n; c += 8) {
            int col[8];
            float x[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              col[u] = kc + u < kw ? kc + u : kc + u - kw;
              x[u] = ds[c + u] + tw[col[u]];
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) tw[col[u]] = x[u];
            kc = col[7] + 1 < kw ? col[7] + 1 : 0;
          }
        }
        for (; c < n; ++c) {
          tw[kc] += ds[c];
          if (++kc == kw) kc = 0;
        }
      }
    }
    if constexpr (!is_f32<T>) {
      wgmma_wait0();
      fence_regs(dqa);
      fence_u32(pa);
    }
  }

  store_rows<T, D>(dq + base, q0, L, dqa, scale, scale, r0, t);
  if (!own_h && ovalid) {
    T* dw = drel_w + grow * kw;
    for (int i = 0; i < kw; ++i) dw[i] = from_f<T>(tw[i]);
  }
}

// ---------------------------------------------------------------------------
// K2g (b): dk and dv of one 64-key tile
// ---------------------------------------------------------------------------

// shared memory: [Q | dO | Q^T | dO^T | own K | own V | bias^T (query
// rows) | lse | delta]
template <typename T, int D>
struct DkvSmem {
  static constexpr int BN = Cfg<T, D>::BN, BM = Cfg<T, D>::BM;
  static constexpr int P = Ty<T>::PARTS;
  static constexpr int PLAIN = P * tile_part(BN, D * (int)sizeof(T));
  static constexpr int TRANS = P * tile_part(D, BN * (int)sizeof(T));
  static constexpr int Q = 0;
  static constexpr int DO = Q + PLAIN;
  static constexpr int QT = DO + PLAIN;
  static constexpr int DOT = QT + TRANS;
  static constexpr int OWN = BM * (D + Ty<T>::PAD) * (int)sizeof(T);
  static constexpr int K = DOT + TRANS;
  static constexpr int V = K + OWN;
  static constexpr int BIAS = V + OWN;
  static constexpr int LSE = BIAS + BN * (BM + 1) * 4;
  static constexpr int DLT = LSE + BN * 4;
  static constexpr int END = DLT + BN * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::NT)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ rel_h,
           const T* __restrict__ rel_w, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int L, int kh, int kw,
           float scale) {
  using S = DkvSmem<T, D>;
  constexpr int BN = S::BN, BM = S::BM, NT = Cfg<T, D>::NT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t s_base = smem_u32(smem);
  T* kown = reinterpret_cast<T*>(smem + S::K);
  T* vown = reinterpret_cast<T*>(smem + S::V);
  float* bias = reinterpret_cast<float*>(smem + S::BIAS);  // (query, key)
  float* lse2 = reinterpret_cast<float*>(smem + S::LSE);
  float* dlt = reinterpret_cast<float*>(smem + S::DLT);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int r0 = 16 * w + g, r1 = r0 + 8;  // the thread's keys
  const size_t rbase = (size_t)bh * L;
  const size_t base = rbase * D;
  const float sc = scale * LOG2E;
  const bool v0 = k0 + r0 < L, v1 = k0 + r1 < L;

  load_own<T, D, BM, NT>(kown, k + base, k0, L, tid);
  load_own<T, D, BM, NT>(vown, v + base, k0, L, tid);
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int qt = 0; qt < L; qt += BN) {
    __syncthreads();  // the previous query tile is consumed
    BiasTile<T, BN, BM, NT> bt;
    bt.load(rel_h, rel_w, rbase, qt, k0, L, kh, kw, tid);
    stage<T, D, BN, NT>(q + base, qt, L, smem + S::Q, smem + S::QT, tid);
    stage<T, D, BN, NT>(dout + base, qt, L, smem + S::DO, smem + S::DOT, tid);
    bt.store(bias, tid);
    if (tid < BN) {
      const bool ok = qt + tid < L;
      lse2[tid] = ok ? lse[rbase + qt + tid] * LOG2E : 0.f;
      dlt[tid] = ok ? delta[rbase + qt + tid] : 0.f;
    }
    fence_proxy_async();
    __syncthreads();

    // S^T = K . Q^T, dP^T = V . dO^T
    float s[BN / 2], dp[BN / 2];
    if constexpr (is_f32<T>) {
      own_product_f32<D, BN>(s, kown, s_base + S::Q, w, g, t);
      own_product_f32<D, BN>(dp, vown, s_base + S::DO, w, g, t);
    } else {
      uint32_t ak[D / 16][4], av[D / 16][4];
      own_frags<D>(ak, kown, w, g, t);
      own_frags<D>(av, vown, w, g, t);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      mma_bf16<BN, D / 16>(s, ak, desc_sw128(s_base + S::Q, 16, 1024), BN,
                           0);
      mma_bf16<BN, D / 16>(dp, av, desc_sw128(s_base + S::DO, 16, 1024), BN,
                           0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      fence_regs(dp);
      fence_u32(ak);
      fence_u32(av);
    }

    // P^T and dS^T (rounded): rows the thread's keys, columns queries
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const bool ok = qt + c < L;
        const float* bq = bias + c * (BM + 1);
        const float p0 = ok && v0
            ? exp2f(fmaf(s[4 * j + e], sc, bq[r0]) - lse2[c]) : 0.f;
        const float p1 = ok && v1
            ? exp2f(fmaf(s[4 * j + 2 + e], sc, bq[r1]) - lse2[c]) : 0.f;
        s[4 * j + e] = p0;
        s[4 * j + 2 + e] = p1;
        dp[4 * j + e] = rounded<T>(p0 * (dp[4 * j + e] - dlt[c]));
        dp[4 * j + 2 + e] = rounded<T>(p1 * (dp[4 * j + 2 + e] - dlt[c]));
      }

    // dv += P^T . dO, dk += dS^T . Q
    if constexpr (is_f32<T>) {
      out_product_f32<D, BN, false>(dva, s, s_base + S::DOT, 0.f, 0.f);
      out_product_f32<D, BN, false>(dka, dp, s_base + S::QT, 0.f, 0.f);
    } else {
      uint32_t pa[BN / 16][4], da[BN / 16][4];
      pack_frags<BN>(s, pa);
      pack_frags<BN>(dp, da);
      fence_regs(dva);
      fence_regs(dka);
      wgmma_fence();
      mma_bf16<D, BN / 16>(dva, pa, desc_sw128(s_base + S::DOT, 16, 1024),
                           D, 1);
      mma_bf16<D, BN / 16>(dka, da, desc_sw128(s_base + S::QT, 16, 1024), D,
                           1);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dva);
      fence_regs(dka);
      fence_u32(pa);
      fence_u32(da);
    }
  }

  store_rows<T, D>(dv + base, k0, L, dva, 1.f, 1.f, r0, t);
  store_rows<T, D>(dk + base, k0, L, dka, scale, scale, r0, t);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes > SMEM_OPTIN) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v,
               const void* rel_h, const void* rel_w, void* out, void* lse,
               int bh, int L, int kh, int kw, float scale, cudaStream_t st) {
  using C = Cfg<T, D>;
  const size_t smem = 1024 + (size_t)FwdSmem<T, D>::END;
  cudaError_t err = set_smem(fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + C::BM - 1) / C::BM, bh);
  fwd_kernel<T, D><<<grid, C::NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(rel_h),
      static_cast<const T*>(rel_w), static_cast<T*>(out),
      static_cast<float*>(lse), L, kh, kw, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v,
               const void* rel_h, const void* rel_w, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, void* drel_h, void* drel_w, void* gw, int bh, int L,
               int kh, int kw, float scale, cudaStream_t st) {
  using C = Cfg<T, D>;
  const dim3 grid((L + C::BM - 1) / C::BM, bh);
  const size_t smem_a = DqSmem<T, D>::bytes(kw);
  cudaError_t err = set_smem(dq_kernel<T, D>, smem_a);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, D><<<grid, C::NT, smem_a, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(rel_h),
      static_cast<const T*>(rel_w), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), static_cast<T*>(drel_h), static_cast<T*>(drel_w),
      static_cast<float*>(gw), L, kh, kw, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_b = 1024 + (size_t)DkvSmem<T, D>::END;
  err = set_smem(dkv_kernel<T, D>, smem_b);
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<T, D><<<grid, C::NT, smem_b, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(rel_h),
      static_cast<const T*>(rel_w), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), L, kh, kw, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_at(int hd, const void* q, const void* k, const void* v,
           const void* rel_h, const void* rel_w, void* out, void* lse,
           int bh, int L, int kh, int kw, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_fwd<T, 16>(q, k, v, rel_h, rel_w, out, lse, bh, L, kh,
                               kw, scale, st);
    case 32:
      return launch_fwd<T, 32>(q, k, v, rel_h, rel_w, out, lse, bh, L, kh,
                               kw, scale, st);
    case 64:
      return launch_fwd<T, 64>(q, k, v, rel_h, rel_w, out, lse, bh, L, kh,
                               kw, scale, st);
    case 128:
      return launch_fwd<T, 128>(q, k, v, rel_h, rel_w, out, lse, bh, L, kh,
                                kw, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_at(int hd, const void* q, const void* k, const void* v,
           const void* rel_h, const void* rel_w, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           void* drel_h, void* drel_w, void* gw, int bh, int L, int kh,
           int kw, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_bwd<T, 16>(q, k, v, rel_h, rel_w, dout, lse, delta, dq,
                               dk, dv, drel_h, drel_w, gw, bh, L, kh, kw,
                               scale, st);
    case 32:
      return launch_bwd<T, 32>(q, k, v, rel_h, rel_w, dout, lse, delta, dq,
                               dk, dv, drel_h, drel_w, gw, bh, L, kh, kw,
                               scale, st);
    case 64:
      return launch_bwd<T, 64>(q, k, v, rel_h, rel_w, dout, lse, delta, dq,
                               dk, dv, drel_h, drel_w, gw, bh, L, kh, kw,
                               scale, st);
    case 128:
      return launch_bwd<T, 128>(q, k, v, rel_h, rel_w, dout, lse, delta, dq,
                                dk, dv, drel_h, drel_w, gw, bh, L, kh, kw,
                                scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace gtc
}  // namespace

extern "C" {

// hd: the built head dim (16, 32, 64 or 128) the inputs are padded to
int flash_relpos_generic_fwd_bf16(const void* q, const void* k,
                                  const void* v, const void* rel_h,
                                  const void* rel_w, void* out, void* lse,
                                  int bh, int L, int hd, int kh, int kw,
                                  float scale, void* stream) {
  return gtc::fwd_at<gtc::bf16>(hd, q, k, v, rel_h, rel_w, out, lse, bh, L, kh, kw,
                      scale, stream);
}

int flash_relpos_generic_fwd_f32(const void* q, const void* k, const void* v,
                                 const void* rel_h, const void* rel_w,
                                 void* out, void* lse, int bh, int L, int hd,
                                 int kh, int kw, float scale, void* stream) {
  return gtc::fwd_at<float>(hd, q, k, v, rel_h, rel_w, out, lse, bh, L, kh, kw,
                       scale, stream);
}

// gw (bh, L, kw): fp32 scratch for the d rel_w totals, read only when kw >
// REL_SMEM_MAX (64)
int flash_relpos_generic_bwd_bf16(const void* q, const void* k,
                                  const void* v, const void* rel_h,
                                  const void* rel_w, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, void* dk, void* dv,
                                  void* drel_h, void* drel_w, void* gw,
                                  int bh, int L, int hd, int kh, int kw,
                                  float scale, void* stream) {
  return gtc::bwd_at<gtc::bf16>(hd, q, k, v, rel_h, rel_w, dout, lse, delta, dq, dk,
                      dv, drel_h, drel_w, gw, bh, L, kh, kw, scale, stream);
}

int flash_relpos_generic_bwd_f32(const void* q, const void* k, const void* v,
                                 const void* rel_h, const void* rel_w,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, void* dk,
                                 void* dv, void* drel_h, void* drel_w,
                                 void* gw, int bh, int L, int hd, int kh,
                                 int kw, float scale, void* stream) {
  return gtc::bwd_at<float>(hd, q, k, v, rel_h, rel_w, dout, lse, delta, dq, dk,
                       dv, drel_h, drel_w, gw, bh, L, kh, kw, scale, stream);
}

const char* flash_relpos_generic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
