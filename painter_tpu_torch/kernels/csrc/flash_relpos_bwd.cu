// Flash attention backward with a decomposed relative-position bias (Hopper).
//
// Replaces the TPU kernel painter_tpu/kernels/flash_relpos.py:_bwd_impl
// (the Pallas backward reached through _attach_vjp -> _flash_bwd).
//
// Contract, per (batch*head) slice b, query row i and key j < L, keys on a
// row-major (kh, kw) grid (kh * kw == L):
//   s[i, j]  = scale * q[i] . k[j] + rel_h[i, j / kw] + rel_w[i, j % kw]
//   p[i, j]  = exp(s[i, j] - lse[i])        (lse: the forward's saved
//                                             natural-log row logsumexp)
//   ds[i, j] = p[i, j] * (dout[i] . v[j] - delta[i]),
//              delta[i] = dout[i] . out[i]   (computed by the caller)
//   dq[i]    = scale * sum_j ds[i, j] k[j]
//   dk[j]    = scale * sum_i ds[i, j] q[i]
//   dv[j]    = sum_i p[i, j] dout[i]
//   d_rel_h[i, r] = sum_{j : j / kw == r} ds[i, j]
//   d_rel_w[i, c] = sum_{j : j % kw == c} ds[i, j]
// Inputs q, k, v, dout (BH, L, 64), rel_h (BH, L, kh), rel_w (BH, L, kw),
// all contiguous and of one type (bf16 or fp32); lse, delta (BH, L) fp32.
// Outputs in the input type. P and dS are rounded to the input type before
// the three products that read them (dv, dq, dk), as K1 rounds P before
// P.V; every product accumulates in fp32, and the rel-bias row sums are
// taken in fp32 from the unrounded dS.
//
// What bounds it on an H100: operations. Five matrix products of BH * L^2
// * 64 multiply-adds each (S and dP are recomputed, then dv, dq, dk) --
// 10 * BH * L^2 * 64 FLOP -- against IO of a few MB per head, far above
// the card's balance point of ~295 FLOP per byte.
//
// Design (FA2-style, two kernels, deterministic -- no atomics):
//   (a) dq kernel: one CTA of 4 warps per (64-row query tile, bh). K/V
//       tiles of 64 keys stream through shared memory. Each warp owns 16
//       query rows: S = Q.K^T and dP = dO.V^T on the tensor cores (WMMA
//       16x16x16 bf16, fp32 accumulate) into shared memory, then the
//       scalar pass forms P and dS with the rel terms of the CTA's rows
//       (held in shared memory, as K1 does) and writes dS over the V
//       tile, which every warp has finished reading, and dq += dS.K runs
//       on the tensor cores into accumulator fragments that stay in
//       registers across the key loop. At the 56x28 grid in bf16 this
//       keeps the CTA at 112 KiB of shared memory, two CTAs per SM. The
//       same CTA owns its rows' d_rel_h / d_rel_w sums in shared memory
//       (64 x (kh + kw) fp32): each (row, bin) is summed by one fixed
//       lane per key tile, so no atomics are needed and the order of the
//       sums is fixed.
//   (b) dk/dv kernel: one CTA per (64-key tile, bh) streams query tiles
//       with their lse, delta, dO and the rel terms of the key-grid rows
//       and columns that the key tile touches. Each warp owns 16 keys and
//       computes S^T = K.Q^T and dP^T = V.dO^T, then dv += P^T.dO and
//       dk += dS^T.Q into register fragments.
// Ragged tiles (L = 1568, 2450, 196 are not multiples of 64): K/Q/V/dO
// rows past L are zero-filled, and P and dS are forced to 0 for keys and
// queries past L, so padded rows can never put NaN or garbage into a sum.
// What it does not do yet: the logits take a round trip through shared
// memory every tile, loads are synchronous (no cp.async / TMA ring), the
// products are WMMA (mma.sync class) rather than wgmma, and the two
// kernels recompute S and dP twice. The fp32 instantiation does the
// products in scalar FMAs: it exists for tight comparisons, not speed.
//
// The launcher allocates nothing and does not synchronize; it returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int D = 64;            // head dim
constexpr int BT = 64;           // rows of every tile (queries or keys)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WROWS = BT / WARPS;  // rows per warp (16)
constexpr int LDS = BT + 4;        // fp32 row stride of the S / dP buffers
constexpr float LOG2E = 1.4426950408889634f;

static_assert(WROWS == 16, "one WMMA row block per warp");
static_assert(BT == D, "the fp32 buffers hold both 64-key and 64-dim rows");

template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> { static constexpr int LD = D + 8; };
template <> struct Tile<float> { static constexpr int LD = D + 4; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [row0, row0 + 64) of a (L, D) matrix into shared memory; rows past
// L are zero-filled
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int L, int tid) {
  constexpr int LD = Tile<T>::LD;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = tid; i < BT * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < L) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// S (16 x BT, fp32, stride LDS) = A (16 x D) . B^T, B a (BT x D) tile
template <typename T>
__device__ void warp_abt(const T* a, const T* b, float* s, int lane);

template <>
__device__ void warp_abt<__nv_bfloat16>(const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, float* s,
                                        int lane) {
  constexpr int LD = Tile<__nv_bfloat16>::LD;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      fa[D / 16];
#pragma unroll
  for (int d = 0; d < D / 16; ++d)
    wmma::load_matrix_sync(fa[d], a + d * 16, LD);
#pragma unroll
  for (int n = 0; n < BT / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int d = 0; d < D / 16; ++d) {
      // B stored (row, d) row-major is B^T in column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + n * 16 * LD + d * 16, LD);
      wmma::mma_sync(c, fa[d], fb, c);
    }
    wmma::store_matrix_sync(s + n * 16, c, LDS, wmma::mem_row_major);
  }
}

// fp32: lane owns row lane/2 and the columns of parity lane%2
template <>
__device__ void warp_abt<float>(const float* a, const float* b, float* s,
                                int lane) {
  constexpr int LD = Tile<float>::LD;
  const int r = lane >> 1;
  const int h = lane & 1;
  float ar[D];
#pragma unroll
  for (int d = 0; d < D; ++d) ar[d] = a[r * LD + d];
  for (int j = 0; j < BT / 2; ++j) {
    const float* br = b + (2 * j + h) * LD;
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc = fmaf(ar[d], br[d], acc);
    s[r * LDS + 2 * j + h] = acc;
  }
}

// A warp's (16 x D) fp32 accumulator of products A (16 x BT) . B (BT x D),
// both operands tiles in shared memory (stride Tile<T>::LD)
template <typename T> struct Acc;

template <> struct Acc<__nv_bfloat16> {
  static constexpr int LD = Tile<__nv_bfloat16>::LD;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[D / 16];

  __device__ void zero() {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(c[n], 0.0f);
  }
  __device__ void mma(const __nv_bfloat16* a, const __nv_bfloat16* b,
                      int lane) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fa[BT / 16];
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      wmma::load_matrix_sync(fa[kk], a + kk * 16, LD);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, b + kk * 16 * LD + n * 16, LD);
        wmma::mma_sync(c[n], fa[kk], fb, c[n]);
      }
    }
  }
  // (16 x D) fp32 into s (stride LDS)
  __device__ void store(float* s, int lane) {
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(s + n * 16, c[n], LDS, wmma::mem_row_major);
  }
};

// fp32: lane owns row lane/2 and the columns of parity lane%2
template <> struct Acc<float> {
  static constexpr int LD = Tile<float>::LD;
  float c[D / 2];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) c[j] = 0.0f;
  }
  __device__ void mma(const float* a, const float* b, int lane) {
    const int r = lane >> 1;
    const int h = lane & 1;
    for (int kk = 0; kk < BT; ++kk) {
      const float ak = a[r * LD + kk];
      const float* br = b + kk * LD;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) c[j] = fmaf(ak, br[2 * j + h], c[j]);
    }
  }
  __device__ void store(float* s, int lane) {
    const int r = lane >> 1;
    const int h = lane & 1;
#pragma unroll
    for (int j = 0; j < D / 2; ++j) s[r * LDS + 2 * j + h] = c[j];
  }
};

// rows of a warp's (16 x D) fp32 result in s -> global, scaled and cast;
// rows at or past L are not written
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float* s,
                                           int row0, int L, float mul,
                                           int lane) {
  for (int i = lane; i < WROWS * D; i += 32) {
    const int r = i / D;
    const int c = i % D;
    if (row0 + r < L) {
      dst[(size_t)(row0 + r) * D + c] = from_f32<T>(s[r * LDS + c] * mul);
    }
  }
}

// the number of kh bins (key-grid rows) that keys [k0, kend) touch
__device__ __forceinline__ int bins_touched(int k0, int kend, int kw) {
  return (kend - 1) / kw - k0 / kw + 1;
}

// the dq kernel's dS tile overwrites the V tile once every warp has
// formed dP: 4 tiles, not 5, keep the bf16 kernel at the 56x28 grid under
// the ~113 KiB that lets two CTAs share an SM
template <typename T>
size_t dq_smem_bytes(int kh, int kw) {
  return 4 * (size_t)BT * Tile<T>::LD * sizeof(T)  // Q, dO, K, V (then dS)
         + 2 * (size_t)BT * LDS * sizeof(float)    // S (then dS), dP
         + 2 * (size_t)BT * (kh + kw) * sizeof(float);  // rel terms, sums
}

template <typename T>
size_t dkv_smem_bytes(int nbmax, int kw) {
  return 6 * (size_t)BT * Tile<T>::LD * sizeof(T)  // K, V, Q, dO, P, dS
         + 2 * (size_t)BT * LDS * sizeof(float)    // S^T, dP^T
         + (size_t)BT * (nbmax + kw + 2) * sizeof(float);  // rel, lse, delta
}

// (a) dq and the rel-bias gradients of one 64-row query tile
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_relpos_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ rel_h,
                           const T* __restrict__ rel_w,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dq, T* __restrict__ drel_h,
                           T* __restrict__ drel_w, int L, int kh, int kw,
                           float scale) {
  constexpr int LD = Tile<T>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BT * LD;
  T* Ks = dOs + BT * LD;
  T* Vs = Ks + BT * LD;        // V, then this tile's dS
  float* Ss = reinterpret_cast<float*>(Vs + BT * LD);
  float* dPs = Ss + BT * LDS;
  float* Rh = dPs + BT * LDS;  // (BT, kh) rel_h * log2(e)
  float* Rw = Rh + BT * kh;   // (BT, kw)
  float* Gh = Rw + BT * kw;   // (BT, kh) d rel_h sums
  float* Gw = Gh + BT * kh;   // (BT, kw) d rel_w sums

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t base = (size_t)bh * L * D;

  load_tile(Qs, q + base, q0, L, tid);
  load_tile(dOs, dout + base, q0, L, tid);
  for (int i = tid; i < BT * kh; i += THREADS) {
    const int qr = q0 + i / kh;
    Rh[i] = qr < L
        ? to_f32(rel_h[((size_t)bh * L + qr) * kh + i % kh]) * LOG2E : 0.0f;
    Gh[i] = 0.0f;
  }
  for (int i = tid; i < BT * kw; i += THREADS) {
    const int qr = q0 + i / kw;
    Rw[i] = qr < L
        ? to_f32(rel_w[((size_t)bh * L + qr) * kw + i % kw]) * LOG2E : 0.0f;
    Gw[i] = 0.0f;
  }

  const int r = lane >> 1;
  const int h = lane & 1;
  const int row = warp * WROWS + r;
  const int qr = q0 + row;
  const bool valid = qr < L;
  // padded query rows read no lse / delta: their P and dS are forced to 0
  const float lse2 = valid ? lse[(size_t)bh * L + qr] * LOG2E : 0.0f;
  const float dlt = valid ? delta[(size_t)bh * L + qr] : 0.0f;
  const T* Qw = Qs + warp * WROWS * LD;
  const T* dOw = dOs + warp * WROWS * LD;
  T* dSw = Vs + warp * WROWS * LD;
  float* Sw = Ss + warp * WROWS * LDS;
  float* dPw = dPs + warp * WROWS * LDS;
  const float* rh = Rh + row * kh;
  const float* rw = Rw + row * kw;
  float* Ghw = Gh + warp * WROWS * kh;
  float* Gww = Gw + warp * WROWS * kw;
  const float sc = scale * LOG2E;
  Acc<T> dqa;
  dqa.zero();

  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();  // the previous tile's K / V are consumed
    load_tile(Ks, k + base, k0, L, tid);
    load_tile(Vs, v + base, k0, L, tid);
    __syncthreads();

    warp_abt<T>(Qw, Ks, Sw, lane);
    warp_abt<T>(dOw, Vs, dPw, lane);
    __syncthreads();  // every warp has read V: its rows take dS now

    const int kend = min(k0 + BT, L);
#pragma unroll 4
    for (int j = 0; j < BT / 2; ++j) {
      const int c = 2 * j + h;
      const int key = k0 + c;
      float ds = 0.0f;
      if (valid && key < kend) {
        const int kr = key / kw;
        const float s2 = Sw[r * LDS + c] * sc + rh[kr] + rw[key - kr * kw];
        const float p = exp2f(s2 - lse2);
        ds = p * (dPw[r * LDS + c] - dlt);
      }
      Sw[r * LDS + c] = ds;
      dSw[r * LD + c] = from_f32<T>(ds);
    }
    __syncwarp();

    // rel-bias sums: each (row, bin) of this tile summed by one lane, in
    // key order
    const int b0 = k0 / kw;
    const int nb = bins_touched(k0, kend, kw);
    for (int i = lane; i < WROWS * nb; i += 32) {
      const int rr = i / nb;
      const int b = b0 + i % nb;
      const int j1 = min(b * kw + kw, kend);
      float acc = 0.0f;
      for (int j = max(b * kw, k0); j < j1; ++j) acc += Sw[rr * LDS + j - k0];
      Ghw[rr * kh + b] += acc;
    }
    const int m0 = k0 % kw;
    for (int i = lane; i < WROWS * kw; i += 32) {
      const int rr = i / kw;
      const int c = i % kw;
      float acc = 0.0f;
      for (int j = k0 + (c - m0 + kw) % kw; j < kend; j += kw)
        acc += Sw[rr * LDS + j - k0];
      Gww[rr * kw + c] += acc;
    }

    dqa.mma(dSw, Ks, lane);
    __syncwarp();
  }

  dqa.store(Sw, lane);
  __syncwarp();
  store_rows<T>(dq + base, Sw, q0 + warp * WROWS, L, scale, lane);
  for (int i = lane; i < WROWS * kh; i += 32) {
    const int gq = q0 + warp * WROWS + i / kh;
    if (gq < L)
      drel_h[((size_t)bh * L + gq) * kh + i % kh] = from_f32<T>(Ghw[i]);
  }
  for (int i = lane; i < WROWS * kw; i += 32) {
    const int gq = q0 + warp * WROWS + i / kw;
    if (gq < L)
      drel_w[((size_t)bh * L + gq) * kw + i % kw] = from_f32<T>(Gww[i]);
  }
}

// (b) dk and dv of one 64-key tile
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_relpos_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ rel_h,
                            const T* __restrict__ rel_w,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, int L,
                            int kh, int kw, int nbmax, float scale) {
  constexpr int LD = Tile<T>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BT * LD;
  T* Qs = Vs + BT * LD;
  T* dOs = Qs + BT * LD;
  T* Ps = dOs + BT * LD;
  T* dSs = Ps + BT * LD;
  float* Ss = reinterpret_cast<float*>(dSs + BT * LD);
  float* dPs = Ss + BT * LDS;
  float* Rh = dPs + BT * LDS;   // (BT queries, nbmax) rel_h * log2(e)
  float* Rw = Rh + BT * nbmax;  // (BT queries, kw)
  float* Lse2 = Rw + BT * kw;   // (BT) lse * log2(e)
  float* Dlt = Lse2 + BT;       // (BT) delta

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t base = (size_t)bh * L * D;

  load_tile(Ks, k + base, k0, L, tid);
  load_tile(Vs, v + base, k0, L, tid);

  const int kend = min(k0 + BT, L);
  const int b0 = k0 / kw;
  const int nb = bins_touched(k0, kend, kw);
  const int r = lane >> 1;
  const int h = lane & 1;
  const int key = k0 + warp * WROWS + r;
  const bool kvalid = key < L;
  const int kr = kvalid ? key / kw - b0 : 0;  // bin, local to the tile
  const int kc = kvalid ? key % kw : 0;
  const T* Kw = Ks + warp * WROWS * LD;
  const T* Vw = Vs + warp * WROWS * LD;
  T* Pw = Ps + warp * WROWS * LD;
  T* dSw = dSs + warp * WROWS * LD;
  float* Sw = Ss + warp * WROWS * LDS;
  float* dPw = dPs + warp * WROWS * LDS;
  const float sc = scale * LOG2E;
  Acc<T> dka, dva;
  dka.zero();
  dva.zero();

  for (int q0 = 0; q0 < L; q0 += BT) {
    __syncthreads();  // the previous query tile is consumed
    load_tile(Qs, q + base, q0, L, tid);
    load_tile(dOs, dout + base, q0, L, tid);
    for (int i = tid; i < BT * nb; i += THREADS) {
      const int qr = q0 + i / nb;
      Rh[(i / nb) * nbmax + i % nb] = qr < L
          ? to_f32(rel_h[((size_t)bh * L + qr) * kh + b0 + i % nb]) * LOG2E
          : 0.0f;
    }
    for (int i = tid; i < BT * kw; i += THREADS) {
      const int qr = q0 + i / kw;
      Rw[i] = qr < L
          ? to_f32(rel_w[((size_t)bh * L + qr) * kw + i % kw]) * LOG2E
          : 0.0f;
    }
    for (int i = tid; i < BT; i += THREADS) {
      const bool ok = q0 + i < L;
      Lse2[i] = ok ? lse[(size_t)bh * L + q0 + i] * LOG2E : 0.0f;
      Dlt[i] = ok ? delta[(size_t)bh * L + q0 + i] : 0.0f;
    }
    __syncthreads();

    warp_abt<T>(Kw, Qs, Sw, lane);    // S^T: 16 keys x 64 queries
    warp_abt<T>(Vw, dOs, dPw, lane);  // dP^T
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < BT / 2; ++j) {
      const int c = 2 * j + h;  // query within the tile
      float p = 0.0f;
      float ds = 0.0f;
      if (kvalid && q0 + c < L) {
        const float s2 = Sw[r * LDS + c] * sc + Rh[c * nbmax + kr]
                         + Rw[c * kw + kc];
        p = exp2f(s2 - Lse2[c]);
        ds = p * (dPw[r * LDS + c] - Dlt[c]);
      }
      Pw[r * LD + c] = from_f32<T>(p);
      dSw[r * LD + c] = from_f32<T>(ds);
    }
    __syncwarp();

    dva.mma(Pw, dOs, lane);  // (16 keys x 64 q) . (64 q x D)
    dka.mma(dSw, Qs, lane);
    __syncwarp();
  }

  dva.store(Sw, lane);
  __syncwarp();
  store_rows<T>(dv + base, Sw, k0 + warp * WROWS, L, 1.0f, lane);
  __syncwarp();
  dka.store(Sw, lane);
  __syncwarp();
  store_rows<T>(dk + base, Sw, k0 + warp * WROWS, L, scale, lane);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* rel_h,
           const void* rel_w, const void* dout, const void* lse,
           const void* delta, void* dq, void* dk, void* dv, void* drel_h,
           void* drel_w, int bh, int L, int kh, int kw, float scale,
           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + BT - 1) / BT, bh);
  const size_t smem_a = dq_smem_bytes<T>(kh, kw);
  cudaError_t err = cudaFuncSetAttribute(
      flash_relpos_bwd_dq_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  flash_relpos_bwd_dq_kernel<T><<<grid, THREADS, smem_a, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(rel_h),
      static_cast<const T*>(rel_w), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), static_cast<T*>(drel_h), static_cast<T*>(drel_w),
      L, kh, kw, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int nbmax = kh < (BT - 1) / kw + 2 ? kh : (BT - 1) / kw + 2;
  const size_t smem_b = dkv_smem_bytes<T>(nbmax, kw);
  err = cudaFuncSetAttribute(flash_relpos_bwd_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  flash_relpos_bwd_dkv_kernel<T><<<grid, THREADS, smem_b, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(rel_h),
      static_cast<const T*>(rel_w), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), L, kh, kw, nbmax, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_relpos_bwd_bf16(const void* q, const void* k, const void* v,
                          const void* rel_h, const void* rel_w,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, void* dk, void* dv,
                          void* drel_h, void* drel_w, int bh, int L, int kh,
                          int kw, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, rel_h, rel_w, dout, lse, delta, dq,
                               dk, dv, drel_h, drel_w, bh, L, kh, kw, scale,
                               stream);
}

int flash_relpos_bwd_f32(const void* q, const void* k, const void* v,
                         const void* rel_h, const void* rel_w,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, void* dk, void* dv, void* drel_h,
                         void* drel_w, int bh, int L, int kh, int kw,
                         float scale, void* stream) {
  return launch<float>(q, k, v, rel_h, rel_w, dout, lse, delta, dq, dk, dv,
                       drel_h, drel_w, bh, L, kh, kw, scale, stream);
}

const char* flash_relpos_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
