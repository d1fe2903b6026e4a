// Flash attention forward with a decomposed relative-position bias (Hopper).
//
// Replaces the TPU kernel painter_tpu/kernels/flash_relpos.py:_fwd_impl
// (the Pallas forward reached through flash_attention_relpos).
//
// Contract, per (batch*head) slice b and query row i < L:
//   s[i, j]  = scale * q[i] . k[j] + rel_h[i, j / kw] + rel_w[i, j % kw]
//              (keys form a row-major (kh, kw) token grid, kh * kw == L)
//   out[i]   = softmax_j(s[i, :]) . v          in the input type
//   lse[i]   = log(sum_j exp(s[i, j]))          natural log, fp32, row max
//              included -- the saved statistic a backward recomputes P from
// Inputs q, k, v (BH, L, 64), rel_h (BH, L, kh), rel_w (BH, L, kw), all
// contiguous and of one type (bf16 or fp32); rel_h / rel_w are the rel-pos
// terms (q einsum the interpolated tables), computed outside the kernel.
// The softmax runs in fp32 with a running max (online softmax); P is cast
// to the input type before P.V, and P.V accumulates in fp32.
//
// What bounds it on an H100: operations. It does about 4 * BH * L^2 * 64
// FLOP (two matrix products) while its IO is q, k, v, out and the rel
// terms -- about 1 MB per head at L = 1568 in bf16 -- so it does ~600 FLOP
// per byte of IO, above the card's balance point of ~295 (989 TFLOP/s bf16
// over 3.35 TB/s): memory is no limit.
//
// What this simple design does about it: one CTA of 4 warps per (64-row
// query tile, batch*head); K/V tiles of 64 keys stream through shared
// memory; each warp owns 16 query rows and runs both products on the
// tensor cores (WMMA 16x16x16 bf16, fp32 accumulate), so the FLOPs go to
// the unit that has them. What it does not do yet: the logits and the
// output accumulator take a round trip through shared memory every tile
// (the softmax is scalar code on a row layout, not on the fragments), the
// K/V loads are not pipelined (no cp.async / TMA ring), and it uses
// mma.sync-class WMMA rather than wgmma. Those are the known gaps between
// this kernel and the card's peak. The fp32 instantiation does both
// products in scalar FMAs: it exists so an fp32 end-to-end comparison can
// be held to a tight tolerance, not for speed.
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
constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 64;           // keys per streamed tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WROWS = BQ / WARPS;  // query rows per warp (16)
constexpr int LDS = D + 4;         // fp32 row stride of the S / O buffers
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

static_assert(BQ == BK, "Q, K and V tiles share one row count");
static_assert(WROWS == 16, "one WMMA row block per warp");

// row stride (elements) of the Q / K / V / P tiles: keeps rows 16-byte
// aligned for vector loads and 32-byte aligned at 16-row fragment starts
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
// L are zero-filled (zero V rows keep masked keys out of P.V)
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int L, int tid) {
  constexpr int LD = Tile<T>::LD;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = tid; i < BQ * CHUNKS; i += THREADS) {
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

// S (16 x BK, fp32, stride LDS) = Qw (16 x D) . K_tile^T
template <typename T>
__device__ void warp_qk(const T* q, const T* k, float* s, int lane);

template <>
__device__ void warp_qk<__nv_bfloat16>(const __nv_bfloat16* q,
                                       const __nv_bfloat16* k, float* s,
                                       int lane) {
  constexpr int LD = Tile<__nv_bfloat16>::LD;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      a[D / 16];
#pragma unroll
  for (int d = 0; d < D / 16; ++d) wmma::load_matrix_sync(a[d], q + d * 16, LD);
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int d = 0; d < D / 16; ++d) {
      // K stored (key, d) row-major is K^T in column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b;
      wmma::load_matrix_sync(b, k + n * 16 * LD + d * 16, LD);
      wmma::mma_sync(c, a[d], b, c);
    }
    wmma::store_matrix_sync(s + n * 16, c, LDS, wmma::mem_row_major);
  }
}

// fp32: lane owns row lane/2 and the columns of parity lane%2
template <>
__device__ void warp_qk<float>(const float* q, const float* k, float* s,
                               int lane) {
  constexpr int LD = Tile<float>::LD;
  const int r = lane >> 1;
  const int h = lane & 1;
  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = q[r * LD + d];
  for (int j = 0; j < BK / 2; ++j) {
    const float* kr = k + (2 * j + h) * LD;
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
    s[r * LDS + 2 * j + h] = acc;
  }
}

// O (16 x D, fp32, stride LDS) += P (16 x BK) . V_tile (BK x D)
template <typename T>
__device__ void warp_pv(const T* p, const T* v, float* o, int lane);

template <>
__device__ void warp_pv<__nv_bfloat16>(const __nv_bfloat16* p,
                                       const __nv_bfloat16* v, float* o,
                                       int lane) {
  constexpr int LD = Tile<__nv_bfloat16>::LD;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      a[BK / 16];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wmma::load_matrix_sync(a[kk], p + kk * 16, LD);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::load_matrix_sync(c, o + n * 16, LDS, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(b, v + kk * 16 * LD + n * 16, LD);
      wmma::mma_sync(c, a[kk], b, c);
    }
    wmma::store_matrix_sync(o + n * 16, c, LDS, wmma::mem_row_major);
  }
}

template <>
__device__ void warp_pv<float>(const float* p, const float* v, float* o,
                               int lane) {
  constexpr int LD = Tile<float>::LD;
  const int r = lane >> 1;
  const int h = lane & 1;
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = o[r * LDS + 2 * j + h];
  for (int kk = 0; kk < BK; ++kk) {
    const float pk = p[r * LD + kk];
    const float* vr = v + kk * LD;
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = fmaf(pk, vr[2 * j + h], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[r * LDS + 2 * j + h] = acc[j];
}

template <typename T>
size_t smem_bytes(int kh, int kw) {
  return 4 * (size_t)BQ * Tile<T>::LD * sizeof(T)      // Q, K, V, P
         + 2 * (size_t)BQ * LDS * sizeof(float)        // S, O
         + (size_t)BQ * (kh + kw) * sizeof(float);     // rel terms
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_relpos_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ rel_h,
                        const T* __restrict__ rel_w, T* __restrict__ out,
                        float* __restrict__ lse, int L, int kh, int kw,
                        float scale) {
  constexpr int LD = Tile<T>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * LD;
  T* Vs = Ks + BK * LD;
  T* Ps = Vs + BK * LD;
  float* Ss = reinterpret_cast<float*>(Ps + BQ * LD);
  float* Os = Ss + BQ * LDS;
  float* Rh = Os + BQ * LDS;  // (BQ, kh), pre-scaled by log2(e)
  float* Rw = Rh + BQ * kh;   // (BQ, kw)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t base = (size_t)bh * L * D;

  load_tile(Qs, q + base, q0, L, tid);
  for (int i = tid; i < BQ * kh; i += THREADS) {
    const int qr = q0 + i / kh;
    Rh[i] = qr < L
        ? to_f32(rel_h[((size_t)bh * L + qr) * kh + i % kh]) * LOG2E : 0.0f;
  }
  for (int i = tid; i < BQ * kw; i += THREADS) {
    const int qr = q0 + i / kw;
    Rw[i] = qr < L
        ? to_f32(rel_w[((size_t)bh * L + qr) * kw + i % kw]) * LOG2E : 0.0f;
  }
  for (int i = tid; i < BQ * LDS; i += THREADS) Os[i] = 0.0f;

  // lane -> (row r of this warp's 16, column parity h); all logits below
  // are in the exp2 domain (scaled by log2 e)
  const int r = lane >> 1;
  const int h = lane & 1;
  const int row = warp * WROWS + r;
  const T* Qw = Qs + warp * WROWS * LD;
  T* Pw = Ps + warp * WROWS * LD;
  float* Sw = Ss + warp * WROWS * LDS;
  float* Ow = Os + warp * WROWS * LDS;
  const float* rh = Rh + row * kh;
  const float* rw = Rw + row * kw;
  const float sc = scale * LOG2E;
  float m = -INFINITY;  // running row max
  float l = 0.0f;       // running row sum of exp2(s - m)

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous tile's K / V are consumed
    load_tile(Ks, k + base, k0, L, tid);
    load_tile(Vs, v + base, k0, L, tid);
    __syncthreads();

    warp_qk<T>(Qw, Ks, Sw, lane);
    __syncwarp();

    float sv[BK / 2];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + h;
      const int key = k0 + c;
      float x = -INFINITY;  // ragged tail: masked before the max
      if (key < L) {
        const int kr = key / kw;
        x = Sw[r * LDS + c] * sc + rh[kr] + rw[key - kr * kw];
      }
      sv[j] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    // column k0 < L is valid in every tile, so m_new is finite
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + h;
      const float pj = exp2f(sv[j] - m_new);
      psum += pj;
      Pw[r * LD + c] = from_f32<T>(pj);
      Ow[r * LDS + c] *= alpha;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();

    warp_pv<T>(Pw, Vs, Ow, lane);
    __syncwarp();
  }

  const int qr = q0 + row;
  if (qr < L) {
    const float inv = 1.0f / l;
    T* og = out + base + (size_t)qr * D;
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      const int c = 2 * j + h;
      og[c] = from_f32<T>(Ow[r * LDS + c] * inv);
    }
    if (h == 0) lse[(size_t)bh * L + qr] = (m + log2f(l)) * LN2;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* rel_h,
           const void* rel_w, void* out, void* lse, int bh, int L, int kh,
           int kw, float scale, void* stream) {
  const size_t smem = smem_bytes<T>(kh, kw);
  cudaError_t err = cudaFuncSetAttribute(
      flash_relpos_fwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BQ - 1) / BQ, bh);
  flash_relpos_fwd_kernel<T><<<grid, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(rel_h),
      static_cast<const T*>(rel_w), static_cast<T*>(out),
      static_cast<float*>(lse), L, kh, kw, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_relpos_fwd_bf16(const void* q, const void* k, const void* v,
                          const void* rel_h, const void* rel_w, void* out,
                          void* lse, int bh, int L, int kh, int kw,
                          float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, rel_h, rel_w, out, lse, bh, L, kh,
                               kw, scale, stream);
}

int flash_relpos_fwd_f32(const void* q, const void* k, const void* v,
                         const void* rel_h, const void* rel_w, void* out,
                         void* lse, int bh, int L, int kh, int kw,
                         float scale, void* stream) {
  return launch<float>(q, k, v, rel_h, rel_w, out, lse, bh, L, kh, kw,
                       scale, stream);
}

const char* flash_relpos_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
