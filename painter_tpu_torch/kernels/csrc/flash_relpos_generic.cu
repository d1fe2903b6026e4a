// Width-generic attention with a decomposed relative-position bias:
// forward (K1g) and backward (K2g), at every head dim and key grid.
//
// Replaces the TPU kernels painter_tpu/kernels/flash_relpos.py:_fwd_impl
// (K1g) and _bwd_impl (K2g) at the shapes the ViT-L kernels of
// flash_relpos_fwd.cu / flash_relpos_bwd.cu are not built for: head dims
// other than 64, and key grids past their rel-term limits (K1: kh + kw <=
// 190; K2: kh + kw <= 127, its bf16 dq kernel's rel-term staging, and in
// bf16 a grid width in [10, 40]). The wrapper (kernels/flash_relpos.py
// attention_route) sends a shape here by its shape alone; the JAX
// kernel's domain, hd + min(kh, kw) <= 128, is the domain of this file.
//
// Contracts: those of flash_relpos_fwd.cu and flash_relpos_bwd.cu, at a
// head dim D in {16, 32, 64, 128} (templates, each in bf16 and fp32). The
// wrapper zero-pads q, k, v and dout to the next D (8 -> 16, 120 -> 128):
// zero columns add nothing to q.k or dout.v, the padded columns of out,
// dq, dk and dv come out zero and are sliced off, and the scale stays the
// real head dim's. P is rounded to the input type before P.V and dv, dS
// before dq, dk and both rel-bias sums, as in the ViT-L kernels; every
// product and sum runs in fp32.
//
// What bounds it on an H100: operations, as the ViT-L kernels (4 BH L^2 D
// FLOP forward, 10 BH L^2 D backward against a few MB of IO per head), but
// these are scalar fp32 FMAs (67 TFLOP/s), not tensor-core products: the
// design is the simple one, right first; speed is later work (ROADMAP).
//
// Design. One CTA of 4 warps per 64-row tile; the other side streams
// through shared memory in 64-row tiles converted to fp32 (rows past L
// zero-filled). Each warp owns 16 rows; a lane owns one row and the 32
// keys of its parity in a tile (logits in registers), and for the
// (16 x D) accumulators the columns 8i + 4h + [0, 4) (16-byte shared
// loads that two half-warps take from different banks).
//   K1g: online softmax (running max and sum, exp2 domain), P through
//        the warp's shared rows into P.V.
//   K2g: two kernels, as K2 -- (a) dq and the rel-bias gradients per
//        query tile, walking the key tiles; (b) dk and dv per key tile,
//        walking the query tiles in the transposed orientation -- so
//        nothing needs atomics and two runs give the same bits.
// The rel terms are read from global memory through L1 / L2 (no limit on
// kh + kw); a key's grid cell is walked incrementally, two keys a step.
// d rel_h and d rel_w are fp32 sums owned by the rows' warp in (a): per
// key tile, each (row, grid row) and (row, grid column) the tile touches
// is summed by one lane in key order and added to the row's fp32 scratch
// (bh, L, kh) / (bh, L, kw) in global memory (zeroed by the warp first);
// at the end the warp writes its rows in the input type. The sums run in
// a fixed order: tile by tile, key by key.
//
// The launchers allocate nothing and do not synchronize; they return
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BT = 64;             // rows of every tile (queries or keys)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WROWS = BT / WARPS;  // rows per warp (16)
constexpr int LDT = BT + 4;        // row stride of the 64-wide logit tiles
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

// 16 bytes of the input type, global -> fp32 shared memory
__device__ __forceinline__ void load16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void load16(float* dst, const bf16* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// rows [row0, row0 + BT) of a (L, D) matrix into shared memory (row stride
// D + 4); rows past L are zero (zero V rows keep masked keys out of P.V)
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int L, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  constexpr int LDD = D + 4;
  for (int i = tid; i < BT * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    const int gr = row0 + r;
    if (gr < L) {
      load16(dst + r * LDD + c, src + (size_t)gr * D + c);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[r * LDD + c + j] = 0.f;
    }
  }
}

// s[j] = A[r] . B[2 j + h] over D: A the warp's 16 rows, B a 64-row tile,
// both of row stride D + 4; lane owns row r = lane / 2 and the B rows of
// parity h = lane % 2
template <int D>
__device__ __forceinline__ void warp_abt(const float* a, const float* b,
                                         float s[BT / 2], int lane) {
  constexpr int LDD = D + 4;
  const int r = lane >> 1;
  const int h = lane & 1;
#pragma unroll
  for (int j = 0; j < BT / 2; ++j) s[j] = 0.f;
#pragma unroll 1
  for (int d0 = 0; d0 < D; d0 += 8) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + r * LDD + d0);
    const float4 a1 = *reinterpret_cast<const float4*>(a + r * LDD + d0 + 4);
#pragma unroll
    for (int j = 0; j < BT / 2; ++j) {
      const float* br = b + (2 * j + h) * LDD + d0;
      const float4 b0 = *reinterpret_cast<const float4*>(br);
      const float4 b1 = *reinterpret_cast<const float4*>(br + 4);
      float acc = s[j];
      acc = fmaf(a0.x, b0.x, acc);
      acc = fmaf(a0.y, b0.y, acc);
      acc = fmaf(a0.z, b0.z, acc);
      acc = fmaf(a0.w, b0.w, acc);
      acc = fmaf(a1.x, b1.x, acc);
      acc = fmaf(a1.y, b1.y, acc);
      acc = fmaf(a1.z, b1.z, acc);
      acc = fmaf(a1.w, b1.w, acc);
      s[j] = acc;
    }
  }
}

// a warp's (16 x D) fp32 accumulator of A (16 x BT, stride LDT) . B
// (BT x D, stride D + 4); lane owns row lane / 2, columns 8 i + 4 h + [0, 4)
template <int D>
struct Acc {
  static constexpr int LDD = D + 4;
  static constexpr int NV = D / 8;
  float4 c[NV];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < NV; ++i) c[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void scale(float m) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      c[i].x *= m;
      c[i].y *= m;
      c[i].z *= m;
      c[i].w *= m;
    }
  }
  __device__ __forceinline__ void mma(const float* a, const float* b,
                                      int lane) {
    const int r = lane >> 1;
    const int h = lane & 1;
#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      const float ak = a[r * LDT + kk];
      const float* br = b + kk * LDD + 4 * h;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 bv = *reinterpret_cast<const float4*>(br + 8 * i);
        c[i].x = fmaf(ak, bv.x, c[i].x);
        c[i].y = fmaf(ak, bv.y, c[i].y);
        c[i].z = fmaf(ak, bv.z, c[i].z);
        c[i].w = fmaf(ak, bv.w, c[i].w);
      }
    }
  }
  // row row0 + lane / 2 of a (L, D) matrix, times mul; rows past L are
  // not written
  template <typename T>
  __device__ __forceinline__ void store(T* dst, int row0, int L, float mul,
                                        int lane) const {
    const int r = lane >> 1;
    const int h = lane & 1;
    if (row0 + r >= L) return;
    T* row = dst + (size_t)(row0 + r) * D + 4 * h;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      row[8 * i] = from_f<T>(c[i].x * mul);
      row[8 * i + 1] = from_f<T>(c[i].y * mul);
      row[8 * i + 2] = from_f<T>(c[i].z * mul);
      row[8 * i + 3] = from_f<T>(c[i].w * mul);
    }
  }
};

// ---------------------------------------------------------------------------
// K1g: forward
// ---------------------------------------------------------------------------

template <int D>
size_t fwd_smem_bytes() {
  return (3 * (size_t)BT * (D + 4) + (size_t)BT * LDT) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ rel_h,
           const T* __restrict__ rel_w, T* __restrict__ out,
           float* __restrict__ lse, int L, int kh, int kw, float scale) {
  constexpr int LDD = D + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BT * LDD;
  float* Vs = Ks + BT * LDD;
  float* Ps = Vs + BT * LDD;  // (BT, LDT): the warps' rows of P

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r = lane >> 1;
  const int h = lane & 1;
  const size_t base = (size_t)bh * L * D;

  load_tile<T, D>(Qs, q + base, q0, L, tid);
  const int qr = q0 + warp * WROWS + r;
  const bool valid = qr < L;
  const size_t row = (size_t)bh * L + (valid ? qr : 0);
  const T* rh = rel_h + row * kh;
  const T* rw = rel_w + row * kw;
  const float* Qw = Qs + warp * WROWS * LDD;
  float* Pw = Ps + warp * WROWS * LDT;
  const float sc = scale * LOG2E;
  float m = -INFINITY;  // running row max (exp2 domain)
  float l = 0.f;        // running row sum of exp2(s - m)
  Acc<D> o;
  o.zero();

  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();  // the previous tile's K / V are consumed
    load_tile<T, D>(Ks, k + base, k0, L, tid);
    load_tile<T, D>(Vs, v + base, k0, L, tid);
    __syncthreads();

    float s[BT / 2];
    warp_abt<D>(Qw, Ks, s, lane);
    int kr = (k0 + h) / kw;  // grid cell of key k0 + h + 2 j
    int kc = k0 + h - kr * kw;
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BT / 2; ++j) {
      float x = -INFINITY;  // ragged tail: masked before the max
      if (k0 + 2 * j + h < L)
        x = fmaf(s[j], sc, (to_f(rh[kr]) + to_f(rw[kc])) * LOG2E);
      s[j] = x;
      tmax = fmaxf(tmax, x);
      kc += 2;
      while (kc >= kw) {
        kc -= kw;
        ++kr;
      }
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    // key k0 < L is valid in every tile, so m_new is finite
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BT / 2; ++j) {
      const float p = exp2f(s[j] - m_new);
      psum += p;
      Pw[r * LDT + 2 * j + h] = rounded<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    o.scale(alpha);
    __syncwarp();
    o.mma(Pw, Vs, lane);
  }

  o.store(out + base, q0 + warp * WROWS, L, 1.f / l, lane);
  if (valid && h == 0) lse[(size_t)bh * L + qr] = (m + log2f(l)) * LN2;
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v,
               const void* rel_h, const void* rel_w, void* out, void* lse,
               int bh, int L, int kh, int kw, float scale,
               cudaStream_t st) {
  const size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BT - 1) / BT, bh);
  fwd_kernel<T, D><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(rel_h),
      static_cast<const T*>(rel_w), static_cast<T*>(out),
      static_cast<float*>(lse), L, kh, kw, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2g: backward
// ---------------------------------------------------------------------------

template <int D>
size_t dq_smem_bytes() {
  return (4 * (size_t)BT * (D + 4) + (size_t)BT * LDT) * sizeof(float);
}

template <int D>
size_t dkv_smem_bytes() {
  return (4 * (size_t)BT * (D + 4) + 2 * (size_t)BT * LDT + 2 * BT) *
         sizeof(float);
}

// g[idx] += acc for n (index, sum) pairs of distinct indices, the loads
// issued before the stores
template <int N>
__device__ __forceinline__ void add_to(float* g, const int idx[N],
                                       const float acc[N], int n) {
  float old[N];
#pragma unroll
  for (int u = 0; u < N; ++u)
    if (u < n) old[u] = g[idx[u]];
#pragma unroll
  for (int u = 0; u < N; ++u)
    if (u < n) g[idx[u]] = old[u] + acc[u];
}

// (a) dq and the rel-bias gradients of one 64-row query tile
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ rel_h,
          const T* __restrict__ rel_w, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, T* __restrict__ drel_h,
          T* __restrict__ drel_w, float* __restrict__ gh,
          float* __restrict__ gw, int L, int kh, int kw, float scale) {
  constexpr int LDD = D + 4;
  constexpr int BATCH = 4;  // rel-bias sums per lane in flight
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BT * LDD;
  float* Ks = dOs + BT * LDD;
  float* Vs = Ks + BT * LDD;
  float* dSs = Vs + BT * LDD;  // (BT, LDT): P, then dS

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r = lane >> 1;
  const int h = lane & 1;
  const size_t base = (size_t)bh * L * D;

  load_tile<T, D>(Qs, q + base, q0, L, tid);
  load_tile<T, D>(dOs, dout + base, q0, L, tid);

  const int wq0 = q0 + warp * WROWS;  // the warp's first row
  const int wrows = max(0, min(WROWS, L - wq0));
  const int qr = wq0 + r;
  const bool valid = qr < L;
  const size_t row = (size_t)bh * L + (valid ? qr : 0);
  const T* rh = rel_h + row * kh;
  const T* rw = rel_w + row * kw;
  // padded query rows read no lse / delta: their P and dS are forced to 0
  const float lse2 = valid ? lse[row] * LOG2E : 0.f;
  const float dlt = valid ? delta[row] : 0.f;
  // the warp's rows of the fp32 rel-bias sums: no other warp or CTA
  // writes them
  float* ghw = gh + ((size_t)bh * L + (wrows ? wq0 : 0)) * kh;
  float* gww = gw + ((size_t)bh * L + (wrows ? wq0 : 0)) * kw;
  for (int i = lane; i < wrows * kh; i += 32) ghw[i] = 0.f;
  for (int i = lane; i < wrows * kw; i += 32) gww[i] = 0.f;
  __syncwarp();

  const float* Qw = Qs + warp * WROWS * LDD;
  const float* dOw = dOs + warp * WROWS * LDD;
  float* dSw = dSs + warp * WROWS * LDT;
  const float sc = scale * LOG2E;
  Acc<D> dqa;
  dqa.zero();

  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();  // the previous tile's K / V are consumed
    load_tile<T, D>(Ks, k + base, k0, L, tid);
    load_tile<T, D>(Vs, v + base, k0, L, tid);
    __syncthreads();

    float s[BT / 2];
    warp_abt<D>(Qw, Ks, s, lane);
    int kr = (k0 + h) / kw;
    int kc = k0 + h - kr * kw;
#pragma unroll
    for (int j = 0; j < BT / 2; ++j) {
      float p = 0.f;
      if (valid && k0 + 2 * j + h < L)
        p = exp2f(fmaf(s[j], sc, (to_f(rh[kr]) + to_f(rw[kc])) * LOG2E) -
                  lse2);
      dSw[r * LDT + 2 * j + h] = p;
      kc += 2;
      while (kc >= kw) {
        kc -= kw;
        ++kr;
      }
    }
    warp_abt<D>(dOw, Vs, s, lane);  // dP
#pragma unroll
    for (int j = 0; j < BT / 2; ++j) {
      float* x = dSw + r * LDT + 2 * j + h;
      *x = rounded<T>(*x * (s[j] - dlt));
    }
    __syncwarp();

    // rel-bias sums of this tile: each (row, grid row) and (row, grid
    // column) it touches summed by one lane, in key order
    const int kend = min(k0 + BT, L);
    const int b0 = k0 / kw;
    const int nb = (kend - 1) / kw - b0 + 1;
    for (int i0 = lane; i0 < wrows * nb; i0 += 32 * BATCH) {
      int idx[BATCH];
      float acc[BATCH];
      int n = 0;
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + 32 * u;
        if (i < wrows * nb) {
          const int rr = i / nb;
          const int b = b0 + i % nb;
          const int j1 = min(b * kw + kw, kend);
          float a = 0.f;
          for (int j = max(b * kw, k0); j < j1; ++j) a += dSw[rr * LDT + j - k0];
          idx[u] = rr * kh + b;
          acc[u] = a;
          n = u + 1;
        }
      }
      add_to<BATCH>(ghw, idx, acc, n);
    }
    const int ncols = min(kw, kend - k0);
    const int m0 = k0 % kw;
    for (int i0 = lane; i0 < wrows * ncols; i0 += 32 * BATCH) {
      int idx[BATCH];
      float acc[BATCH];
      int n = 0;
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + 32 * u;
        if (i < wrows * ncols) {
          const int rr = i / ncols;
          const int t = i % ncols;
          float a = 0.f;
          for (int j = k0 + t; j < kend; j += kw) a += dSw[rr * LDT + j - k0];
          int c = m0 + t;
          if (c >= kw) c -= kw;
          idx[u] = rr * kw + c;
          acc[u] = a;
          n = u + 1;
        }
      }
      add_to<BATCH>(gww, idx, acc, n);
    }

    dqa.mma(dSw, Ks, lane);
    __syncwarp();
  }

  dqa.store(dq + base, wq0, L, scale, lane);
  __syncwarp();
  T* dh = drel_h + ((size_t)bh * L + (wrows ? wq0 : 0)) * kh;
  T* dw = drel_w + ((size_t)bh * L + (wrows ? wq0 : 0)) * kw;
  for (int i = lane; i < wrows * kh; i += 32) dh[i] = from_f<T>(ghw[i]);
  for (int i = lane; i < wrows * kw; i += 32) dw[i] = from_f<T>(gww[i]);
}

// (b) dk and dv of one 64-key tile
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ rel_h,
           const T* __restrict__ rel_w, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int L, int kh, int kw,
           float scale) {
  constexpr int LDD = D + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BT * LDD;
  float* Qs = Vs + BT * LDD;
  float* dOs = Qs + BT * LDD;
  float* Ps = dOs + BT * LDD;  // (BT keys, LDT): P^T rounded
  float* dSs = Ps + BT * LDT;  // P^T, then dS^T
  float* Lse2 = dSs + BT * LDT;
  float* Dlt = Lse2 + BT;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r = lane >> 1;
  const int h = lane & 1;
  const size_t base = (size_t)bh * L * D;

  load_tile<T, D>(Ks, k + base, k0, L, tid);
  load_tile<T, D>(Vs, v + base, k0, L, tid);

  const int key = k0 + warp * WROWS + r;
  const bool kvalid = key < L;
  const int kr = kvalid ? key / kw : 0;
  const int kc = kvalid ? key - kr * kw : 0;
  const float* Kw = Ks + warp * WROWS * LDD;
  const float* Vw = Vs + warp * WROWS * LDD;
  float* Pw = Ps + warp * WROWS * LDT;
  float* dSw = dSs + warp * WROWS * LDT;
  const float sc = scale * LOG2E;
  Acc<D> dka, dva;
  dka.zero();
  dva.zero();

  for (int q0 = 0; q0 < L; q0 += BT) {
    __syncthreads();  // the previous query tile is consumed
    load_tile<T, D>(Qs, q + base, q0, L, tid);
    load_tile<T, D>(dOs, dout + base, q0, L, tid);
    for (int i = tid; i < BT; i += THREADS) {
      const bool ok = q0 + i < L;
      Lse2[i] = ok ? lse[(size_t)bh * L + q0 + i] * LOG2E : 0.f;
      Dlt[i] = ok ? delta[(size_t)bh * L + q0 + i] : 0.f;
    }
    __syncthreads();

    float s[BT / 2];
    warp_abt<D>(Kw, Qs, s, lane);  // S^T: 16 keys x 64 queries
#pragma unroll
    for (int j = 0; j < BT / 2; ++j) {
      const int c = 2 * j + h;  // query within the tile
      float p = 0.f;
      if (kvalid && q0 + c < L) {
        const size_t qrow = (size_t)bh * L + q0 + c;
        p = exp2f(fmaf(s[j], sc,
                       (to_f(rel_h[qrow * kh + kr]) +
                        to_f(rel_w[qrow * kw + kc])) * LOG2E) -
                  Lse2[c]);
      }
      Pw[r * LDT + c] = rounded<T>(p);
      dSw[r * LDT + c] = p;
    }
    warp_abt<D>(Vw, dOs, s, lane);  // dP^T
#pragma unroll
    for (int j = 0; j < BT / 2; ++j) {
      const int c = 2 * j + h;
      float* x = dSw + r * LDT + c;
      *x = rounded<T>(*x * (s[j] - Dlt[c]));
    }
    __syncwarp();

    dva.mma(Pw, dOs, lane);  // (16 keys x 64 q) . (64 q x D)
    dka.mma(dSw, Qs, lane);
  }

  dva.store(dv + base, k0 + warp * WROWS, L, 1.f, lane);
  dka.store(dk + base, k0 + warp * WROWS, L, scale, lane);
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v,
               const void* rel_h, const void* rel_w, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, void* drel_h, void* drel_w, void* gh, void* gw,
               int bh, int L, int kh, int kw, float scale, cudaStream_t st) {
  const dim3 grid((L + BT - 1) / BT, bh);
  const size_t smem_a = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, D><<<grid, THREADS, smem_a, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(rel_h),
      static_cast<const T*>(rel_w), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), static_cast<T*>(drel_h), static_cast<T*>(drel_w),
      static_cast<float*>(gh), static_cast<float*>(gw), L, kh, kw, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_b = dkv_smem_bytes<D>();
  err = cudaFuncSetAttribute(dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<T, D><<<grid, THREADS, smem_b, st>>>(
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
           void* drel_h, void* drel_w, void* gh, void* gw, int bh, int L,
           int kh, int kw, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_bwd<T, 16>(q, k, v, rel_h, rel_w, dout, lse, delta, dq,
                               dk, dv, drel_h, drel_w, gh, gw, bh, L, kh, kw,
                               scale, st);
    case 32:
      return launch_bwd<T, 32>(q, k, v, rel_h, rel_w, dout, lse, delta, dq,
                               dk, dv, drel_h, drel_w, gh, gw, bh, L, kh, kw,
                               scale, st);
    case 64:
      return launch_bwd<T, 64>(q, k, v, rel_h, rel_w, dout, lse, delta, dq,
                               dk, dv, drel_h, drel_w, gh, gw, bh, L, kh, kw,
                               scale, st);
    case 128:
      return launch_bwd<T, 128>(q, k, v, rel_h, rel_w, dout, lse, delta, dq,
                                dk, dv, drel_h, drel_w, gh, gw, bh, L, kh,
                                kw, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// hd: the built head dim (16, 32, 64 or 128) the inputs are padded to
int flash_relpos_generic_fwd_bf16(const void* q, const void* k,
                                  const void* v, const void* rel_h,
                                  const void* rel_w, void* out, void* lse,
                                  int bh, int L, int hd, int kh, int kw,
                                  float scale, void* stream) {
  return fwd_at<bf16>(hd, q, k, v, rel_h, rel_w, out, lse, bh, L, kh, kw,
                      scale, stream);
}

int flash_relpos_generic_fwd_f32(const void* q, const void* k, const void* v,
                                 const void* rel_h, const void* rel_w,
                                 void* out, void* lse, int bh, int L, int hd,
                                 int kh, int kw, float scale, void* stream) {
  return fwd_at<float>(hd, q, k, v, rel_h, rel_w, out, lse, bh, L, kh, kw,
                       scale, stream);
}

// gh (bh, L, kh) and gw (bh, L, kw): fp32 scratch for the rel-bias sums
int flash_relpos_generic_bwd_bf16(const void* q, const void* k,
                                  const void* v, const void* rel_h,
                                  const void* rel_w, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, void* dk, void* dv,
                                  void* drel_h, void* drel_w, void* gh,
                                  void* gw, int bh, int L, int hd, int kh,
                                  int kw, float scale, void* stream) {
  return bwd_at<bf16>(hd, q, k, v, rel_h, rel_w, dout, lse, delta, dq, dk,
                      dv, drel_h, drel_w, gh, gw, bh, L, kh, kw, scale,
                      stream);
}

int flash_relpos_generic_bwd_f32(const void* q, const void* k, const void* v,
                                 const void* rel_h, const void* rel_w,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, void* dk,
                                 void* dv, void* drel_h, void* drel_w,
                                 void* gh, void* gw, int bh, int L, int hd,
                                 int kh, int kw, float scale, void* stream) {
  return bwd_at<float>(hd, q, k, v, rel_h, rel_w, dout, lse, delta, dq, dk,
                       dv, drel_h, drel_w, gh, gw, bh, L, kh, kw, scale,
                       stream);
}

const char* flash_relpos_generic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
