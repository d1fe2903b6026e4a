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
// The softmax runs in fp32 with a running max (online softmax); P is
// rounded to the input type before P.V, and P.V accumulates in fp32.
//
// What bounds it on an H100. Operations: 4 * BH * L^2 * 64 FLOP of two
// matrix products against ~1 MB of IO per head at L = 1568 (~600 FLOP per
// byte, above the card's balance point of ~295), so memory is no limit.
// At head_dim 64 a logit costs 256 FLOP of products, so the tensor cores
// (989 TFLOP/s bf16, 4096 FLOP per clock per SM) produce 16 logits per
// clock per SM -- and each logit needs one exp2f, which the SFUs run at 16
// per clock per SM. The exponentials alone take as long as the products
// (3.15e8 exp2f at BH = 128, L = 1568: 0.081 ms at 1.83 GHz, the same as
// the 0.0815 ms product bound), and the rest of the per-logit fp32 work
// (scale and bias, max, sum, bf16 convert) comes close to the 128 FP32
// lanes too. So the design keeps the softmax in registers, off shared
// memory, and lets one warpgroup's softmax run beside the other's products.
//
// bf16 design (sm_90a): one CTA per (128 query rows, bh) of three
// warpgroups. Warpgroup 2 is the producer: one thread starts TMA copies
// (3-D tensor maps of (64, L, BH), 128-byte swizzle, so the ragged last
// tile of a head is zero-filled at the head's end) -- Q once, then K and V
// tiles of 112 keys through a ring of 4 stages guarded by full / empty
// mbarriers -- and the warpgroup gives its registers up (setmaxnreg 24;
// the consumers take 240). Each consumer warpgroup owns 64 query rows, two
// per thread (r, r + 8), and runs a software pipeline per key tile t:
//   start S(t) = Q.K_t^T   wgmma m64n112k16, A and B from swizzled smem,
//   start O += P(t-1).V(t-1)  wgmma m64n64k16, A (P, bf16) from registers,
//                             B (V, MN-major) from smem;
//   wait for S(t) only, and run its softmax on the accumulator fragment
//   while the tensor cores finish P(t-1).V(t-1): each row lives in 4
//   threads (quad shuffles for the max; the sum stays per thread until
//   the end); then O is rescaled in registers and P(t) converted to bf16
//   in registers, where S's accumulator layout is the A-fragment layout of
//   the next P.V.
// Both products run on wgmma; nothing of S, P or O goes to shared memory.
// The two consumer warpgroups start their products in turns (named
// barriers), so one's softmax runs while the other's products keep the
// tensor cores busy.
// Rel terms do not go by TMA (a row of rel_w is 56 bytes at kw = 28, and a
// tensor map needs 16-byte strides). The CTA's rows of rel_h and of rel_w
// are two contiguous blocks: while Q and the first two K/V tiles fly, they
// are copied raw by 16-byte cp.async into ring stages 2-3 and rewritten
// once as fp32 pairs (row r, row r + 8) pre-scaled by log2(e); only then do
// stages 2-3 take their tiles. With kw dividing the 112-key tile (56x28,
// 14x14) every tile starts a grid row, so a column's rel_w pair stays in
// registers for the whole loop and a tile costs 4 (or 8) shared loads of
// rel_h pairs; other grids gather their biases into registers while the
// tile's S is in flight (a key's grid row is (key + 0.5) / kw in fp32).
//
// The fp32 instantiation is scalar code (one CTA of 4 warps per 64-row
// query tile, 64-key tiles through shared memory, FMAs): it exists so an
// fp32 end-to-end comparison can be held to a tight tolerance, not for
// speed.
//
// The launcher allocates nothing and does not synchronize; it returns
// cudaGetLastError() (or the tensor-map encoder's failure as
// cudaErrorInvalidValue) so the caller can raise on a refused launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_relpos_common.cuh"

namespace {

constexpr int D = 64;  // head dim
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// fp32: scalar reference-grade kernel
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 64;           // keys per streamed tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WROWS = BQ / WARPS;  // query rows per warp (16)
constexpr int LD = D + 4;          // row stride of every tile / buffer

// rows [row0, row0 + 64) of a (L, D) matrix into shared memory; rows past
// L are zero-filled (zero V rows keep masked keys out of P.V)
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int L, int tid) {
  constexpr int CHUNKS = D / 4;
  for (int i = tid; i < BQ * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 4;
    const int gr = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < L) val = *reinterpret_cast<const float4*>(src + (size_t)gr * D + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

size_t smem_bytes(int kh, int kw) {
  return 6 * (size_t)BQ * LD * sizeof(float)       // Q, K, V, P, S, O
         + (size_t)BQ * (kh + kw) * sizeof(float);  // rel terms
}

// lane owns row lane/2 of its warp's 16 and the columns of parity lane%2
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ rel_h,
           const float* __restrict__ rel_w, float* __restrict__ out,
           float* __restrict__ lse, int L, int kh, int kw, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  float* Ss = Ps + BQ * LD;
  float* Os = Ss + BQ * LD;
  float* Rh = Os + BQ * LD;  // (BQ, kh), pre-scaled by log2(e)
  float* Rw = Rh + BQ * kh;  // (BQ, kw)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t base = (size_t)bh * L * D;

  load_tile(Qs, q + base, q0, L, tid);
  for (int i = tid; i < BQ * kh; i += THREADS) {
    const int qr = q0 + i / kh;
    Rh[i] = qr < L ? rel_h[((size_t)bh * L + qr) * kh + i % kh] * LOG2E : 0.f;
  }
  for (int i = tid; i < BQ * kw; i += THREADS) {
    const int qr = q0 + i / kw;
    Rw[i] = qr < L ? rel_w[((size_t)bh * L + qr) * kw + i % kw] * LOG2E : 0.f;
  }
  for (int i = tid; i < BQ * LD; i += THREADS) Os[i] = 0.f;

  const int r = lane >> 1;
  const int h = lane & 1;
  const int row = warp * WROWS + r;
  const float* Qr = Qs + row * LD;
  float* Pw = Ps + row * LD;
  float* Sw = Ss + row * LD;
  float* Ow = Os + row * LD;
  const float* rh = Rh + row * kh;
  const float* rw = Rw + row * kw;
  const float sc = scale * LOG2E;
  float m = -INFINITY;  // running row max (exp2 domain)
  float l = 0.f;        // running row sum of exp2(s - m)

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous tile's K / V are consumed
    load_tile(Ks, k + base, k0, L, tid);
    load_tile(Vs, v + base, k0, L, tid);
    __syncthreads();

    float qr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = Qr[d];
    for (int j = 0; j < BK / 2; ++j) {
      const float* kr = Ks + (2 * j + h) * LD;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
      Sw[2 * j + h] = acc;
    }

    float sv[BK / 2];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + h;
      const int key = k0 + c;
      float x = -INFINITY;  // ragged tail: masked before the max
      if (key < L) {
        const int kr = key / kw;
        x = Sw[c] * sc + rh[kr] + rw[key - kr * kw];
      }
      sv[j] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    // column k0 < L is valid in every tile, so m_new is finite
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const float pj = exp2f(sv[j] - m_new);
      psum += pj;
      Pw[2 * j + h] = pj;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();

    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = Ow[2 * j + h] * alpha;
    for (int kk = 0; kk < BK; ++kk) {
      const float pk = Pw[kk];
      const float* vr = Vs + kk * LD;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] = fmaf(pk, vr[2 * j + h], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < D / 2; ++j) Ow[2 * j + h] = acc[j];
    __syncwarp();
  }

  const int qr = q0 + row;
  if (qr < L) {
    const float inv = 1.f / l;
    float* og = out + base + (size_t)qr * D;
#pragma unroll
    for (int j = 0; j < D / 2; ++j) og[2 * j + h] = Ow[2 * j + h] * inv;
    if (h == 0) lse[(size_t)bh * L + qr] = (m + log2f(l)) * LN2;
  }
}

int launch(const void* q, const void* k, const void* v, const void* rel_h,
           const void* rel_w, void* out, void* lse, int bh, int L, int kh,
           int kw, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(kh, kw);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BQ - 1) / BQ, bh);
  fwd_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<float*>(out),
      static_cast<float*>(lse), L, kh, kw, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, warp-specialized
// ---------------------------------------------------------------------------

namespace hop {

constexpr int BM = 128;          // query rows per CTA (2 consumer warpgroups)
constexpr int BN = 112;          // keys per K / V tile
constexpr int STAGES = 4;        // K / V ring depth
static_assert(STAGES >= 4, "stages 2-3 stage the raw rel terms");
constexpr int THREADS = 384;     // warpgroups 0, 1 consume; 2 produces
constexpr int CONSUMERS = 256;
constexpr int ROW_BYTES = D * 2;           // one 128-byte swizzle row
constexpr int Q_BYTES = BM * ROW_BYTES;    // 16 KiB
constexpr int KV_BYTES = BN * ROW_BYTES;   // 14 KiB, a multiple of 1024
constexpr int NJ = BN / 8;                 // 8-key column blocks of S (14)
constexpr int NS = BN / 2;                 // S accumulator floats (56)
constexpr int NKS = BN / 16;               // k16 steps of P . V (7)

static_assert(KV_BYTES % 1024 == 0, "swizzled tiles stay 1024-aligned");

// shared memory: [Q | K0 V0 | ... | K3 V3 | barriers | rel pairs]
constexpr int OFF_K = Q_BYTES;
constexpr int STAGE_BYTES = 2 * KV_BYTES;
constexpr int OFF_BAR = OFF_K + STAGES * STAGE_BYTES;
constexpr int OFF_REL = OFF_BAR + 128;

__host__ __device__ constexpr int rel_stride(int kh, int kw) {
  // float2 entries per row pair; odd, so 8 row pairs hit 8 bank groups
  return (kh + kw) | 1;
}

size_t smem_bytes(int kh, int kw) {
  return 1024 + OFF_REL + (size_t)(BM / 2) * rel_stride(kh, kw) * 8;
}

using namespace relpos;

// D (m64n112, fp32) (+)= A (smem) . B (smem), both K-major, bf16
__device__ __forceinline__ void wgmma_m64n112k16_ss(float (&d)[56], uint64_t da,
                                                    uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
      : "l"(da), "l"(db), "r"(acc));
}

// The rel bias of the thread's logits, rows (r, r + 8) as a float2, for the
// columns c = 8j + 2tq + e of a key tile; -inf for keys past L.
//
// Bias<KW> with KW > 0 is the path for kw == KW dividing the tile (56x28,
// 14x14): every tile starts a grid row, so a column's grid column c % KW is
// the same in every tile and its rel_w pair stays in registers (14 pairs:
// 8 * 7 columns span 56, a multiple of KW), and the tile's BN / KW grid rows
// are 4 or 8 shared loads per tile; a column picks its grid row at compile
// time, or by one compare on tq where a row boundary cuts its 8-column
// block. Keys past L are the grid rows past kh, whose rel_h is set to -inf.
template <int KW>
struct Bias {
  static constexpr int NB = BN / KW;
  static_assert(BN % KW == 0 && 56 % KW == 0, "KW divides the tile");
  const float2* rrow;
  int kh, tq;
  float2 rw[7][2];
  float2 rh[NB];

  __device__ void init(const float2* r, int kh_, int kw, int L, int tq_) {
    rrow = r;
    kh = kh_;
    tq = tq_;
#pragma unroll
    for (int jj = 0; jj < 7; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) rw[jj][e] = rrow[kh + (8 * jj + 2 * tq + e) % KW];
  }
  __device__ void tile(int t) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int bin = t * NB + b;
      rh[b] = bin < kh ? rrow[bin] : make_float2(-INFINITY, -INFINITY);
    }
  }
  __device__ float2 get(int j, int e) const {
    const int lo = 8 * j / KW;
    const int hi = (8 * j + 7) / KW;
    float2 h = rh[lo];
    if (hi != lo && 2 * tq + e >= hi * KW - 8 * j) h = rh[hi];
    const float2 w = rw[j % 7][e];
    return make_float2(h.x + w.x, h.y + w.y);
  }
};

// any kw: the tile's biases are gathered into registers while the tile's
// S = Q.K^T runs; a key's grid row is (key + 0.5) / kw in fp32, exact for
// keys below 2^22
template <>
struct Bias<0> {
  const float2* rrow;
  int kh, kw, L, tq;
  float inv_kw;
  float2 b[NJ][2];

  __device__ void init(const float2* r, int kh_, int kw_, int L_, int tq_) {
    rrow = r;
    kh = kh_;
    kw = kw_;
    L = L_;
    tq = tq_;
    inv_kw = 1.f / (float)kw;
  }
  __device__ void tile(int t) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t * BN + 8 * j + 2 * tq + e;
        const int kr = (int)(((float)key + 0.5f) * inv_kw);
        const int kc = key - kr * kw;
        float2 x = make_float2(-INFINITY, -INFINITY);
        if (key < L) {
          const float2 h = rrow[kr];
          const float2 w = rrow[kh + kc];
          x = make_float2(h.x + w.x, h.y + w.y);
        }
        b[j][e] = x;
      }
  }
  __device__ float2 get(int j, int e) const { return b[j][e]; }
};

// One consumer warpgroup's 64 query rows, software-pipelined: S(t) = Q.K_t^T
// and O += P(t-1).V(t-1) are started together; the softmax of S(t) runs
// while the tensor cores finish P(t-1).V(t-1); then O is rescaled and P(t)
// packed into the A fragments of the next product. Tile 0 and the last P.V
// are peeled off, so the steady-state loop starts its wgmma unconditionally.
template <int KW>
struct Consumer {
  uint32_t s_base, bar_full, bar_empty;
  uint64_t dq;
  float sc;
  Bias<KW> bias;
  float s[NS];
  uint32_t pa[NKS][4];
  float o[32];
  float m0, m1, l0, l1;  // running row maxima (exp2 domain), partial sums

  __device__ uint32_t kv(int st) const {
    return s_base + OFF_K + st * STAGE_BYTES;
  }
  int wg;
  // the two consumer warpgroups start their products in turns (named
  // barriers 1 and 2), so one's softmax runs beside the other's products
  __device__ void turn_begin() const {
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  }
  __device__ void turn_end() const {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
  }
  __device__ void wait_kv(int t) const {
    mbar_wait(bar_full + 8 * (t % STAGES), (t / STAGES) & 1);
  }
  __device__ void start_s(int t) {
    const int st = t % STAGES;
    const uint64_t dk = desc_sw128(kv(st), 16, 1024);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n112k16_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
    wgmma_commit();
  }
  __device__ void start_pv(int t) {
    const uint64_t dv = desc_sw128(kv(t % STAGES) + KV_BYTES, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk)
      wgmma_m64n64k16_rs(o, pa[kk], dv + (uint64_t)(kk * 16 * ROW_BYTES >> 4));
    wgmma_commit();
  }
  // logits in the exp2 domain (s * scale * log2e + rel_h + rel_w), the
  // online max, P = exp2(logit - max) in fp32; returns the O rescales
  __device__ float2 softmax() {
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 b = bias.get(j, e);
        s[4 * j + e] = fmaf(s[4 * j + e], sc, b.x);
        s[4 * j + 2 + e] = fmaf(s[4 * j + 2 + e], sc, b.y);
        mx0 = fmaxf(mx0, s[4 * j + e]);
        mx1 = fmaxf(mx1, s[4 * j + 2 + e]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // the first key of every tile is valid, so the new maxima are finite
    const float n0 = fmaxf(m0, mx0);
    const float n1 = fmaxf(m1, mx1);
    const float2 alpha = make_float2(exp2f(m0 - n0), exp2f(m1 - n1));
    m0 = n0;
    m1 = n1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = exp2f(s[4 * j + e] - n0);
        s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - n1);
        ps0 += s[4 * j + e];
        ps1 += s[4 * j + 2 + e];
      }
    l0 = l0 * alpha.x + ps0;
    l1 = l1 * alpha.y + ps1;
    return alpha;
  }
  // O *= alpha; S's accumulator layout is the A-fragment layout of P.V
  __device__ void rescale_and_pack(float2 alpha) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= alpha.x;
      o[4 * j + 1] *= alpha.x;
      o[4 * j + 2] *= alpha.y;
      o[4 * j + 3] *= alpha.y;
    }
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }

  __device__ void run(uint32_t bar_q, int nt) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    m0 = m1 = -INFINITY;
    l0 = l1 = 0.f;
    mbar_wait(bar_q, 0);
    // warpgroup 0 takes the first turn at the tensor cores
    if (wg == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");

    wait_kv(0);
    turn_begin();
    wgmma_fence();
    start_s(0);
    turn_end();
    bias.tile(0);
    wgmma_wait0();
    fence_regs(s);
    rescale_and_pack(softmax());

    for (int t = 1; t < nt; ++t) {
      wait_kv(t);
      fence_regs(s);
      fence_regs(o);
      fence_u32(pa);
      turn_begin();
      wgmma_fence();
      start_s(t);
      start_pv(t - 1);
      turn_end();
      bias.tile(t);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs(s);
      const float2 alpha = softmax();
      wgmma_wait0();  // P(t-1).V(t-1) is done: its stage and fragments
      fence_regs(o);
      fence_u32(pa);
      mbar_arrive(bar_empty + 8 * ((t - 1) % STAGES));
      rescale_and_pack(alpha);
    }

    fence_regs(o);
    fence_u32(pa);
    turn_begin();
    wgmma_fence();
    start_pv(nt - 1);
    turn_end();
    wgmma_wait0();
    fence_regs(o);
    mbar_arrive(bar_empty + 8 * ((nt - 1) % STAGES));
  }
};

template <int KW>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           const __nv_bfloat16* __restrict__ rel_h,
           const __nv_bfloat16* __restrict__ rel_w,
           __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int L,
           int kh, int kw, float scale) {
  extern __shared__ unsigned char smem_raw[];
  // swizzled TMA tiles want 1024-byte alignment
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_full = s_base + OFF_BAR;          // STAGES x 8 bytes
  const uint32_t bar_empty = bar_full + 8 * STAGES;    // STAGES x 8 bytes
  const uint32_t bar_q = bar_empty + 8 * STAGES;
  float2* rel = reinterpret_cast<float2*>(smem + OFF_REL);
  const int rs = rel_stride(kh, kw);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int nt = (L + BN - 1) / BN;

  // one thread of the producer warpgroup keeps the TMA ring full
  auto load_kv = [&](int t) {
    const int st = t % STAGES;
    const uint32_t dst = s_base + OFF_K + st * STAGE_BYTES;
    mbar_expect_tx(bar_full + 8 * st, 2 * KV_BYTES);
    tma_load(dst, &tm_k, t * BN, bh, bar_full + 8 * st);
    tma_load(dst + KV_BYTES, &tm_v, t * BN, bh, bar_full + 8 * st);
  };
  // stages 2 and 3 first stage the CTA's raw rel terms
  const int first = nt < 2 ? nt : 2;
  if (tid == 256) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, CONSUMERS);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // Q and the first tiles fly while the CTA gathers its rel terms
    mbar_expect_tx(bar_q, Q_BYTES);
    tma_load(s_base, &tm_q, q0, bh, bar_q);
    for (int t = 0; t < first; ++t) load_kv(t);
  }
  // the CTA's rows of rel_h and of rel_w are two contiguous blocks: copied
  // raw into stages 2-3, then rewritten as fp32 pairs (row r, row r + 8) of
  // the rows one consumer thread holds, pre-scaled by log2(e); 0 past L
  {
    const int rows = min(BM, L - q0);
    __nv_bfloat16* raw_h =
        reinterpret_cast<__nv_bfloat16*>(smem + OFF_K + 2 * STAGE_BYTES);
    __nv_bfloat16* raw_w = raw_h + ((rows * kh + 8 + 7) & ~7);
    const int dh = relpos::copy_block(
        raw_h, rel_h + ((size_t)bh * L + q0) * kh, rows * kh, tid, THREADS);
    const int dw = relpos::copy_block(
        raw_w, rel_w + ((size_t)bh * L + q0) * kw, rows * kw, tid, THREADS);
    relpos::cp_async_commit();
    relpos::cp_async_wait_all();
    __syncthreads();
    const int pi = tid / 6;  // 64 row pairs, 6 threads each
    const int r0 = (pi >> 3) * 16 + (pi & 7);  // (warpgroup, warp, g)
    const bool v0 = r0 < rows;
    const bool v1 = r0 + 8 < rows;
    for (int c = tid - 6 * pi; c < kh + kw; c += 6) {
      const __nv_bfloat16* src = c < kh ? raw_h + dh + c : raw_w + dw + c - kh;
      const int ld = c < kh ? kh : kw;
      const float x0 = v0 ? __bfloat162float(src[r0 * ld]) : 0.f;
      const float x1 = v1 ? __bfloat162float(src[(r0 + 8) * ld]) : 0.f;
      rel[pi * rs + c] = make_float2(x0 * LOG2E, x1 * LOG2E);
    }
    // the staging is read: TMA (the async proxy) may refill stages 2-3
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      for (int t = first; t < nt; ++t) {
        mbar_wait(bar_empty + 8 * (t % STAGES), ((t / STAGES) & 1) ^ 1);
        load_kv(t);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = tid & 31;
    const int warp = (tid & 127) >> 5;
    const int g = lane >> 2;
    const int tq = lane & 3;
    Consumer<KW> c;
    c.s_base = s_base;
    c.wg = wg;
    c.bar_full = bar_full;
    c.bar_empty = bar_empty;
    c.dq = desc_sw128(s_base + wg * 64 * ROW_BYTES, 16, 1024);
    c.sc = scale * LOG2E;
    c.bias.init(rel + (wg * 32 + warp * 8 + g) * rs, kh, kw, L, tq);
    c.run(bar_q, nt);
    float l0 = c.l0, l1 = c.l1;
    const float m0 = c.m0, m1 = c.m1;
    const float(&o)[32] = c.o;

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / l0;
    const float i1 = 1.f / l1;
    const int g0 = q0 + wg * 64 + warp * 16 + g;
    const int g1 = g0 + 8;
    __nv_bfloat16* ob = out + (size_t)bh * L * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * tq;
      if (g0 < L)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)g0 * D + c) =
            __floats2bfloat162_rn(o[4 * j] * i0, o[4 * j + 1] * i0);
      if (g1 < L)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)g1 * D + c) =
            __floats2bfloat162_rn(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
    }
    if (tq == 0) {
      if (g0 < L) lse[(size_t)bh * L + g0] = (m0 + log2f(l0)) * LN2;
      if (g1 < L) lse[(size_t)bh * L + g1] = (m1 + log2f(l1)) * LN2;
    }
  }
}

int launch(const void* q, const void* k, const void* v, const void* rel_h,
           const void* rel_w, void* out, void* lse, int bh, int L, int kh,
           int kw, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, bh, L, BM) || !make_map(&tk, k, bh, L, BN) ||
      !make_map(&tv, v, bh, L, BN))
    return (int)cudaErrorInvalidValue;
  // kw dividing the tile takes the register path of its rel_w terms
  auto kernel = kw == 28 ? fwd_kernel<28> : kw == 14 ? fwd_kernel<14>
                                                     : fwd_kernel<0>;
  const size_t smem = smem_bytes(kh, kw);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BM - 1) / BM, bh);
  kernel<<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<const __nv_bfloat16*>(rel_h),
      static_cast<const __nv_bfloat16*>(rel_w),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), L, kh, kw,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace hop

}  // namespace

extern "C" {

int flash_relpos_fwd_bf16(const void* q, const void* k, const void* v,
                          const void* rel_h, const void* rel_w, void* out,
                          void* lse, int bh, int L, int kh, int kw,
                          float scale, void* stream) {
  return hop::launch(q, k, v, rel_h, rel_w, out, lse, bh, L, kh, kw, scale,
                     static_cast<cudaStream_t>(stream));
}

int flash_relpos_fwd_f32(const void* q, const void* k, const void* v,
                         const void* rel_h, const void* rel_w, void* out,
                         void* lse, int bh, int L, int kh, int kw,
                         float scale, void* stream) {
  return f32::launch(q, k, v, rel_h, rel_w, out, lse, bh, L, kh, kw, scale,
                     static_cast<cudaStream_t>(stream));
}

const char* flash_relpos_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
