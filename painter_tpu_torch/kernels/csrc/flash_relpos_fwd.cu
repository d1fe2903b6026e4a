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
// fp32 design (sm_90a, namespace tc): 3xTF32 on wgmma
// (flash_relpos_tf32.cuh: each operand split into big + small tf32 parts,
// A_small.B_big + A_big.B_small + A_big.B_big with fp32 accumulation; one
// TF32 product would miss the fp32 tolerance). Bound on an H100: the same
// 4 * BH * L^2 * 64 FLOP three times over at the TF32 rate (495 TFLOP/s
// dense, so 165 TFLOP/s of fp32-accurate products; fp32 FMAs give 67):
// 0.488 ms at BH = 128, L = 1568. The exponentials now take a sixth of the
// products' time. One CTA per (128 query rows, bh) of three warpgroups.
// Warpgroup 2 produces (setmaxnreg 40): it loads each 64-key tile of K and
// V with 16-byte loads, four in flight a thread, and writes it split, K as
// is and V transposed (dims x keys, keys in perm_col order: wgmma reads
// tf32 from shared memory K-major only), into a ring of 2 stages guarded
// by full / empty mbarriers; the split passes through registers, so TMA
// would only add a raw copy. Each consumer warpgroup (setmaxnreg 232) owns
// 64 query rows, two per thread, and holds Q as split A fragments in
// registers for the whole loop:
//   S = Q.K^T      3 x 8 wgmma m64n64k8, A from registers, B = K;
//   the online softmax on the accumulator fragments, the rel terms read
//   from shared-memory pairs as in bf16;
//   O = O * alpha + P.V   3 x 8 wgmma m64n64k8 into a zeroed tile
//                  accumulator, A = P split in registers (S's accumulator
//                  is P.V's A fragment against V^T's key order), B = V^T;
//                  the tile joins O by a rounded fmaf (the tensor cores'
//                  fp32 accumulation truncates, and O summed in them over
//                  every tile drifts toward zero: ~3e-5 relative at L 1568).
// The two consumer warpgroups overlap each other's softmax with products.
// Shared memory: 2 stages x 4 parts x 16 KiB (128 KiB) and the rel pairs,
// 512 B per kh + kw + 1 entries (smem_bytes): 175,680 B at 56x28, 194,112
// at 80x40, 229,952 at kh + kw = 190, the route's limit (room for 195);
// the CTA's raw rel terms are staged in the ring first (raw_rel_bytes).
//
// The launcher allocates nothing and does not synchronize; it returns
// cudaGetLastError() (or the tensor-map encoder's failure as
// cudaErrorInvalidValue) so the caller can raise on a refused launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_relpos_tf32.cuh"

namespace {

constexpr int D = 64;  // head dim
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// fp32: 3xTF32 wgmma, warp-specialized
// ---------------------------------------------------------------------------

namespace tc {

using namespace tf32x3;

constexpr int BM = 128;           // query rows per CTA (2 consumer warpgroups)
constexpr int BN = 64;            // keys per K / V tile
constexpr int STAGES = 2;         // K / V ring depth
constexpr int THREADS = 384;      // warpgroups 0, 1 consume; 2 produces
constexpr int CONSUMERS = 256;
constexpr int PRODUCERS = THREADS - CONSUMERS;
constexpr int BATCH = 4;          // float4 loads a producer thread keeps in flight
constexpr int PART = part_bytes(BN, D);  // one part of K or of V^T, 16 KiB
static_assert(part_bytes(D, BN) == PART, "K and V^T parts are one size");
// a stage: [K big | K small | V^T big | V^T small]
constexpr int STAGE_BYTES = 4 * PART;
// shared memory: [stages | barriers | rel pairs]; the stages first hold
// the CTA's raw rel terms
constexpr int OFF_BAR = STAGES * STAGE_BYTES;
constexpr int OFF_REL = OFF_BAR + 64;
constexpr size_t SMEM_OPTIN = 232448;  // dynamic shared memory of a block

__host__ __device__ constexpr int pair_stride(int kh, int kw) {
  return (kh + kw) | 1;  // odd: 8 row pairs hit 8 bank groups
}

size_t smem_bytes(int kh, int kw) {
  return 1024 + OFF_REL + (size_t)(BM / 2) * pair_stride(kh, kw) * 8;
}

// the CTA's raw rel_h and rel_w blocks (BM rows) in the stages
constexpr size_t raw_rel_bytes(int kh, int kw) {
  return 4 * ((size_t)block_room<float>(BM * kh) + block_room<float>(BM * kw));
}

__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ rel_h,
           const float* __restrict__ rel_w, float* __restrict__ out,
           float* __restrict__ lse, int L, int kh, int kw, float scale) {
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles want 1024-byte alignment
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_full = s_base + OFF_BAR;          // STAGES x 8 bytes
  const uint32_t bar_empty = bar_full + 8 * STAGES;    // STAGES x 8 bytes
  float2* rel = reinterpret_cast<float2*>(smem + OFF_REL);
  const int rs = pair_stride(kh, kw);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int nt = (L + BN - 1) / BN;
  const size_t base = (size_t)bh * L * D;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar_full + 8 * st, PRODUCERS);
      mbar_init(bar_empty + 8 * st, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the CTA's rows of rel_h and of rel_w are two contiguous blocks: copied
  // raw into the stages, then rewritten as fp32 pairs (row r, row r + 8) of
  // the rows one consumer thread holds, pre-scaled by log2(e); 0 past L
  {
    const int rows = min(BM, L - q0);
    float* raw_h = reinterpret_cast<float*>(smem);
    float* raw_w = raw_h + block_room<float>(rows * kh);
    const int dh = copy_block(raw_h, rel_h + ((size_t)bh * L + q0) * kh,
                              rows * kh, tid, THREADS);
    const int dw = copy_block(raw_w, rel_w + ((size_t)bh * L + q0) * kw,
                              rows * kw, tid, THREADS);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int i = tid; i < (BM / 2) * (kh + kw); i += THREADS) {
      const int pi = i / (kh + kw);  // 64 row pairs
      const int c = i - pi * (kh + kw);
      const int r0 = (pi >> 3) * 16 + (pi & 7);  // (warpgroup, warp, g)
      const float* src = c < kh ? raw_h + dh + c : raw_w + dw + c - kh;
      const int ld = c < kh ? kh : kw;
      const float x0 = r0 < rows ? src[r0 * ld] : 0.f;
      const float x1 = r0 + 8 < rows ? src[(r0 + 8) * ld] : 0.f;
      rel[pi * rs + c] = make_float2(x0 * LOG2E, x1 * LOG2E);
    }
  }
  __syncthreads();  // the raw staging is read: the stages take tiles

  const int wg = tid >> 7;
  if (wg == 2) {
    // The producer warpgroup loads each K / V tile with 16-byte loads,
    // BATCH in flight a thread, and writes it split: K as is, V transposed
    // (dims x keys, keys in perm_col order). The split has to pass through
    // registers, so TMA would only add a raw copy and a second pass
    // through shared memory.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int p = tid - CONSUMERS;
    for (int t = 0; t < nt; ++t) {
      const int st = t % STAGES;
      mbar_wait(bar_empty + 8 * st, ((t / STAGES) & 1) ^ 1);
      fence_proxy_async();
      unsigned char* sk = smem + st * STAGE_BYTES;
      const int k0 = t * BN;
      // K: a key's 16 float4 on 16 neighbouring lanes
      for (int i0 = p; i0 < BN * 16; i0 += BATCH * PRODUCERS) {
        float4 x[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          const int i = i0 + b * PRODUCERS, row = i >> 4;
          x[b] = ld4(k + base + (size_t)(k0 + row) * D + 4 * (i & 15),
                     k0 + row < L);
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          const int i = i0 + b * PRODUCERS;
          store4(sk, sk + PART, sw_off(i >> 4, 4 * (i & 15), BN), x[b]);
        }
      }
      // V: a warp's lanes on 32 keys of one float4 column, so the
      // transposed stores of a row of V^T hit 32 banks
      for (int i0 = p; i0 < BN * 16; i0 += BATCH * PRODUCERS) {
        float4 x[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          const int i = i0 + b * PRODUCERS, row = i & (BN - 1);
          x[b] = ld4(v + base + (size_t)(k0 + row) * D + 4 * (i / BN),
                     k0 + row < L);
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          const int i = i0 + b * PRODUCERS;
          store4_t(sk + 2 * PART, sk + 3 * PART, 4 * (i / BN), i & (BN - 1),
                   D, x[b]);
        }
      }
      fence_proxy_async();  // the generic stores, then wgmma's reads
      mbar_arrive(bar_full + 8 * st);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid & 31;
    const int warp = (tid & 127) >> 5;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const int ga = q0 + wg * 64 + warp * 16 + g;  // the thread's rows ga, +8
    const int gb = ga + 8;
    const float2* rrow = rel + (wg * 32 + warp * 8 + g) * rs;
    const float sc = scale * LOG2E;
    const float inv_kw = 1.f / (float)kw;

    // Q as split A fragments, held for the whole loop
    uint32_t qb[8][4], qs[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r & 1 ? gb : ga;
        const int col = 8 * kk + tq + 4 * (r >> 1);
        split(row < L ? q[base + (size_t)row * D + col] : 0.f, qb[kk][r],
              qs[kk][r]);
      }

    // o: the running output; ot: this tile's P.V. The tensor cores'
    // fp32 accumulation truncates, so O summed in them over ~600 products
    // drifts toward zero (~3e-5 relative at L 1568); a tile's product
    // starts from zero and joins O by one rounded fmaf per element
    float o[32], ot[32], s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = ot[i] = s[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    for (int t = 0; t < nt; ++t) {
      const int st = t % STAGES;
      mbar_wait(bar_full + 8 * st, (t / STAGES) & 1);
      const uint32_t sk = s_base + st * STAGE_BYTES;
      const uint64_t dkb = desc_sw128(sk, 16, 1024);
      const uint64_t dks = desc_sw128(sk + PART, 16, 1024);
      const uint64_t dvb = desc_sw128(sk + 2 * PART, 16, 1024);
      const uint64_t dvs = desc_sw128(sk + 3 * PART, 16, 1024);

      // S = Q . K^T
      fence_regs(s);
      wgmma_fence();
      mma3_rs<BN>(s, qb, qs, dkb, dks, BN, 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      fence_u32(qb);
      fence_u32(qs);

      // logits in the exp2 domain, the online max, P = exp2(logit - max)
      const int k0 = t * BN;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * tq + e;
          float2 b = make_float2(-INFINITY, -INFINITY);
          if (key < L) {  // a key's grid row is (key + 0.5) / kw in fp32
            const int kr = (int)(((float)key + 0.5f) * inv_kw);
            const float2 h = rrow[kr];
            const float2 w = rrow[kh + key - kr * kw];
            b = make_float2(h.x + w.x, h.y + w.y);
          }
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
      const float a0 = exp2f(m0 - n0);
      const float a1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = exp2f(s[4 * j + e] - m0);
          s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - m1);
          ps0 += s[4 * j + e];
          ps1 += s[4 * j + 2 + e];
        }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
      // P's split A fragments: S's accumulator against V^T's key order
      uint32_t pb[8][4], pq[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) frag_from_acc(s, kk, pb[kk], pq[kk]);

      // O = O * alpha + P . V
      fence_regs(ot);
      wgmma_fence();
      mma3_rs<D>(ot, pb, pq, dvb, dvs, D, 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(ot);
      fence_u32(pb);
      fence_u32(pq);
      mbar_arrive(bar_empty + 8 * st);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j] = fmaf(o[4 * j], a0, ot[4 * j]);
        o[4 * j + 1] = fmaf(o[4 * j + 1], a0, ot[4 * j + 1]);
        o[4 * j + 2] = fmaf(o[4 * j + 2], a1, ot[4 * j + 2]);
        o[4 * j + 3] = fmaf(o[4 * j + 3], a1, ot[4 * j + 3]);
      }
    }

    // the row sums over the quad, then O / l
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    float* ob = out + base;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * tq;
      if (ga < L)
        *reinterpret_cast<float2*>(ob + (size_t)ga * D + c) =
            make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (gb < L)
        *reinterpret_cast<float2*>(ob + (size_t)gb * D + c) =
            make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    if (tq == 0) {
      if (ga < L) lse[(size_t)bh * L + ga] = LN2 * (m0 + log2f(l0));
      if (gb < L) lse[(size_t)bh * L + gb] = LN2 * (m1 + log2f(l1));
    }
  }
}

int launch(const void* q, const void* k, const void* v, const void* rel_h,
           const void* rel_w, void* out, void* lse, int bh, int L, int kh,
           int kw, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(kh, kw);
  if (smem > SMEM_OPTIN || raw_rel_bytes(kh, kw) > (size_t)OFF_BAR)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BM - 1) / BM, bh);
  fwd_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<float*>(out),
      static_cast<float*>(lse), L, kh, kw, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

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
  return tc::launch(q, k, v, rel_h, rel_w, out, lse, bh, L, kh, kw, scale,
                    static_cast<cudaStream_t>(stream));
}

const char* flash_relpos_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
