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
// every product that reads them (dv; dq, dk and both rel-bias sums), as K1
// rounds P before P.V and as the JAX kernel forms its bias gradients from
// the rounded dS (ds_b, flash_relpos.py:366); every product accumulates in
// fp32.
//
// What bounds it on an H100: operations. Five matrix products of BH * L^2
// * 64 multiply-adds each (S and dP are recomputed, then dv, dq, dk) --
// 10 * BH * L^2 * 64 FLOP -- against IO of a few MB per head, far above
// the card's balance point of ~295 FLOP per byte. As in the forward, each
// logit also costs one exp2f on the SFUs (16 per clock per SM, the rate at
// which the tensor cores finish a logit's 256 FLOP of S at head_dim 64),
// so the per-logit fp32 work has to stay in registers.
//
// Design: two kernels, deterministic -- no atomics, every sum in a fixed
// order, so two runs on the same inputs agree to the bit.
//   (a) dq kernel: one CTA per (128 query rows, bh) walks the key tiles. It
//       owns its rows' d_rel_h / d_rel_w, so no other CTA writes them.
//   (b) dk/dv kernel: one CTA per (128 keys, bh) walks the query tiles.
// Each kernel computes in its own orientation (S in (a), S^T = K.Q^T in
// (b)), so no operand needs a transpose through shared memory: the split
// recomputes S and dP in both kernels (seven products where one pass with
// atomics for dq would need five) and buys determinism with it.
// bf16, both kernels (sm_90a): three warpgroups. Warpgroup 2 produces and
// gives its registers up (setmaxnreg 24; the consumers take 240): the CTA's
// own 128 rows once (Q and dO in (a), K and V in (b)) and 64-row tiles of
// the other side through a ring of 3 stages guarded by full / empty
// mbarriers, all by TMA (3-D tensor maps of (64, L, BH), 128-byte swizzle,
// rows past a head's end zero-filled). Each consumer warpgroup owns 64 rows,
// two per thread:
//   - S and dP (S^T, dP^T in (b)) are accumulated in registers by wgmma
//     m64n64k16 with A and B K-major from the swizzled tiles;
//   - P = exp2(S * scale * log2e + rel - lse * log2e) and dS = P (dP -
//     delta) are formed on the accumulator fragments and converted to bf16
//     in registers, where the accumulator layout is the A-fragment layout
//     of the next products;
//   - dq += dS.K (a), dv += P^T.dO and dk += dS^T.Q (b) are wgmma m64n64k16
//     with A from registers and B MN-major from the same swizzled tiles that
//     fed S, accumulated in registers across the loop;
//   - d_rel_w in (a) is dS times the key tile's one-hot key -> grid column
//     expander (kw <= 40 columns in n-tiles of 8), accumulated in fp32
//     registers across the key loop; d_rel_h is dS times the tile's one-hot
//     key -> grid row expander (at most 8 rows: kw >= 10), added per tile
//     into the warp's shared-memory row sums. These two products run on
//     mma.sync m16n8k16 on the same dS registers (a warp's 16 rows of the
//     wgmma accumulator are the mma.sync A layout); both expanders are
//     windows of one static bf16 matrix E[r][c] (r % kw == c, and r / kw ==
//     c - 40) built once per CTA, read by ldmatrix from row k0 % kw on;
//   - nothing of S, dP, P or dS is written to shared memory.
// The rel terms do not go by TMA (their rows are not 16-byte multiples).
// (a) copies its rows' contiguous rel_h / rel_w blocks raw by cp.async once
// (into ring stages 1-2, before their first tiles) and rewrites them as
// fp32 pairs (row r, row r + 8) pre-scaled by log2(e); it gathers a tile's
// biases into registers while S and dP are in flight (a key's grid row is
// (key + 0.5) / kw in fp32). (b) streams each query tile's rel_h, rel_w,
// lse and delta blocks raw into the tile's stage, copied by the producer
// warp's cp.async and signalled on the stage's full barrier
// (cp.async.mbarrier.arrive), and reads them as bf16 / fp32.
// Ragged tiles (L = 1568, 2450, 196 are not multiples of 64): P and dS are
// forced to 0 for keys and queries past L, so zero-filled rows never put
// NaN or garbage into a sum.
//
// fp32 design (sm_90a, namespace tc): the same two kernels, deterministic,
// on 3xTF32 wgmma (flash_relpos_tf32.cuh: every operand split into big +
// small tf32 parts, three products with fp32 accumulation). Bound on an
// H100: 10 * BH * L^2 * 64 FLOP three times over at 495 TFLOP/s: 0.305 ms
// at BH = 32, L = 1568 (against 0.752 ms for fp32 FMAs at 67). wgmma reads
// tf32 from shared memory K-major only, so every product whose summed
// index runs down a tile in memory reads a transposed copy (K^T in (a),
// Q^T and dO^T in (b)), written by the producer warpgroup in the pass that
// splits the tile, with that index in perm_col order: S's and dP's
// accumulators are then the A fragments of the next products as they are.
// A producer warpgroup (setmaxnreg 40) loads tiles with 16-byte loads, a
// few in flight a thread (the split goes through registers, so TMA would
// add only a raw copy), into rings of 2 stages; the consumer warpgroups
// (setmaxnreg 232) hold one side's rows as split A fragments in registers
// (Q in (a), K in (b)) and the other in shared memory, split once per CTA
// (dO in (a), V in (b)). dq, dk and dv take each tile's product in a
// zeroed accumulator and sum the tiles in registers with rounded adds: the
// tensor cores' fp32 accumulation truncates, so sums kept in them over the
// loop drift toward zero (~3e-5 relative over the tiles of L 1568).
//   (a) dq kernel: key tiles of whole key-grid rows, R = F32_TILE_MAX / kw
//       rows, NT = R * kw rounded up to 8 columns. A tile position keeps
//       its grid column in every tile, so d rel_w sums per position in
//       registers across the loop and is folded over the R rows once at
//       the end (through shared memory, in order); d rel_h of the tile's
//       grid rows is complete in the tile, a quad's shuffle sums written
//       once. The rel terms are read from global memory (L1 / L2) as dS
//       is formed. kw <= F32_TILE_MAX = 48 (kernels/flash_relpos.py
//       BWD_F32_KW_MAX).
//   (b) dk/dv kernel: query tiles of 32, each stage holding Q, dO, Q^T and
//       dO^T split and the tile rows' raw rel_h, rel_w, lse and delta. It
//       reads nothing (a) writes, so it goes by programmatic dependent
//       launch: its CTAs take the SMs (a)'s last wave leaves idle (each
//       grid is ~3 waves of 132 SMs at 80x40 BH 16, 56x28 BH 32: 11-14%
//       of K2's time), and it waits for (a)'s grid only at its end.
//
// Which key grids it takes: those its shared-memory layouts fit. The
// launchers refuse (cudaErrorInvalidValue) a (kh, kw) whose bytes exceed
// SMEM_OPTIN, the 227 KiB a block may opt into on an H100 (or, for the
// bf16 dq kernel's raw rel-term staging, the two ring stages it borrows).
// The reckonings are dq_smem_bytes / raw_stage_bytes / dkv_smem_bytes
// (bf16) and dq_smem_f32 / dkv_smem_f32 (fp32). The bf16 staging binds
// first, at kh + kw <= 127, which is the route's limit in both types
// (kernels/flash_relpos.py BWD_MAX_REL_ENTRIES); a launch past these
// figures raises. At the 80x40 grid of 1280x640 the bf16 dq kernel takes
// 199,168 B (its rel pairs and d rel_h pairs are 512 B per kh + kw + 1 and
// per kh), the staging 30,752 of 32,768 B, the dk/dv kernel 133,120 B; the
// fp32 kernels take 214,080 B (NT = 40) and 229,056 B, at 56x28 164,928 B
// (NT = 32) and 219,840 B. The fp32 dq kernel's bytes do not depend on
// kh + kw (230,464 B at NT = 48); its dk/dv kernel's raw rel blocks take
// 128 B per kh + kw and stage, 230,848 B at kh + kw = 127. No register
// array is sized by kh or kw; the bf16 d rel_w accumulator is KW_MAX = 40
// columns, the fp32 one NT / 2 registers.
//
// The launcher allocates nothing and does not synchronize; it returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_relpos_tf32.cuh"

namespace {

constexpr int D = 64;    // head dim
constexpr int BT = 64;   // rows of every bf16 tile (queries or keys)
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t SMEM_OPTIN = 232448;  // dynamic shared memory of a block

// ---------------------------------------------------------------------------
// fp32: 3xTF32 wgmma, warp-specialized
// ---------------------------------------------------------------------------

namespace tc {

using namespace tf32x3;

constexpr int F32_THREADS = 384;    // warpgroups 0, 1 consume; 2 produces
constexpr int F32_CONSUMERS = 256;
constexpr int F32_PRODUCERS = F32_THREADS - F32_CONSUMERS;
constexpr int F32_STAGES = 2;

// (a) dq, d rel_h and d rel_w: one CTA per (128 query rows, bh). Its key
// tiles are whole rows of the key grid: R = F32_TILE_MAX / kw grid rows
// (R * kw keys) in a tile of NT = R * kw rounded up to 8 columns. So a
// position of the tile has the same grid column in every tile: d rel_w
// sums in registers, per position, across the loop (folded over the R
// rows at the end), and d rel_h of the tile's R grid rows is complete in
// the tile (a quad's sums, written once). Warpgroup 2 produces: each tile
// of K and V split into big and small parts, and K also transposed
// (dims x keys, keys in perm_col order), through a ring of 2 stages. Each
// consumer warpgroup owns 64 rows, two per thread, Q as split A fragments
// in registers:
//   S = Q . K^T     3xTF32 wgmma m64nNTk8, A from registers
//   dP = dO . V^T   3xTF32 wgmma m64nNTk8, A (dO, split once by the CTA)
//                   from shared memory
//   dS on the accumulator fragments, the rel sums from the fp32 dS
//   dq += dS . K    3xTF32 wgmma m64n64k8, A from registers, B = K^T
constexpr int F32_ROWS = 128;
constexpr int F32_TILE_MAX = 48;   // keys of a key tile
constexpr int DO_PART = part_bytes(F32_ROWS, D);  // 32 KiB

__host__ __device__ constexpr int dq_stage_bytes(int nt) {
  return 4 * part_bytes(nt, D) + 2 * part_bytes(D, nt);  // K, V, K^T
}

// [dO big | dO small | stages | barriers]
constexpr size_t dq_smem_f32(int nt) {
  return 1024 + 2 * (size_t)DO_PART + F32_STAGES * (size_t)dq_stage_bytes(nt)
         + 64;
}

template <int NT>
__global__ void __launch_bounds__(F32_THREADS, 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ rel_h,
          const float* __restrict__ rel_w, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, float* __restrict__ drel_h,
          float* __restrict__ drel_w, int L, int kh, int kw, int R,
          float scale) {
  constexpr int KP = part_bytes(NT, D);   // K or V, one part
  constexpr int TP = part_bytes(D, NT);   // K^T, one part
  constexpr int SB = dq_stage_bytes(NT);
  constexpr int NA = NT / 2;              // accumulator floats of S, dP
  constexpr int NJ = NT / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(smem);
  unsigned char* stages = smem + 2 * DO_PART;
  const uint32_t bar_full = s_base + 2 * DO_PART + F32_STAGES * SB;
  const uint32_t bar_empty = bar_full + 8 * F32_STAGES;

  // the dk/dv kernel reads none of this kernel's outputs: it may start on
  // the SMs this grid's last wave leaves idle (programmatic dependent
  // launch) as soon as every CTA here has started
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * F32_ROWS;
  const int tid = threadIdx.x;
  const int span = R * kw;               // keys of a tile
  const int nt = (kh + R - 1) / R;       // tiles
  const size_t base = (size_t)bh * L * D;

  if (tid == 0) {
    for (int st = 0; st < F32_STAGES; ++st) {
      mbar_init(bar_full + 8 * st, F32_PRODUCERS);
      mbar_init(bar_empty + 8 * st, F32_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // dO of the CTA's rows, split once (zero past L)
  for (int i = tid; i < F32_ROWS * 16; i += F32_THREADS) {
    const int row = i >> 4, c = i & 15;
    const float4 x = ld4(dout + base + (size_t)(q0 + row) * D + 4 * c,
                         q0 + row < L);
    store4(smem, smem + DO_PART, sw_off(row, 4 * c, F32_ROWS), x);
  }
  fence_proxy_async();
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int p = tid - F32_CONSUMERS;
    for (int t = 0; t < nt; ++t) {
      const int st = t % F32_STAGES;
      mbar_wait(bar_empty + 8 * st, ((t / F32_STAGES) & 1) ^ 1);
      fence_proxy_async();
      unsigned char* sk = stages + st * SB;
      const int k0 = t * span;
      // a warp's lanes on neighbouring keys of one float4 column: K and V
      // as they are, K also transposed (a row of K^T per dim); two keys'
      // K and V (four loads) in flight a thread
      for (int i0 = p; i0 < NT * 16; i0 += 2 * F32_PRODUCERS) {
        float4 xk[2], xv[2];
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int i = i0 + b * F32_PRODUCERS;
          const int row = i % NT, c = i / NT;
          const bool ok = i < NT * 16 && row < span && k0 + row < L;
          const size_t at = base + (size_t)(k0 + row) * D + 4 * c;
          xk[b] = ld4(k + at, ok);
          xv[b] = ld4(v + at, ok);
        }
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int i = i0 + b * F32_PRODUCERS;
          const int row = i % NT, c = i / NT;
          if (i < NT * 16) {
            store4(sk, sk + KP, sw_off(row, 4 * c, NT), xk[b]);
            store4(sk + 2 * KP, sk + 3 * KP, sw_off(row, 4 * c, NT), xv[b]);
            store4_t(sk + 4 * KP, sk + 4 * KP + TP, 4 * c, row, D, xk[b]);
          }
        }
      }
      fence_proxy_async();
      mbar_arrive(bar_full + 8 * st);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const int ga = q0 + wg * 64 + warp * 16 + g;  // the thread's rows ga, +8
    const int gb = ga + 8;
    const bool va = ga < L;
    const bool vb = gb < L;
    // padded rows read no lse / delta / rel terms: their dS is forced to 0
    const float lse_a = va ? lse[(size_t)bh * L + ga] * LOG2E : 0.f;
    const float lse_b = vb ? lse[(size_t)bh * L + gb] * LOG2E : 0.f;
    const float dl_a = va ? delta[(size_t)bh * L + ga] : 0.f;
    const float dl_b = vb ? delta[(size_t)bh * L + gb] : 0.f;
    const size_t ra = (size_t)bh * L + (va ? ga : 0);
    const size_t rb = (size_t)bh * L + (vb ? gb : 0);
    const float sc = scale * LOG2E;
    const float inv_kw = 1.f / (float)kw;
    const uint32_t s_do = s_base + wg * 64 * 128;
    const uint64_t dOb = desc_sw128(s_do, 16, 1024);
    const uint64_t dOs = desc_sw128(s_do + DO_PART, 16, 1024);

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

    // dqa: the running dq; dqt: this tile's dS.K, started from zero and
    // added in registers (rounded), not summed in the tensor cores, whose
    // truncating accumulation drifts toward zero over the loop
    float s[NA], dp[NA], gw[NA], dqa[32], dqt[32];
#pragma unroll
    for (int i = 0; i < NA; ++i) s[i] = dp[i] = gw[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[i] = dqt[i] = 0.f;

    for (int t = 0; t < nt; ++t) {
      const int st = t % F32_STAGES;
      mbar_wait(bar_full + 8 * st, (t / F32_STAGES) & 1);
      const uint32_t sk = s_base + 2 * DO_PART + st * SB;
      const uint64_t dKb = desc_sw128(sk, 16, 1024);
      const uint64_t dKs = desc_sw128(sk + KP, 16, 1024);
      const uint64_t dVb = desc_sw128(sk + 2 * KP, 16, 1024);
      const uint64_t dVs = desc_sw128(sk + 3 * KP, 16, 1024);
      const uint64_t dTb = desc_sw128(sk + 4 * KP, 16, 1024);
      const uint64_t dTs = desc_sw128(sk + 4 * KP + TP, 16, 1024);

      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      mma3_rs<NT>(s, qb, qs, dKb, dKs, NT, 0);
      mma3_ss<NT, 8>(dp, dOb, dOs, F32_ROWS, dVb, dVs, NT, 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      fence_regs(dp);
      fence_u32(qb);
      fence_u32(qs);

      // dS on the fragments, in fp32; the bias of position 8j + 2tq + e
      // read from the rel terms (L1 / L2), its grid row in the tile
      // (p + 0.5) / kw
      const int k0 = t * span;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pos = 8 * j + 2 * tq + e;
          const int rr = (int)(((float)pos + 0.5f) * inv_kw);
          const int bin = t * R + rr;
          const bool ok = pos < span && bin < kh;
          const int hb = ok ? bin : 0;
          const int wc = ok ? pos - rr * kw : 0;
          const int ia = 4 * j + e, ib = 4 * j + 2 + e;
          const float ba = (rel_h[ra * kh + hb] + rel_w[ra * kw + wc]) * LOG2E;
          const float bb = (rel_h[rb * kh + hb] + rel_w[rb * kw + wc]) * LOG2E;
          const float pa = exp2f(fmaf(s[ia], sc, ba) - lse_a);
          const float pb = exp2f(fmaf(s[ib], sc, bb) - lse_b);
          s[ia] = ok && va ? pa * (dp[ia] - dl_a) : 0.f;
          s[ib] = ok && vb ? pb * (dp[ib] - dl_b) : 0.f;
        }
      // d rel_w per position, across the loop
#pragma unroll
      for (int i = 0; i < NA; ++i) gw[i] += s[i];
      // d rel_h of the tile's grid rows: the quad's sums in a fixed order
      for (int rr = 0; rr < R; ++rr) {
        float ha = 0.f, hb = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pos = 8 * j + 2 * tq + e;
            if ((int)(((float)pos + 0.5f) * inv_kw) == rr) {
              ha += s[4 * j + e];
              hb += s[4 * j + 2 + e];
            }
          }
        ha += __shfl_xor_sync(0xffffffffu, ha, 1);
        hb += __shfl_xor_sync(0xffffffffu, hb, 1);
        ha += __shfl_xor_sync(0xffffffffu, ha, 2);
        hb += __shfl_xor_sync(0xffffffffu, hb, 2);
        const int bin = t * R + rr;
        if (tq == 0 && bin < kh) {
          if (va) drel_h[ra * kh + bin] = ha;
          if (vb) drel_h[rb * kh + bin] = hb;
        }
      }

      // dq += dS . K: dS's split A fragments against K^T's key order
      uint32_t db[NJ][4], ds[NJ][4];
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) frag_from_acc(s, kk, db[kk], ds[kk]);
      fence_regs(dqt);
      wgmma_fence();
      mma3_rs<D>(dqt, db, ds, dTb, dTs, D, 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dqt);
      fence_u32(db);
      fence_u32(ds);
      mbar_arrive(bar_empty + 8 * st);
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[i] += dqt[i];
    }

    float* dqb = dq + base;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * tq;
      if (va)
        *reinterpret_cast<float2*>(dqb + (size_t)ga * D + c) =
            make_float2(dqa[4 * j] * scale, dqa[4 * j + 1] * scale);
      if (vb)
        *reinterpret_cast<float2*>(dqb + (size_t)gb * D + c) =
            make_float2(dqa[4 * j + 2] * scale, dqa[4 * j + 3] * scale);
    }
    // d rel_w: every consumer is past the ring, which now holds each
    // warp's position sums (16 rows x NT); a lane folds a (row, column)
    // over the tile's R grid rows in order
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float* fold = reinterpret_cast<float*>(stages) + (wg * 4 + warp) * 16 * NT;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        fold[g * NT + 8 * j + 2 * tq + e] = gw[4 * j + e];
        fold[(g + 8) * NT + 8 * j + 2 * tq + e] = gw[4 * j + 2 + e];
      }
    __syncwarp();
    const int row0 = q0 + wg * 64 + warp * 16;
    for (int i = lane; i < 16 * kw; i += 32) {
      const int rr = i / kw;
      const int c = i - rr * kw;
      float acc = 0.f;
      for (int r = 0; r < R; ++r) acc += fold[rr * NT + r * kw + c];
      if (row0 + rr < L) drel_w[((size_t)bh * L + row0 + rr) * kw + c] = acc;
    }
  }
}

// (b) dk and dv: one CTA per (128 keys, bh). Its 128 rows of V are split
// once into shared memory (the A operand of dP^T); each consumer thread
// holds its keys' K as split A fragments. Warpgroup 2 produces query
// tiles of 32 through a ring of 2 stages: Q and dO split as they are and
// transposed (dims x queries, queries in perm_col order), and the tile
// rows' rel_h, rel_w, lse and delta, contiguous blocks copied raw by
// cp.async (signalled on the stage's full barrier by
// cp.async.mbarrier.arrive). Each consumer warpgroup owns 64 keys:
//   S^T = K . Q^T     3xTF32 wgmma m64n32k8, A from registers
//   dP^T = V . dO^T   3xTF32 wgmma m64n32k8, A from shared memory
//   P^T, dS^T on the accumulator fragments
//   dv += P^T . dO, dk += dS^T . Q   3xTF32 wgmma m64n64k8, A from
//                     registers, B = dO^T, Q^T
constexpr int F32_KEYS = 128;
constexpr int F32_QT = 32;                          // queries of a tile
constexpr int V_PART = part_bytes(F32_KEYS, D);     // 32 KiB
constexpr int QT_PART = part_bytes(F32_QT, D);      // Q or dO, 8 KiB
constexpr int QTT_PART = part_bytes(D, F32_QT);     // Q^T or dO^T, 8 KiB
static_assert(QT_PART == QTT_PART, "a query tile's parts are one size");
constexpr int QS_BYTES = 8 * QT_PART;               // a stage's operands

// full barrier arrivals: each producer thread once for its cp.async
// copies and once for its stores
constexpr int F32_FULL_ARRIVALS = 2 * F32_PRODUCERS;

// a stage's raw rel block, copy_block destinations of the tile's rows:
// [rel_h (QT x kh) | rel_w (QT x kw) | lse | delta]
__host__ __device__ constexpr int rel_block_bytes(int kh, int kw) {
  return 4 * (block_room<float>(F32_QT * kh) + block_room<float>(F32_QT * kw)
              + 2 * block_room<float>(F32_QT));
}

// [V big | V small | stage operands | rel blocks | barriers]
size_t dkv_smem_f32(int kh, int kw) {
  return 1024 + 2 * (size_t)V_PART + F32_STAGES * (size_t)QS_BYTES +
         F32_STAGES * (size_t)rel_block_bytes(kh, kw) + 64;
}

// the element offset copy_block gives src inside its destination
__device__ __forceinline__ int raw_offset(const float* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(float));
}

__global__ void __launch_bounds__(F32_THREADS, 1)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ rel_h,
           const float* __restrict__ rel_w, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv, int L, int kh,
           int kw, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(smem);
  unsigned char* ops = smem + 2 * V_PART;
  const int rb_bytes = rel_block_bytes(kh, kw);
  unsigned char* rels = ops + F32_STAGES * QS_BYTES;
  const uint32_t bar_full = smem_u32(rels + F32_STAGES * rb_bytes);
  const uint32_t bar_empty = bar_full + 8 * F32_STAGES;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * F32_KEYS;
  const int tid = threadIdx.x;
  const int nt = (L + F32_QT - 1) / F32_QT;
  const size_t base = (size_t)bh * L * D;

  if (tid == 0) {
    for (int st = 0; st < F32_STAGES; ++st) {
      mbar_init(bar_full + 8 * st, F32_FULL_ARRIVALS);
      mbar_init(bar_empty + 8 * st, F32_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < F32_KEYS * 16; i += F32_THREADS) {
    const int row = i >> 4, c = i & 15;
    const float4 x = ld4(v + base + (size_t)(k0 + row) * D + 4 * c,
                         k0 + row < L);
    store4(smem, smem + V_PART, sw_off(row, 4 * c, F32_KEYS), x);
  }
  fence_proxy_async();
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int p = tid - F32_CONSUMERS;
    for (int t = 0; t < nt; ++t) {
      const int st = t % F32_STAGES;
      mbar_wait(bar_empty + 8 * st, ((t / F32_STAGES) & 1) ^ 1);
      fence_proxy_async();
      unsigned char* sq = ops + st * QS_BYTES;
      const int q0 = t * F32_QT;
      // the tile rows' rel_h, rel_w, lse and delta: contiguous blocks,
      // copied raw while the operands are split
      const size_t row0 = (size_t)bh * L + q0;
      const int rows = min(F32_QT, L - q0);
      float* rh = reinterpret_cast<float*>(rels + st * rb_bytes);
      float* rw = rh + block_room<float>(F32_QT * kh);
      float* ls = rw + block_room<float>(F32_QT * kw);
      float* dl = ls + block_room<float>(F32_QT);
      copy_block(rh, rel_h + row0 * kh, rows * kh, p, F32_PRODUCERS);
      copy_block(rw, rel_w + row0 * kw, rows * kw, p, F32_PRODUCERS);
      copy_block(ls, lse + row0, rows, p, F32_PRODUCERS);
      copy_block(dl, delta + row0, rows, p, F32_PRODUCERS);
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                   ::"r"(bar_full + 8 * st) : "memory");
      // two queries' Q and dO (four loads) in flight a thread
      for (int i0 = p; i0 < F32_QT * 16; i0 += 2 * F32_PRODUCERS) {
        float4 xq[2], xd[2];
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int i = i0 + b * F32_PRODUCERS;
          const int row = i % F32_QT, c = i / F32_QT;
          const size_t at = base + (size_t)(q0 + row) * D + 4 * c;
          xq[b] = ld4(q + at, q0 + row < L);
          xd[b] = ld4(dout + at, q0 + row < L);
        }
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int i = i0 + b * F32_PRODUCERS;
          const int row = i % F32_QT, c = i / F32_QT;
          store4(sq, sq + QT_PART, sw_off(row, 4 * c, F32_QT), xq[b]);
          store4(sq + 2 * QT_PART, sq + 3 * QT_PART,
                 sw_off(row, 4 * c, F32_QT), xd[b]);
          store4_t(sq + 4 * QT_PART, sq + 5 * QT_PART, 4 * c, row, D, xq[b]);
          store4_t(sq + 6 * QT_PART, sq + 7 * QT_PART, 4 * c, row, D, xd[b]);
        }
      }
      fence_proxy_async();
      mbar_arrive(bar_full + 8 * st);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    // the thread's keys ka, ka + 8: grid row and column
    const int ka = k0 + wg * 64 + warp * 16 + g;
    const int kb = ka + 8;
    const bool va = ka < L;
    const bool vb = kb < L;
    const int ha = va ? ka / kw : 0;
    const int ca = va ? ka % kw : 0;
    const int hb = vb ? kb / kw : 0;
    const int cb = vb ? kb % kw : 0;
    const float sc = scale * LOG2E;
    const uint32_t s_v = s_base + wg * 64 * 128;
    const uint64_t dVb = desc_sw128(s_v, 16, 1024);
    const uint64_t dVs = desc_sw128(s_v + V_PART, 16, 1024);

    uint32_t kbg[8][4], ksm[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r & 1 ? kb : ka;
        const int col = 8 * kk + tq + 4 * (r >> 1);
        split(row < L ? k[base + (size_t)row * D + col] : 0.f, kbg[kk][r],
              ksm[kk][r]);
      }

    // dka, dva: the running sums; acc: one tile's product (dv's, then
    // dk's), started from zero and added in registers (rounded), not
    // summed in the tensor cores, whose truncating accumulation drifts
    // toward zero over the loop
    float s[16], dp[16], dka[32], dva[32], acc[32];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = acc[i] = 0.f;

    for (int t = 0; t < nt; ++t) {
      const int st = t % F32_STAGES;
      mbar_wait(bar_full + 8 * st, (t / F32_STAGES) & 1);
      // the stage's eight parts, QT_PART apart: Q, dO, Q^T, dO^T (big,
      // small); one descriptor base, the parts' offsets added at each use
      const uint64_t dsq =
          desc_sw128(s_base + 2 * V_PART + st * QS_BYTES, 16, 1024);
      constexpr uint64_t PD = QT_PART >> 4;

      // S^T = K . Q^T and dP^T = V . dO^T (64 keys x 32 queries)
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      mma3_rs<F32_QT>(s, kbg, ksm, dsq, dsq + PD, F32_QT, 0);
      mma3_ss<F32_QT, 8>(dp, dVb, dVs, F32_KEYS, dsq + 2 * PD, dsq + 3 * PD,
                         F32_QT, 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      fence_regs(dp);
      fence_u32(kbg);
      fence_u32(ksm);

      // P^T and dS^T: column c = 8j + 2tq + e is query q0 + c; the raw
      // rel terms, lse and delta of the tile's rows (nothing past L)
      const int q0 = t * F32_QT;
      const size_t row0 = (size_t)bh * L + q0;
      const float* rh = reinterpret_cast<const float*>(rels + st * rb_bytes);
      const float* rw = rh + block_room<float>(F32_QT * kh);
      const float* ls = rw + block_room<float>(F32_QT * kw);
      const float* dl = ls + block_room<float>(F32_QT);
      rh += raw_offset(rel_h + row0 * kh);
      rw += raw_offset(rel_w + row0 * kw);
      ls += raw_offset(lse + row0);
      dl += raw_offset(delta + row0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * tq + e;
          const bool qok = q0 + c < L;
          const int ia = 4 * j + e, ib = 4 * j + 2 + e;
          const float l2 = qok ? ls[c] * LOG2E : 0.f;
          const float dlt = qok ? dl[c] : 0.f;
          const float pa = exp2f(
              fmaf(fmaf(s[ia], scale, rh[c * kh + ha] + rw[c * kw + ca]),
                   LOG2E, -l2));
          const float pb = exp2f(
              fmaf(fmaf(s[ib], scale, rh[c * kh + hb] + rw[c * kw + cb]),
                   LOG2E, -l2));
          s[ia] = qok && va ? pa : 0.f;
          s[ib] = qok && vb ? pb : 0.f;
          dp[ia] = s[ia] * (dp[ia] - dlt);
          dp[ib] = s[ib] * (dp[ib] - dlt);
        }

      // dv += P^T . dO, then dk += dS^T . Q: one split operand in
      // registers at a time
      uint32_t fb[4][4], fs[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) frag_from_acc(s, kk, fb[kk], fs[kk]);
      fence_regs(acc);
      wgmma_fence();
      mma3_rs<D>(acc, fb, fs, dsq + 6 * PD, dsq + 7 * PD, D, 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      fence_u32(fb);
      fence_u32(fs);
#pragma unroll
      for (int i = 0; i < 32; ++i) dva[i] += acc[i];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) frag_from_acc(dp, kk, fb[kk], fs[kk]);
      fence_regs(acc);
      wgmma_fence();
      mma3_rs<D>(acc, fb, fs, dsq + 4 * PD, dsq + 5 * PD, D, 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      fence_u32(fb);
      fence_u32(fs);
      mbar_arrive(bar_empty + 8 * st);
#pragma unroll
      for (int i = 0; i < 32; ++i) dka[i] += acc[i];
    }

    float* dkb = dk + base;
    float* dvb = dv + base;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * tq;
      if (va) {
        *reinterpret_cast<float2*>(dkb + (size_t)ka * D + c) =
            make_float2(dka[4 * j] * scale, dka[4 * j + 1] * scale);
        *reinterpret_cast<float2*>(dvb + (size_t)ka * D + c) =
            make_float2(dva[4 * j], dva[4 * j + 1]);
      }
      if (vb) {
        *reinterpret_cast<float2*>(dkb + (size_t)kb * D + c) =
            make_float2(dka[4 * j + 2] * scale, dka[4 * j + 3] * scale);
        *reinterpret_cast<float2*>(dvb + (size_t)kb * D + c) =
            make_float2(dva[4 * j + 2], dva[4 * j + 3]);
      }
    }
  }
  // launched early beside the dq grid: finish only after it has, so work
  // after K2 on the stream sees dq and the rel-bias gradients
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// the key tile of the dq kernel: R grid rows of kw keys, NT columns
inline int tile_rows(int kw) { return F32_TILE_MAX / kw; }
inline int tile_cols(int kw) { return (tile_rows(kw) * kw + 7) & ~7; }

template <int NT>
int launch_dq(const void* q, const void* k, const void* v, const void* rel_h,
              const void* rel_w, const void* dout, const void* lse,
              const void* delta, void* dq, void* drel_h, void* drel_w,
              int bh, int L, int kh, int kw, float scale, cudaStream_t st) {
  const size_t smem = dq_smem_f32(NT);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<NT><<<dim3((L + F32_ROWS - 1) / F32_ROWS, bh), F32_THREADS, smem,
                  st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<float*>(drel_h),
      static_cast<float*>(drel_w), L, kh, kw, tile_rows(kw), scale);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, const void* rel_h,
           const void* rel_w, const void* dout, const void* lse,
           const void* delta, void* dq, void* dk, void* dv, void* drel_h,
           void* drel_w, int bh, int L, int kh, int kw, float scale,
           cudaStream_t st) {
  // a key tile of the dq kernel holds at least one grid row; then the
  // layouts' bytes
  if (kw > F32_TILE_MAX || dq_smem_f32(tile_cols(kw)) > SMEM_OPTIN ||
      dkv_smem_f32(kh, kw) > SMEM_OPTIN)
    return (int)cudaErrorInvalidValue;
  int rc;
  switch (tile_cols(kw)) {
    case 8: rc = launch_dq<8>(q, k, v, rel_h, rel_w, dout, lse, delta, dq,
                              drel_h, drel_w, bh, L, kh, kw, scale, st); break;
    case 16: rc = launch_dq<16>(q, k, v, rel_h, rel_w, dout, lse, delta, dq,
                                drel_h, drel_w, bh, L, kh, kw, scale, st); break;
    case 24: rc = launch_dq<24>(q, k, v, rel_h, rel_w, dout, lse, delta, dq,
                                drel_h, drel_w, bh, L, kh, kw, scale, st); break;
    case 32: rc = launch_dq<32>(q, k, v, rel_h, rel_w, dout, lse, delta, dq,
                                drel_h, drel_w, bh, L, kh, kw, scale, st); break;
    case 40: rc = launch_dq<40>(q, k, v, rel_h, rel_w, dout, lse, delta, dq,
                                drel_h, drel_w, bh, L, kh, kw, scale, st); break;
    default: rc = launch_dq<48>(q, k, v, rel_h, rel_w, dout, lse, delta, dq,
                                drel_h, drel_w, bh, L, kh, kw, scale, st);
  }
  if (rc != cudaSuccess) return rc;

  const size_t smem_b = dkv_smem_f32(kh, kw);
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  // programmatic dependent launch: the dk/dv grid may start while the dq
  // grid's last wave runs (each grid is ~3 waves at 80x40 BH 16)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((L + F32_KEYS - 1) / F32_KEYS, bh);
  cfg.blockDim = dim3(F32_THREADS);
  cfg.dynamicSmemBytes = smem_b;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, dkv_kernel, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(rel_h), static_cast<const float*>(rel_w),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), L, kh, kw, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, warp-specialized; rel-bias products on mma.sync
// ---------------------------------------------------------------------------

namespace hop {

typedef __nv_bfloat16 bf16;

constexpr int KW_MAX = 40;       // d rel_w columns held in registers
constexpr int NW = (KW_MAX + 7) / 8;
constexpr uint32_t ONE = 0x3F80u;  // bf16 1.0

using namespace relpos;

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16) . b (16 x 8, bf16)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr int pair_stride(int n) { return n | 1; }

// The one-hot expanders of d rel_w and d rel_h as one bf16 matrix with a
// row per key offset r < 64 + KW_MAX: columns [0, 40) are r % kw == col
// (d rel_w, 5 n-tiles), columns [40, 48) are r / kw == col - 40 (d rel_h).
// A key tile starting at k0 reads rows [k0 % kw, k0 % kw + 64): its keys'
// grid columns, and grid rows counted from k0 / kw.
constexpr int E_ROWS = BT + KW_MAX;
constexpr int E_COLS = 48;
constexpr int LDE = 56;  // 112-byte rows: 8 rows of an ldmatrix hit 8 banks

// B fragments of two n-tiles [n0, n0 + 16) x keys [k0, k0 + 16) of E (.trans)
__device__ __forceinline__ uint32_t e_addr(uint32_t e, int k0, int n0,
                                           int lane) {
  return e + ((k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDE + n0 +
              (lane >> 4) * 8) * 2;
}

// (a) dq, d rel_h and d rel_w on wgmma: one CTA per (128 query rows, bh)
// of three warpgroups. Warpgroup 2 produces: Q and dO of the CTA's rows
// once, then K and V tiles of 64 keys through a ring of 3 stages (TMA,
// 128-byte swizzle). Each consumer warpgroup owns 64 rows, two per thread:
//   S = Q . K^T, dP = dO . V^T   wgmma m64n64k16, A and B K-major from
//                                swizzled shared memory;
//   dS on the accumulator fragments, to bf16 in registers;
//   dq += dS . K                 wgmma m64n64k16, A from registers, B (the
//                                K tile, MN-major) from shared memory;
//   d rel_w += dS . E_w, this tile's d rel_h = dS . E_h   mma.sync m16n8k16
//                                on the same fragments (a warp's slice of
//                                the accumulator is the mma.sync A layout),
//                                run while the dq product is in flight.
constexpr int DQ_ROWS = 128;
constexpr int DQ_THREADS = 384;
constexpr int DQ_CONSUMERS = 256;
constexpr int DQ_STAGES = 3;
constexpr int KVT_BYTES = BT * 128;              // a K or V tile, 8 KiB
constexpr int DQ_STAGE_BYTES = 2 * KVT_BYTES;
constexpr int QR_BYTES = DQ_ROWS * 128;          // Q or dO of the CTA
constexpr int E_BYTES = (E_ROWS * LDE * 2 + 1023) / 1024 * 1024;
// [Q | dO | stages | barriers | E | rel pairs | d rel_h pairs]
constexpr int DQ_OFF_ST = 2 * QR_BYTES;
constexpr int DQ_OFF_BAR = DQ_OFF_ST + DQ_STAGES * DQ_STAGE_BYTES;
constexpr int DQ_OFF_E = DQ_OFF_BAR + 1024;
constexpr int DQ_OFF_REL = DQ_OFF_E + E_BYTES;
static_assert(DQ_STAGES >= 3, "stages 1-2 stage the raw rel terms");

size_t dq_smem_bytes(int kh, int kw) {
  return 1024 + DQ_OFF_REL +
         (size_t)(DQ_ROWS / 2) * pair_stride(kh + kw) * 8 +  // rel pairs
         (size_t)(DQ_ROWS / 2) * kh * 8;                      // d rel_h pairs
}

// elements from the raw rel_h block to the raw rel_w block: the room of a
// copy_block destination of n elements (n + 8), rounded to 16 bytes
__host__ __device__ constexpr int raw_w_offset(int n) {
  return (n + 8 + 7) & ~7;
}

// the raw rel terms of DQ_ROWS rows, staged in ring stages 1-2
constexpr size_t raw_stage_bytes(int kh, int kw) {
  return 2 * ((size_t)raw_w_offset(DQ_ROWS * kh) + DQ_ROWS * kw + 8);
}
constexpr size_t RAW_STAGE_ROOM = 2 * (size_t)DQ_STAGE_BYTES;

__global__ void __launch_bounds__(DQ_THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const __grid_constant__ CUtensorMap tm_do,
          const bf16* __restrict__ rel_h, const bf16* __restrict__ rel_w,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, bf16* __restrict__ drel_h,
          bf16* __restrict__ drel_w, int L, int kh, int kw, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_do = s_q + QR_BYTES;
  const uint32_t s_st = s_q + DQ_OFF_ST;
  const uint32_t bar_full = s_q + DQ_OFF_BAR;           // DQ_STAGES x 8
  const uint32_t bar_empty = bar_full + 8 * DQ_STAGES;  // DQ_STAGES x 8
  const uint32_t bar_q = bar_empty + 8 * DQ_STAGES;
  bf16* Es = reinterpret_cast<bf16*>(smem + DQ_OFF_E);
  float2* rel = reinterpret_cast<float2*>(smem + DQ_OFF_REL);
  const int rs = pair_stride(kh + kw);
  float2* gh_sum = rel + (DQ_ROWS / 2) * rs;  // (64 row pairs, kh)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * DQ_ROWS;
  const int tid = threadIdx.x;
  const int nt = (L + BT - 1) / BT;

  auto load_kv = [&](int t) {
    const int st = t % DQ_STAGES;
    const uint32_t dst = s_st + st * DQ_STAGE_BYTES;
    mbar_expect_tx(bar_full + 8 * st, 2 * KVT_BYTES);
    tma_load(dst, &tm_k, t * BT, bh, bar_full + 8 * st);
    tma_load(dst + KVT_BYTES, &tm_v, t * BT, bh, bar_full + 8 * st);
  };
  if (tid == 256) {
    for (int st = 0; st < DQ_STAGES; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, DQ_CONSUMERS);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // Q, dO and the first tile fly while the CTA gathers its rel terms
    mbar_expect_tx(bar_q, 2 * QR_BYTES);
    tma_load(s_q, &tm_q, q0, bh, bar_q);
    tma_load(s_do, &tm_do, q0, bh, bar_q);
    load_kv(0);
  }
  // the CTA's rows of rel_h and of rel_w, two contiguous blocks: copied raw
  // into stages 1-2, then rewritten as fp32 pairs (row r, row r + 8) of the
  // rows a consumer thread holds, pre-scaled by log2(e); 0 past L
  {
    const int rows = min(DQ_ROWS, L - q0);
    bf16* raw_h = reinterpret_cast<bf16*>(smem + DQ_OFF_ST + DQ_STAGE_BYTES);
    bf16* raw_w = raw_h + raw_w_offset(rows * kh);
    const int dh = relpos::copy_block(
        raw_h, rel_h + ((size_t)bh * L + q0) * kh, rows * kh, tid, DQ_THREADS);
    const int dw = relpos::copy_block(
        raw_w, rel_w + ((size_t)bh * L + q0) * kw, rows * kw, tid, DQ_THREADS);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const int pi = tid / 6;  // 64 row pairs, 6 threads each
    const int r0 = (pi >> 3) * 16 + (pi & 7);  // (warpgroup, warp, g)
    const bool v0 = r0 < rows;
    const bool v1 = r0 + 8 < rows;
    for (int c = tid - 6 * pi; c < kh + kw; c += 6) {
      const bf16* src = c < kh ? raw_h + dh + c : raw_w + dw + c - kh;
      const int ld = c < kh ? kh : kw;
      const float x0 = v0 ? __bfloat162float(src[r0 * ld]) : 0.f;
      const float x1 = v1 ? __bfloat162float(src[(r0 + 8) * ld]) : 0.f;
      rel[pi * rs + c] = make_float2(x0 * LOG2E, x1 * LOG2E);
    }
    for (int i = tid; i < (DQ_ROWS / 2) * kh; i += DQ_THREADS)
      gh_sum[i] = make_float2(0.f, 0.f);
    if (tid < E_ROWS) {  // E, one row a thread
      const int rm = tid % kw;
      const int rq = tid / kw;
      uint32_t* row = reinterpret_cast<uint32_t*>(Es + tid * LDE);
#pragma unroll
      for (int w = 0; w < LDE / 2; ++w) {
        uint32_t word = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 2 * w + h;
          const bool one = c < 40 ? rm == c : c < E_COLS && rq == c - 40;
          word |= one ? ONE << (16 * h) : 0u;
        }
        row[w] = word;
      }
    }
    // the staging is read: TMA (the async proxy) may refill stages 1-2
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      for (int t = 1; t < nt; ++t) {
        mbar_wait(bar_empty + 8 * (t % DQ_STAGES),
                  ((t / DQ_STAGES) & 1) ^ 1);
        load_kv(t);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const int pair = wg * 32 + warp * 8 + g;
    const float2* rrow = rel + pair * rs;
    float2* ghrow = gh_sum + pair * kh;
    const int ga = q0 + wg * 64 + warp * 16 + g;  // the thread's rows ga, +8
    const bool va = ga < L;
    const bool vb = ga + 8 < L;
    // padded rows read no lse / delta: their dS is forced to 0
    const float lse_a = va ? lse[(size_t)bh * L + ga] * LOG2E : 0.f;
    const float lse_b = vb ? lse[(size_t)bh * L + ga + 8] * LOG2E : 0.f;
    const float dl_a = va ? delta[(size_t)bh * L + ga] : 0.f;
    const float dl_b = vb ? delta[(size_t)bh * L + ga + 8] : 0.f;
    const float sc = scale * LOG2E;
    const float inv_kw = 1.f / (float)kw;
    const uint64_t dQ = desc_sw128(s_q + wg * 64 * 128, 16, 1024);
    const uint64_t dO = desc_sw128(s_do + wg * 64 * 128, 16, 1024);
    const uint32_t tE = smem_u32(Es);

    float dqa[32], s[32], dp[32];
    float gw[NW][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[i] = s[i] = dp[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) gw[n][i] = 0.f;
    uint32_t ds[4][4];

    mbar_wait(bar_q, 0);
    for (int t = 0; t < nt; ++t) {
      const int st = t % DQ_STAGES;
      mbar_wait(bar_full + 8 * st, (t / DQ_STAGES) & 1);
      const uint32_t s_k = s_st + st * DQ_STAGE_BYTES;
      const uint64_t dK = desc_sw128(s_k, 16, 1024);
      const uint64_t dV = desc_sw128(s_k + KVT_BYTES, 16, 1024);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss(s, dQ + 2 * kk, dK + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss(dp, dO + 2 * kk, dV + 2 * kk, kk);
      wgmma_commit();

      // the bias of the thread's columns 8j + 2tq + e, gathered while S
      // and dP run; a key's grid row is (key + 0.5) / kw in fp32 (exact
      // below 2^22 keys); -inf past L
      const int k0 = t * BT;
      float2 bias[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * tq + e;
          const int kr = (int)(((float)key + 0.5f) * inv_kw);
          float2 x = make_float2(-INFINITY, -INFINITY);
          if (key < L) {
            const float2 h = rrow[kr];
            const float2 w = rrow[kh + key - kr * kw];
            x = make_float2(h.x + w.x, h.y + w.y);
          }
          bias[j][e] = x;
        }
      wgmma_wait0();
      fence_regs(s);
      fence_regs(dp);

      // dS on the fragments, to bf16: the accumulator layout is the
      // A-fragment layout of both the wgmma and the mma.sync products
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ia = 4 * j + e, ib = 4 * j + 2 + e;
          const float pa = exp2f(fmaf(s[ia], sc, bias[j][e].x) - lse_a);
          const float pb = exp2f(fmaf(s[ib], sc, bias[j][e].y) - lse_b);
          s[ia] = va ? pa * (dp[ia] - dl_a) : 0.f;
          s[ib] = vb ? pb * (dp[ib] - dl_b) : 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          ds[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // dq += dS . K (B MN-major: 16 keys a step)
      fence_regs(dqa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_rs(dqa, ds[kk], dK + (uint64_t)(kk * 16 * 128 >> 4));
      wgmma_commit();

      // d rel_w += dS . E_w and this tile's d rel_h = dS . E_h, on this
      // warp's 16 rows
      const int m = k0 % kw;
      float gh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int np = 0; np < 3; ++np) {
          uint32_t b[4];
          ldsm_x4_t(b, e_addr(tE, m + kk * 16, np * 16, lane));
          mma16816(gw[2 * np], ds[kk], b[0], b[1]);
          if (np < 2)
            mma16816(gw[2 * np + 1], ds[kk], b[2], b[3]);
          else
            mma16816(gh, ds[kk], b[2], b[3]);
        }
      }
      wgmma_wait0();
      fence_regs(dqa);
      fence_u32(ds);
      mbar_arrive(bar_empty + 8 * st);
      __syncwarp();  // a bin may have been another lane's in the last tile
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int bin = k0 / kw + 2 * tq + e;
        if (bin < kh) {
          float2 cur = ghrow[bin];
          cur.x += gh[e];
          cur.y += gh[2 + e];
          ghrow[bin] = cur;
        }
      }
    }

    bf16* dqb = dq + (size_t)bh * L * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * tq;
      if (va)
        *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)ga * D + c) =
            __floats2bfloat162_rn(dqa[4 * j] * scale, dqa[4 * j + 1] * scale);
      if (vb)
        *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)(ga + 8) * D + c) =
            __floats2bfloat162_rn(dqa[4 * j + 2] * scale,
                                  dqa[4 * j + 3] * scale);
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = w * 8 + 2 * tq + e;
        if (col < kw) {
          if (va)
            drel_w[((size_t)bh * L + ga) * kw + col] =
                __float2bfloat16(gw[w][e]);
          if (vb)
            drel_w[((size_t)bh * L + ga + 8) * kw + col] =
                __float2bfloat16(gw[w][2 + e]);
        }
      }
    }
    __syncwarp();  // the warp's d rel_h sums were added by all its lanes
    const int row0 = q0 + wg * 64 + warp * 16;
    for (int i = lane; i < 16 * kh; i += 32) {
      const int rr = i / kh;
      const int bin = i - rr * kh;
      const float2 x = gh_sum[(wg * 32 + warp * 8 + (rr & 7)) * kh + bin];
      if (row0 + rr < L)
        drel_h[((size_t)bh * L + row0 + rr) * kh + bin] =
            __float2bfloat16(rr < 8 ? x.x : x.y);
    }
  }
}

// (b) dk and dv on wgmma: one CTA per (128 keys, bh) of three warpgroups.
// Warpgroup 2 produces: K and V of the CTA's keys once by TMA, then per
// query tile of 64 a stage holding Q and dO (TMA, 128-byte swizzle) and the
// tile rows' rel_h, rel_w (bf16), lse and delta (fp32), contiguous blocks
// copied raw by the first warp's cp.async. Each consumer warpgroup owns 64
// keys, two per thread (the accumulator rows r, r + 8):
//   S^T = K . Q^T, dP^T = V . dO^T   wgmma m64n64k16, A and B K-major from
//                                    swizzled shared memory;
//   P^T, dS^T on the accumulator fragments, to bf16 in registers;
//   dv += P^T . dO, dk += dS^T . Q    wgmma m64n64k16, A from registers, B
//                                    (dO, Q: MN-major) from the same tiles.
constexpr int KV_KEYS = 128;                  // keys per CTA
constexpr int KV_THREADS = 384;
constexpr int KV_CONSUMERS = 256;
constexpr int KV_STAGES = 3;
constexpr int QT_BYTES = BT * 128;            // a Q or dO tile, 8 KiB
constexpr int KT_BYTES = KV_KEYS * 128;       // K or V of the CTA, 16 KiB
// full barrier arrivals: the TMA launch, and each producer lane once for
// its cp.async copies and once for its plain tail stores
constexpr int KV_FULL_ARRIVALS = 1 + 2 * 32;

// a stage: [Q | dO | rel_h | rel_w | lse | delta], 1024-byte multiple
__host__ __device__ constexpr int kv_stage_bytes(int kh, int kw) {
  return (2 * QT_BYTES + relpos::block_room<bf16>(BT * kh) * 2 +
          relpos::block_room<bf16>(BT * kw) * 2 +
          2 * relpos::block_room<float>(BT) * 4 + 1023) / 1024 * 1024;
}

// [alignment slack | K | V | barriers | stages]
size_t dkv_smem_bytes(int kh, int kw) {
  return 1024 + 2 * KT_BYTES + 1024 + KV_STAGES * (size_t)kv_stage_bytes(kh, kw);
}

struct QueryStage {
  unsigned char* base;
  bf16 *rh, *rw;
  float *lse, *delta;

  __device__ QueryStage(unsigned char* p, int kh, int kw) : base(p) {
    rh = reinterpret_cast<bf16*>(p + 2 * QT_BYTES);
    rw = rh + relpos::block_room<bf16>(BT * kh);
    lse = reinterpret_cast<float*>(rw + relpos::block_room<bf16>(BT * kw));
    delta = lse + relpos::block_room<float>(BT);
  }
};

// the element offset copy_block gives src inside its destination
template <typename T>
__device__ __forceinline__ int block_offset(const T* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
}

__global__ void __launch_bounds__(KV_THREADS, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           const __grid_constant__ CUtensorMap tm_do,
           const bf16* __restrict__ rel_h, const bf16* __restrict__ rel_w,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int kh,
           int kw, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_k = smem_u32(smem);
  const uint32_t s_v = s_k + KT_BYTES;
  const uint32_t bar_full = s_v + KT_BYTES;            // KV_STAGES x 8
  const uint32_t bar_empty = bar_full + 8 * KV_STAGES;  // KV_STAGES x 8
  const uint32_t bar_kv = bar_empty + 8 * KV_STAGES;
  unsigned char* stages = smem + 2 * KT_BYTES + 1024;
  const int stage_bytes = kv_stage_bytes(kh, kw);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * KV_KEYS;
  const int tid = threadIdx.x;
  const int nt = (L + BT - 1) / BT;

  if (tid == 256) {
    for (int st = 0; st < KV_STAGES; ++st) {
      mbar_init(bar_full + 8 * st, KV_FULL_ARRIVALS);
      mbar_init(bar_empty + 8 * st, KV_CONSUMERS);
    }
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * KT_BYTES);
    tma_load(s_k, &tm_k, k0, bh, bar_kv);
    tma_load(s_v, &tm_v, k0, bh, bar_kv);
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid < 256 + 32) {  // the first producer warp fills the ring
      const int lane = tid & 31;
      for (int t = 0; t < nt; ++t) {
        const int st = t % KV_STAGES;
        const uint32_t full = bar_full + 8 * st;
        mbar_wait(bar_empty + 8 * st, ((t / KV_STAGES) & 1) ^ 1);
        const QueryStage sg(stages + st * stage_bytes, kh, kw);
        const int q0 = t * BT;
        if (lane == 0) {
          mbar_expect_tx(full, 2 * QT_BYTES);
          tma_load(smem_u32(sg.base), &tm_q, q0, bh, full);
          tma_load(smem_u32(sg.base) + QT_BYTES, &tm_do, q0, bh, full);
        }
        const size_t row = (size_t)bh * L + q0;
        const int rows = min(BT, L - q0);
        relpos::copy_block(sg.rh, rel_h + row * kh, rows * kh, lane, 32);
        relpos::copy_block(sg.rw, rel_w + row * kw, rows * kw, lane, 32);
        relpos::copy_block(sg.lse, lse + row, rows, lane, 32);
        relpos::copy_block(sg.delta, delta + row, rows, lane, 32);
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                     ::"r"(full) : "memory");
        mbar_arrive(full);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    // the thread's keys ka, ka + 8: grid row and column
    const int ka = k0 + wg * 64 + warp * 16 + g;
    const bool va = ka < L;
    const bool vb = ka + 8 < L;
    const int ha = va ? ka / kw : 0;
    const int ca = va ? ka % kw : 0;
    const int hb = vb ? (ka + 8) / kw : 0;
    const int cb = vb ? (ka + 8) % kw : 0;
    const uint64_t dK = desc_sw128(s_k + wg * 64 * 128, 16, 1024);
    const uint64_t dV = desc_sw128(s_v + wg * 64 * 128, 16, 1024);

    float dka[32], dva[32], s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = s[i] = dp[i] = 0.f;
    uint32_t pf[4][4], df[4][4];

    mbar_wait(bar_kv, 0);
    for (int t = 0; t < nt; ++t) {
      const int st = t % KV_STAGES;
      mbar_wait(bar_full + 8 * st, (t / KV_STAGES) & 1);
      const QueryStage sg(stages + st * stage_bytes, kh, kw);
      const uint32_t s_q = smem_u32(sg.base);
      const uint32_t s_do = s_q + QT_BYTES;
      const uint64_t dQ = desc_sw128(s_q, 16, 1024);
      const uint64_t dD = desc_sw128(s_do, 16, 1024);

      // S^T = K . Q^T and dP^T = V . dO^T (64 keys x 64 queries)
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss(s, dK + 2 * kk, dQ + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss(dp, dV + 2 * kk, dD + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      fence_regs(dp);

      // P^T and dS^T: column c = 8j + 2tq + e is a query; logits in
      // natural units, then to the exp2 domain
      const int q0 = t * BT;
      const size_t row = (size_t)bh * L + q0;
      const bf16* rh = sg.rh + block_offset(rel_h + row * kh);
      const bf16* rw = sg.rw + block_offset(rel_w + row * kw);
      const float* lq = sg.lse + block_offset(lse + row);
      const float* dq = sg.delta + block_offset(delta + row);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * tq + e;
          const bool qok = q0 + c < L;
          const float l2 = qok ? lq[c] * LOG2E : 0.f;
          const float dl = qok ? dq[c] : 0.f;
          const float bias_a = __bfloat162float(rh[c * kh + ha]) +
                               __bfloat162float(rw[c * kw + ca]);
          const float bias_b = __bfloat162float(rh[c * kh + hb]) +
                               __bfloat162float(rw[c * kw + cb]);
          const int ia = 4 * j + e, ib = 4 * j + 2 + e;
          const float pa =
              exp2f(fmaf(fmaf(s[ia], scale, bias_a), LOG2E, -l2));
          const float pb =
              exp2f(fmaf(fmaf(s[ib], scale, bias_b), LOG2E, -l2));
          s[ia] = qok && va ? pa : 0.f;
          s[ib] = qok && vb ? pb : 0.f;
          dp[ia] = s[ia] * (dp[ia] - dl);
          dp[ib] = s[ib] * (dp[ib] - dl);
        }
      }
      // the accumulator layout is the A-fragment layout of the next products
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pf[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
          df[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }

      // dv += P^T . dO and dk += dS^T . Q (B MN-major: 16 queries a step)
      fence_regs(dva);
      fence_regs(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_rs(dva, pf[kk], dD + (uint64_t)(kk * 16 * 128 >> 4));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_rs(dka, df[kk], dQ + (uint64_t)(kk * 16 * 128 >> 4));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dva);
      fence_regs(dka);
      fence_u32(pf);
      fence_u32(df);
      mbar_arrive(bar_empty + 8 * st);
    }

    bf16* dkb = dk + (size_t)bh * L * D;
    bf16* dvb = dv + (size_t)bh * L * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * tq;
      if (va) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)ka * D + c) =
            __floats2bfloat162_rn(dka[4 * j] * scale, dka[4 * j + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)ka * D + c) =
            __floats2bfloat162_rn(dva[4 * j], dva[4 * j + 1]);
      }
      if (vb) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)(ka + 8) * D + c) =
            __floats2bfloat162_rn(dka[4 * j + 2] * scale,
                                  dka[4 * j + 3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)(ka + 8) * D + c) =
            __floats2bfloat162_rn(dva[4 * j + 2], dva[4 * j + 3]);
      }
    }
  }
}

int launch(const void* q, const void* k, const void* v, const void* rel_h,
           const void* rel_w, const void* dout, const void* lse,
           const void* delta, void* dq, void* dk, void* dv, void* drel_h,
           void* drel_w, int bh, int L, int kh, int kw, float scale,
           cudaStream_t st) {
  // the one-hot expanders: d rel_w in NW n-tiles of 8 columns, and the
  // grid rows of a 64-key tile in one n-tile of 8; then the layouts' bytes
  if (kw > KW_MAX || (BT - 1) / kw + 2 > 8 ||
      dq_smem_bytes(kh, kw) > SMEM_OPTIN ||
      raw_stage_bytes(kh, kw) > RAW_STAGE_ROOM ||
      dkv_smem_bytes(kh, kw) > SMEM_OPTIN)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tq128, tk, tk128, tv, tv128, tdo, tdo128;
  if (!make_map(&tq, q, bh, L, BT) || !make_map(&tq128, q, bh, L, 128) ||
      !make_map(&tk, k, bh, L, BT) || !make_map(&tk128, k, bh, L, 128) ||
      !make_map(&tv, v, bh, L, BT) || !make_map(&tv128, v, bh, L, 128) ||
      !make_map(&tdo, dout, bh, L, BT) ||
      !make_map(&tdo128, dout, bh, L, 128))
    return (int)cudaErrorInvalidValue;
  const size_t smem_a = dq_smem_bytes(kh, kw);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<<<dim3((L + DQ_ROWS - 1) / DQ_ROWS, bh), DQ_THREADS, smem_a,
              st>>>(tq128, tk, tv, tdo128, static_cast<const bf16*>(rel_h),
                    static_cast<const bf16*>(rel_w),
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta), static_cast<bf16*>(dq),
                    static_cast<bf16*>(drel_h), static_cast<bf16*>(drel_w), L,
                    kh, kw, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_b = dkv_smem_bytes(kh, kw);
  err = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<<<dim3((L + KV_KEYS - 1) / KV_KEYS, bh), KV_THREADS, smem_b,
               st>>>(tq, tk128, tv128, tdo, static_cast<const bf16*>(rel_h),
                     static_cast<const bf16*>(rel_w),
                     static_cast<const float*>(lse),
                     static_cast<const float*>(delta), static_cast<bf16*>(dk),
                     static_cast<bf16*>(dv), L, kh, kw, scale);
  return (int)cudaGetLastError();
}

}  // namespace hop

}  // namespace

extern "C" {

int flash_relpos_bwd_bf16(const void* q, const void* k, const void* v,
                          const void* rel_h, const void* rel_w,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, void* dk, void* dv,
                          void* drel_h, void* drel_w, int bh, int L, int kh,
                          int kw, float scale, void* stream) {
  return hop::launch(q, k, v, rel_h, rel_w, dout, lse, delta, dq, dk, dv,
                     drel_h, drel_w, bh, L, kh, kw, scale,
                     static_cast<cudaStream_t>(stream));
}

int flash_relpos_bwd_f32(const void* q, const void* k, const void* v,
                         const void* rel_h, const void* rel_w,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, void* dk, void* dv, void* drel_h,
                         void* drel_w, int bh, int L, int kh, int kw,
                         float scale, void* stream) {
  return tc::launch(q, k, v, rel_h, rel_w, dout, lse, delta, dq, dk, dv,
                    drel_h, drel_w, bh, L, kh, kw, scale,
                    static_cast<cudaStream_t>(stream));
}

const char* flash_relpos_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
