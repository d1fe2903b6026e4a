// Width-generic fused decoder tail, backward on Hopper's tensor cores (K4g
// in bf16 at C >= 9 but 64).
//
// Replaces the TPU kernel painter_tpu/kernels/decoder_head.py:_bwd_impl
// (kernel _make_bwd_kernel, VJP _tail_bwd) at the widths
// decoder_tail_bwd.cu is not built for; kernels/decoder_head.py
// generic_tail_route sends a bf16 width here by its shape alone.
//
// Contract: decoder_tail_bwd.cu's at C channels, from the packed bf16
// parameters of decoder_tail_tc_pack (decoder_tail_tc_fwd.cu): du is rounded
// to bf16 before dpix and dW1; db1, dLN scale, dLN bias, dW2 (from the GELU
// output rounded to bf16) and db2 are fp32 sums. dpix (B, H, W, CD) is
// written whole; dW1 as fp32 partials (slices, 9, C, C) = (tap, c, o) over
// slices of the pixels, the small sums as one fp32 row of 6 C + 3 per CTA
// of the du launch ([db1 | dLN scale | dLN bias | dW2 (c, k) | db2]); the
// wrapper finishes both with one torch.sum each, as the JAX package sums
// its per-block partials.
//
// What bounds it on an H100: operations, three conv3x3 products (the
// forward's recompute, dpix and dW1), 2 N C (27 C + 6) FLOP: at (1, 896,
// 448, 256) 1.42e12 FLOP, 1.44 ms at 989 TFLOP/s bf16 (IO N (2 C + 3) bf16
// values, 0.12 ms at 3.35 TB/s).
//
// What this design does about it: each product on wgmma (bf16 in, fp32
// accumulate), three launches (one count of the wrapper):
//   du    the forward's implicit GEMM (decoder_tail_tc.cuh), then on the
//         fragments: LayerNorm, the GELU and LayerNorm backward (mean(dxhat)
//         and mean(dxhat xhat) exchanged between split warpgroups), du
//         rounded to bf16 into a (B, H, W, CD) scratch. The small partials
//         are summed over each warp's 16 pixels by a reduce-scatter over
//         the 8 rows of the quad column (7 shuffles per 8 channels: each
//         lane ends with one channel's sum) into per-warp fp32 sums in
//         shared memory, summed over the warps once per CTA.
//   dpix  the same GEMM over du with the taps rotated (the box at
//         (x - dx + 1, y - dy + 1)) and B the transposed packing W1T
//         (tap, c, o): the transposed conv without a second layout pass.
//   dW1   (9 C) x C over the pixels: a CTA owns one (pixel slice, tap,
//         pair of 64-channel c chunks, o tile of up to 256) job; A is the
//         tap-shifted pixel box read MN-major (c is M, pixels are K), B the
//         du boxes read MN-major (o is N); warpgroup w accumulates chunk
//         2 p + w over the slice's units and writes its (64 c, NWO o) block
//         of the slice's partial.
// Past 512 channels du is two launches: the GEMM in N tiles writes u to an
// fp32 scratch, and a row kernel (one warp a pixel) forms du and adds the
// small partials into its warp's fp32 row (owner lanes, pixel order).
// No atomics, a static schedule and fixed summation orders: two runs give
// the same bits. Its limit (PERF.md section 7): the du launch's epilogue
// (two GELU evaluations an element, the LayerNorm backward and the
// partials' shuffles) is not overlapped with the products, since both
// consumer warpgroups read every stage and reach their epilogues together:
// at (1, 896, 448, 256) du takes about 1.7 ms against the forward's 0.72,
// dpix 0.69 and dW1 0.59 (H100, 700 W).
//
// The launchers allocate nothing and do not synchronize; they return
// cudaGetLastError() so the caller can raise on a refused launch.
// decoder_tail_tc_partials gives the partial buffers' sizes, so the tiling
// is decided here alone.

#include "decoder_tail_tc.cuh"

namespace tc {

// each lane's 8 values summed over the 8 rows g of its quad column (lanes
// tq, tq + 4, ..., tq + 28), in a fixed order: lane g ends with the sum of
// the element i with scatter_row(i) == g
__device__ __forceinline__ float reduce_scatter8(float (&v)[8], int g) {
  const bool b0 = g & 1, b1 = g & 2, b2 = g & 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float send = b0 ? v[k] : v[k + 4];
    const float keep = b0 ? v[k + 4] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float send = b1 ? v[k] : v[k + 2];
    const float keep = b1 ? v[k + 2] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float send = b2 ? v[0] : v[1];
  const float keep = b2 ? v[1] : v[0];
  return keep + __shfl_xor_sync(0xffffffffu, send, 16);
}

// the row g that holds element i (0..7) after reduce_scatter8
__host__ __device__ __forceinline__ int scatter_row(int i) {
  return (i >> 2) | ((i >> 1) & 1) << 1 | (i & 1) << 2;
}

// sum over the eight accumulator rows g of a warp (lanes 4g + tq)
__device__ __forceinline__ float rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

constexpr int NQ = 6;  // du, dn xhat, dn, g go0, g go1, g go2

// (du) du and the small partials
template <int NW>
struct DuEpi {
  static constexpr int kNW = NW;
  static constexpr int BLK = NW / 32;  // blocks of 8 values a thread and row
  struct Params {
    const bf16* packed;
    const bf16* go;
    bf16* du;
    float* small_part;
    int approx;
  };
  // fp32 b1, LN scale, LN bias, W2T (3, NT); the exchange buffers; the
  // per-warp sums S (8 warps, NQ, BLK, 32 lanes) and db2 (8 warps, 4)
  static int prm_bytes(int nt) {
    return 6 * nt * 4 + XCH_BYTES + 8 * NQ * NW * 4 + 8 * 4 * 4;
  }

  static __device__ __forceinline__ void load(const Params& p, const Geo& geo,
                                              unsigned char* prm, int tid) {
    const int nt = geo.nt(NW), cd = geo.CD;
    float* f = reinterpret_cast<float*>(prm);
    const bf16* pk = p.packed;
    for (int i = tid; i < nt; i += THREADS) {
      const bool in = i < cd;
      f[i] = in ? __bfloat162float(pk[off_b1(cd) + i]) : 0.f;
      f[nt + i] = in ? __bfloat162float(pk[off_lns(cd) + i]) : 0.f;
      f[2 * nt + i] = in ? __bfloat162float(pk[off_lnb(cd) + i]) : 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        f[(3 + k) * nt + i] =
            in ? __bfloat162float(pk[off_w2(cd) + 3 * i + k]) : 0.f;
    }
    float* sums = f + 6 * nt + XCH_BYTES / 4;
    for (int i = tid; i < 8 * NQ * NW + 32; i += THREADS) sums[i] = 0.f;
  }

  const float* prm;
  float* xch;
  float* S;    // this warp's sums
  float* D2;   // the CTA's db2 slots
  const bf16* go;
  bf16* du;
  float* small_part;
  int nt, C, CD, H, W, split, approx, wgl, warp, lane, g, tq, buf;
  float d2[3];  // this thread's db2 (lanes tq == 0)

  __device__ __forceinline__ DuEpi(const Params& p, const Geo& geo,
                                   unsigned char* smem)
      : prm(reinterpret_cast<const float*>(smem)),
        xch(reinterpret_cast<float*>(smem) + 6 * geo.nt(NW)),
        go(p.go), du(p.du), small_part(p.small_part), nt(geo.nt(NW)),
        C(geo.C), CD(geo.CD), H(geo.H), W(geo.W), split(geo.split),
        approx(p.approx), wgl(threadIdx.x >> 5),
        warp((threadIdx.x & 127) >> 5), lane(threadIdx.x & 31),
        g(lane >> 2), tq(lane & 3), buf(0) {
    float* sums = reinterpret_cast<float*>(smem) + 6 * nt + XCH_BYTES / 4;
    S = sums + wgl * NQ * NW;
    D2 = sums + 8 * NQ * NW;
    d2[0] = d2[1] = d2[2] = 0.f;
  }

  __device__ __forceinline__ void unit(float (&acc)[NW / 2], int b, int y,
                                       int x0, bool valid, int wg, int n0) {
    if (approx) unit_as<true>(acc, b, y, x0, valid, wg, n0);
    else unit_as<false>(acc, b, y, x0, valid, wg, n0);
  }

  template <bool APPROX>
  __device__ __forceinline__ void unit_as(float (&acc)[NW / 2], int b, int y,
                                          int x0, bool valid, int wg,
                                          int n0) {
    const float* B1 = prm + n0;
    const float* LNS = B1 + nt;
    const float* LNB = LNS + nt;
    const float* W2T = LNB + nt;
    const int row0 = warp * 16 + g;
    const int lim = C - n0 - 2 * tq;
    bool in[2];
    size_t pix[2];
    float gk[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + row0 + 8 * h;
      in[h] = valid && x < W;
      pix[h] = ((size_t)b * H + y) * W + (in[h] ? x : 0);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        gk[h][k] = in[h] ? __bfloat162float(go[pix[h] * 3 + k]) : 0.f;
    }
    float rstd[2];
    layer_norm<NW>(acc, B1, C, lim, split, xch, buf, wg, row0, tq, rstd);

    // mean_c(dxhat) and mean_c(dxhat xhat) over the real channels
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int c = 8 * j + 2 * tq;
      const float2 sc = *reinterpret_cast<const float2*>(LNS + c);
      const float2 sh = *reinterpret_cast<const float2*>(LNB + c);
      const float2 wa = *reinterpret_cast<const float2*>(W2T + c);
      const float2 wb = *reinterpret_cast<const float2*>(W2T + nt + c);
      const float2 wc = *reinterpret_cast<const float2*>(W2T + 2 * nt + c);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float xh = acc[4 * j + 2 * h + e];
          const float lsc = e ? sc.y : sc.x;
          float gl, gd;
          gelu_and_grad<APPROX>(xh * lsc + (e ? sh.y : sh.x), gl, gd);
          const float dg = gk[h][0] * (e ? wa.y : wa.x) +
                           gk[h][1] * (e ? wb.y : wb.x) +
                           gk[h][2] * (e ? wc.y : wc.x);
          const float dxh = dg * gd * lsc;
          s[h][0] += dxh;
          s[h][1] += dxh * xh;
        }
    }
    quad_sums(s);
    if (split) exchange(s, xch, buf, wg, row0, tq);
    const float mx[2] = {s[0][0] / C, s[1][0] / C};
    const float mxx[2] = {s[0][1] / C, s[1][1] / C};

    // du, stored in bf16 pair by pair, and the partials summed over the
    // two rows, 8 channels (4 j x 2 e) a block
#pragma unroll
    for (int bk = 0; bk < BLK; ++bk) {
      float q[NQ][8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * bk + jj;
        const int c = 8 * j + 2 * tq;
        const float2 sc = *reinterpret_cast<const float2*>(LNS + c);
        const float2 sh = *reinterpret_cast<const float2*>(LNB + c);
        const float2 wa = *reinterpret_cast<const float2*>(W2T + c);
        const float2 wb = *reinterpret_cast<const float2*>(W2T + nt + c);
        const float2 wc = *reinterpret_cast<const float2*>(W2T + 2 * nt + c);
#pragma unroll
        for (int qi = 0; qi < NQ; ++qi) q[qi][2 * jj] = q[qi][2 * jj + 1] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * jj + e;
            const float xh = acc[4 * j + 2 * h + e];
            const float lsc = e ? sc.y : sc.x;
            float gl, gd;
            gelu_and_grad<APPROX>(xh * lsc + (e ? sh.y : sh.x), gl, gd);
            const float dg = gk[h][0] * (e ? wa.y : wa.x) +
                             gk[h][1] * (e ? wb.y : wb.x) +
                             gk[h][2] * (e ? wc.y : wc.x);
            const float dn = dg * gd;
            d[e] = 8 * j + e < lim
                ? rstd[h] * (dn * lsc - mx[h] - xh * mxx[h]) : 0.f;
            if (in[h]) {
              const float gr = bf16_round(gl);
              q[0][i] += d[e];
              q[1][i] += dn * xh;
              q[2][i] += dn;
              q[3][i] += gr * gk[h][0];
              q[4][i] += gr * gk[h][1];
              q[5][i] += gr * gk[h][2];
            }
          }
          if (in[h] && n0 + c < CD)
            *reinterpret_cast<__nv_bfloat162*>(du + pix[h] * CD + n0 + c) =
                __floats2bfloat162_rn(d[0], d[1]);
        }
      }
#pragma unroll
      for (int qi = 0; qi < NQ; ++qi)
        S[(qi * BLK + bk) * 32 + lane] += reduce_scatter8(q[qi], g);
    }
    if (tq == 0 && !(split && wg)) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 3; ++k) d2[k] += gk[h][k];
    }
  }

  // the CTA's row of small partials: per channel the per-warp sums of the
  // warps that hold it (the owning warpgroup's four in split mode, all
  // eight otherwise) in warp order
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float v = rows_sum(d2[k]);
      if (lane == 0) D2[wgl * 4 + k] = v;
    }
    consumers_sync();
    const float* sums = S - wgl * NQ * NW;
    float* row = small_part + (size_t)blockIdx.x * (6 * C + 3);
    for (int slot = threadIdx.x; slot < 6 * C + 3; slot += CONSUMERS) {
      float v = 0.f;
      if (slot >= 6 * C) {
        for (int w = 0; w < 8; ++w) v += D2[w * 4 + slot - 6 * C];
      } else {
        const bool lin = slot < 3 * C;
        const int q = lin ? slot / C : 3 + (slot - 3 * C) % 3;
        const int ch = lin ? slot % C : (slot - 3 * C) / 3;
        const int owner = split ? ch / NW : 0;
        const int local = ch - owner * NW;
        const int j = local / 8, tqq = (local % 8) / 2, e = local % 2;
        const int i = 2 * (j % 4) + e;
        const int at = (q * BLK + j / 4) * 32 + scatter_row(i) * 4 + tqq;
        const int w0 = split ? owner * 4 : 0, w1 = split ? w0 + 4 : 8;
        for (int w = w0; w < w1; ++w) v += sums[w * NQ * NW + at];
      }
      row[slot] = v;
    }
  }
};

// (dpix) the accumulators are the output
template <int NW>
struct DpixEpi {
  static constexpr int kNW = NW;
  struct Params {
    bf16* dpix;
  };
  static int prm_bytes(int) { return 0; }
  static __device__ __forceinline__ void load(const Params&, const Geo&,
                                              unsigned char*, int) {}

  bf16* dpix;
  int CD, H, W, warp, g, tq;

  __device__ __forceinline__ DpixEpi(const Params& p, const Geo& geo,
                                     unsigned char*)
      : dpix(p.dpix), CD(geo.CD), H(geo.H), W(geo.W),
        warp((threadIdx.x & 127) >> 5), g((threadIdx.x & 31) >> 2),
        tq(threadIdx.x & 3) {}

  __device__ __forceinline__ void unit(float (&acc)[NW / 2], int b, int y,
                                       int x0, bool valid, int, int n0) {
    if (!valid) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + warp * 16 + g + 8 * h;
      if (x >= W) continue;
      bf16* dst = dpix + (((size_t)b * H + y) * W + x) * CD + n0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
        if (n0 + 8 * j + 2 * tq < CD)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
    }
  }

  __device__ __forceinline__ void finish() {}
};

// (C > MAX_ROW_C) du and the small partials from each pixel's row of u, one
// warp a pixel; warp w of the grid owns partial row w (6 C + 3 fp32,
// zeroed first), each slot added to by one lane in pixel order. du's
// padded channels [C, CD) are written 0 (dpix reads them).
template <bool APPROX>
__global__ void __launch_bounds__(ROW_WARPS * 32)
row_bwd_kernel(const float* __restrict__ u, const bf16* __restrict__ go,
               const bf16* __restrict__ pk, bf16* __restrict__ du,
               float* __restrict__ small_part, int npix, int C, int CD) {
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const bf16* lns = pk + off_lns(CD);
  const bf16* lnb = pk + off_lnb(CD);
  const bf16* w2 = pk + off_w2(CD);
  float* part = small_part + (size_t)gw * (6 * C + 3);
  for (int i = lane; i < 6 * C + 3; i += 32) part[i] = 0.f;
  __syncwarp();
  for (int p = gw; p < npix; p += gridDim.x * ROW_WARPS) {
    const float* row = u + (size_t)p * CD;
    float gk[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      gk[k] = __bfloat162float(go[(size_t)p * 3 + k]);
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mean = warp_sum(s) / C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / C + LN_EPS);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xh = (row[c] - mean) * rstd;
      const float lsc = __bfloat162float(lns[c]);
      float gl, gd;
      gelu_and_grad<APPROX>(xh * lsc + __bfloat162float(lnb[c]), gl, gd);
      const float dg = gk[0] * __bfloat162float(w2[3 * c]) +
                       gk[1] * __bfloat162float(w2[3 * c + 1]) +
                       gk[2] * __bfloat162float(w2[3 * c + 2]);
      const float dxh = dg * gd * lsc;
      s1 += dxh;
      s2 += dxh * xh;
    }
    const float mx = warp_sum(s1) / C, mxx = warp_sum(s2) / C;
    for (int c = lane; c < CD; c += 32) {
      if (c >= C) {
        du[(size_t)p * CD + c] = __float2bfloat16(0.f);
        continue;
      }
      const float xh = (row[c] - mean) * rstd;
      const float lsc = __bfloat162float(lns[c]);
      float gl, gd;
      gelu_and_grad<APPROX>(xh * lsc + __bfloat162float(lnb[c]), gl, gd);
      const float dg = gk[0] * __bfloat162float(w2[3 * c]) +
                       gk[1] * __bfloat162float(w2[3 * c + 1]) +
                       gk[2] * __bfloat162float(w2[3 * c + 2]);
      const float dn = dg * gd;
      const float d = rstd * (dn * lsc - mx - xh * mxx);
      du[(size_t)p * CD + c] = __float2bfloat16(d);
      const float gr = bf16_round(gl);
      part[c] += d;
      part[C + c] += dn * xh;
      part[2 * C + c] += dn;
#pragma unroll
      for (int k = 0; k < 3; ++k) part[3 * C + 3 * c + k] += gr * gk[k];
    }
    if (lane < 3)
      part[6 * C + lane] += lane == 0 ? gk[0] : lane == 1 ? gk[1] : gk[2];
  }
}

inline int row_grid(int npix) {
  return std::min(sm_count(), (npix + ROW_WARPS - 1) / ROW_WARPS);
}

// --- dW1 ------------------------------------------------------------------------

struct DwGeo {
  int H, C, CD, xt, units, per, slices, cpairs, otiles, nwo, stages,
      stage_bytes;
};

inline DwGeo dw_plan(int B, int H, int W, int C, int CD) {
  DwGeo d;
  d.H = H;
  d.C = C;
  d.CD = CD;
  d.xt = (W + TILE - 1) / TILE;
  d.units = B * H * d.xt;
  d.cpairs = ((CD + KCH - 1) / KCH + 1) / 2;
  d.otiles = (C + 255) / 256;
  d.nwo = ((C + d.otiles - 1) / d.otiles + 63) / 64 * 64;
  const int jobs = TAPS * d.cpairs * d.otiles;
  d.slices = std::max(1, std::min(d.units, sm_count() / jobs));
  d.per = (d.units + d.slices - 1) / d.slices;
  d.stage_bytes = (2 + d.nwo / 64) * BOX;
  d.stages = std::min(MAX_STAGES,
                      (SMEM_MAX - 1024 - BAR_BYTES) / d.stage_bytes);
  return d;
}

// job j = ((slice * 9 + tap) * cpairs + cpair) * otiles + otile
template <int NWO>
__global__ void __launch_bounds__(THREADS, 1)
dw1_kernel(const __grid_constant__ CUtensorMap tm_pix,
           const __grid_constant__ CUtensorMap tm_du,
           float* __restrict__ part, const DwGeo dg) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int S = dg.stages;
  const uint32_t s_ring = smem_u32(smem);
  const uint32_t bar_full = s_ring + S * dg.stage_bytes;
  const uint32_t bar_empty = bar_full + 8 * S;

  int job = blockIdx.x;
  const int ot = job % dg.otiles;
  job /= dg.otiles;
  const int cp = job % dg.cpairs;
  job /= dg.cpairs;
  const int t = job % TAPS, sl = job / TAPS;
  const int dy = t / 3 - 1, dx = t % 3 - 1;
  const int u0 = sl * dg.per;
  const int n = max(0, min(dg.units, u0 + dg.per) - u0);

  // a second c chunk past the channels is not loaded (its warpgroup's
  // products read stale shared memory and its rows are not written)
  const int n_a = (2 * cp + 1) * KCH < dg.CD ? 2 : 1;
  const int tid = threadIdx.x;
  if (tid == CONSUMERS) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      for (int i = 0; i < n; ++i) {
        int b, y, x0;
        const int u = u0 + i;
        x0 = (u % dg.xt) * TILE;
        y = (u / dg.xt) % dg.H;
        b = u / dg.xt / dg.H;
        const int s = i % S;
        mbar_wait(bar_empty + 8 * s, ((i / S) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, dg.stage_bytes - (n_a == 1) * BOX);
        const uint32_t dst = s_ring + s * dg.stage_bytes;
        for (int a = 0; a < n_a; ++a)
          tma_load_4d(dst + a * BOX, &tm_pix, (2 * cp + a) * KCH, x0 + dx,
                      y + dy, b, bar_full + 8 * s);
        for (int m = 0; m < NWO / 64; ++m)
          tma_load_4d(dst + (2 + m) * BOX, &tm_du, ot * NWO + 64 * m, x0, y,
                      b, bar_full + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    float acc[NWO / 2];
#pragma unroll
    for (int i = 0; i < NWO / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int i = 0; i < n; ++i) {
      const int s = i % S;
      mbar_wait(bar_full + 8 * s, (i / S) & 1);
      const uint32_t st = s_ring + s * dg.stage_bytes;
      // A: pixels x 64 c, c is M; B: pixels x NWO o in 64-wide boxes
      const uint64_t da = desc_sw128(st + wg * BOX, 16, 1024);
      const uint64_t db = desc_sw128(st + 2 * BOX, BOX, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        mma<1, 1>(acc, da + 128 * kk, db + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait<1>();
      if (i > 0) mbar_arrive(bar_empty + 8 * ((i - 1) % S));
    }
    wgmma_wait0();
    fence_regs(acc);
    if (n > 0) mbar_arrive(bar_empty + 8 * ((n - 1) % S));

    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int C = dg.C;
    float* base = part + ((size_t)sl * TAPS + t) * C * C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = (2 * cp + wg) * KCH + warp * 16 + g + 8 * h;
      if (c >= C) continue;
      float* row = base + (size_t)c * C;
#pragma unroll
      for (int j = 0; j < NWO / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = ot * NWO + 8 * j + 2 * tq + e;
          if (o < C) row[o] = acc[4 * j + 2 * h + e];
        }
    }
  }
}

int bwd(const void* pix, const void* go, const void* packed, void* u,
        void* du, void* dpix, void* dw1_part, void* small_part, int B, int H,
        int W, int C, int CD, int approx, cudaStream_t st) {
  if (C < 1 || CD < C || CD % 8 || (C > MAX_ROW_C && u == nullptr))
    return (int)cudaErrorInvalidValue;
  const int split = split_for(B, H, W, C);
  const int nw = width_for(C, split);
  const bf16* pk = static_cast<const bf16*>(packed);
  CUtensorMap m_pix, m_du, m_w1p, m_w1t;
  if (!map_pixels(&m_pix, pix, B, H, W, CD) ||
      !map_pixels(&m_du, du, B, H, W, CD) ||
      !map_w1(&m_w1p, pk, CD, nw) || !map_w1(&m_w1t, pk + off_w1t(CD), CD, nw))
    return (int)cudaErrorInvalidValue;
  int err;
  if (C > MAX_ROW_C) {
    const Geo geo = plan(B, H, W, C, CD, split, 256, 0, 0);
    const UEpi<256>::Params p = {pk, static_cast<float*>(u)};
    err = launch_conv<UEpi<256>>(m_pix, m_w1p, p, geo, st);
    if (err) return err;
    const int npix = B * H * W;
    if (approx)
      row_bwd_kernel<true><<<row_grid(npix), ROW_WARPS * 32, 0, st>>>(
          static_cast<const float*>(u), static_cast<const bf16*>(go), pk,
          static_cast<bf16*>(du), static_cast<float*>(small_part), npix, C,
          CD);
    else
      row_bwd_kernel<false><<<row_grid(npix), ROW_WARPS * 32, 0, st>>>(
          static_cast<const float*>(u), static_cast<const bf16*>(go), pk,
          static_cast<bf16*>(du), static_cast<float*>(small_part), npix, C,
          CD);
    err = (int)cudaGetLastError();
  } else {
    err = with_nw(nw, [&](auto nn) {
      constexpr int NW = decltype(nn)::value;
      const int nt = split ? 2 * NW : NW;
      typedef DuEpi<NW> E;
      const Geo geo = plan(B, H, W, C, CD, split, NW, 0, E::prm_bytes(nt));
      const typename E::Params p = {pk, static_cast<const bf16*>(go),
                                    static_cast<bf16*>(du),
                                    static_cast<float*>(small_part), approx};
      return launch_conv<E>(m_pix, m_w1p, p, geo, st);
    });
  }
  if (err) return err;
  err = with_nw(nw, [&](auto nn) {
    constexpr int NW = decltype(nn)::value;
    typedef DpixEpi<NW> E;
    const Geo geo = plan(B, H, W, C, CD, split, NW, 1, 0);
    const typename E::Params p = {static_cast<bf16*>(dpix)};
    return launch_conv<E>(m_du, m_w1t, p, geo, st);
  });
  if (err) return err;
  const DwGeo dg = dw_plan(B, H, W, C, CD);
  return with_nw(dg.nwo, [&](auto nn) {
    constexpr int NWO = decltype(nn)::value;
    const int smem = 1024 + dg.stages * dg.stage_bytes + BAR_BYTES;
    if (dg.stages < 2) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        dw1_kernel<NWO>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dw1_kernel<NWO><<<dg.slices * TAPS * dg.cpairs * dg.otiles, THREADS,
                      smem, st>>>(m_pix, m_du, static_cast<float*>(dw1_part),
                                  dg);
    return (int)cudaGetLastError();
  });
}

}  // namespace tc

extern "C" {

// bf16 pix (B, H, W, CD), go (B, H, W, 3), packed (decoder_tail_tc_pack);
// u an fp32 (B, H, W, CD) scratch past 512 channels, else null; du, dpix
// (B, H, W, CD) bf16; dw1_part (slices, 9, C, C) and small_part (rows,
// 6 C + 3) fp32, sized by decoder_tail_tc_partials
int decoder_tail_tc_bwd(const void* pix, const void* go, const void* packed,
                        void* u, void* du, void* dpix, void* dw1_part,
                        void* small_part, int B, int H, int W, int C, int CD,
                        int approx, void* stream) {
  return tc::bwd(pix, go, packed, u, du, dpix, dw1_part, small_part, B, H, W,
                 C, CD, approx, static_cast<cudaStream_t>(stream));
}

// shape[0]: the dW1 partial's slices, shape[1]: the small partial's rows
void decoder_tail_tc_partials(int B, int H, int W, int C, int CD,
                              int* shape) {
  shape[0] = tc::dw_plan(B, H, W, C, CD).slices;
  if (C > tc::MAX_ROW_C) {  // one row per warp of the row kernel
    shape[1] = tc::row_grid(B * H * W) * tc::ROW_WARPS;
    return;
  }
  const int split = tc::split_for(B, H, W, C);
  const tc::Geo geo = tc::plan(B, H, W, C, CD, split, tc::nw_for(C, split),
                               0, 0);
  shape[1] = geo.grid;
}

const char* decoder_tail_tc_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
