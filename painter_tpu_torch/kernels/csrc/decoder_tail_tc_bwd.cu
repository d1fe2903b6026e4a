// Width-generic fused decoder tail, backward on Hopper's tensor cores: K4g
// in bf16 at C >= 9 but 64, and the fp32 backward at every C >= 9 (K4's
// fp32 route at C = 64 and K4g's in 3xTF32).
//
// Replaces the TPU kernel painter_tpu/kernels/decoder_head.py:_bwd_impl
// (kernel _make_bwd_kernel, VJP _tail_bwd) where kernels/decoder_head.py
// sends a width by its shape and type, as decoder_tail_tc_fwd.cu says.
//
// Contract: decoder_tail_bwd.cu's at C channels, from the packed
// parameters of decoder_tail_tc_pack (decoder_tail_tc_fwd.cu): du is
// rounded to the input type before dpix and dW1 (in fp32: not rounded);
// db1, dLN scale, dLN bias, dW2 (from the GELU output rounded to the input
// type) and db2 are fp32 sums. dpix (B, H, W, CD) is written whole; dW1 as
// fp32 partials (rows, 9, C, C) = (tap, c, o) over slices of the pixels,
// the small sums as one fp32 row of 6 C + 3 per CTA of the du launch ([db1
// | dLN scale | dLN bias | dW2 (c, k) | db2]); the wrapper finishes both
// with one torch.sum each, as the JAX package sums its per-block partials.
//
// What bounds it on an H100: operations, three conv3x3 products (the
// forward's recompute, dpix and dW1), 2 N C (27 C + 6) FLOP: bf16 at (1,
// 896, 448, 256) 1.42e12 FLOP, 1.44 ms at 989 TFLOP/s (IO N (2 C + 3)
// values, 0.12 ms at 3.35 TB/s); fp32 at (2, 896, 448, 64) 1.78e11 FLOP,
// three tf32 products each, 1.080 ms at 495 TFLOP/s TF32 (2.66 ms at fp32's
// 67 TFLOP/s without the tensor cores).
//
// What this design does about it: each product on wgmma (bf16 in, or
// 3xTF32 from split fp32; fp32 accumulate), three launches (one count of
// the wrapper):
//   du    the forward's implicit GEMM (decoder_tail_tc.cuh), then on the
//         fragments: LayerNorm, the GELU and LayerNorm backward (mean(dxhat)
//         and mean(dxhat xhat) exchanged between split warpgroups), du
//         into a (B, H, W, CD) scratch of the input type. The small partials
//         are summed over each warp's 16 pixels by a reduce-scatter over
//         the 8 rows of the quad column (7 shuffles per 8 channels: each
//         lane ends with one channel's sum) into per-warp fp32 sums in
//         shared memory, summed over the warps once per CTA.
//   dpix  the same GEMM over du with the taps rotated (the box at
//         (x - dx + 1, y - dy + 1)) and B the transposed packing W1T
//         (tap, c, o): the transposed conv without a second layout pass.
//   dW1   (9 C) x C over the pixels. bf16: a CTA owns one (pixel slice, tap,
//         pair of 64-channel c chunks, o tile of up to 256) job; A is the
//         tap-shifted pixel box read MN-major (c is M, pixels are K), B the
//         du boxes read MN-major (o is N); warpgroup w accumulates chunk
//         2 p + w over the slice's units and writes its (64 c, NWO o) block
//         of the slice's partial. fp32 (dw1_tf32_kernel): tf32 wgmma reads
//         shared memory K-major only, and here both operands have the
//         pixels as K with the channels contiguous. A (c as M) comes from
//         registers, gathered from the pixel boxes and split there; B (o as
//         N) is a second copy of du that the du launch's epilogue writes
//         already split and transposed, (2, B, H, CD, 64 xt) with each
//         channel's unit-padded image row contiguous, so that TMA loads it
//         K-major: 2 N CD fp32 more written and read (0.21 ms at (2, 896,
//         448, 64) at 3.35 TB/s), where a transposing split per stage in
//         shared memory would cost the consumers a pass and a barrier per
//         unit. A CTA owns one (pixel slice, tap, 64-channel c chunk,
//         64-channel o tile) job; its two warpgroups take the slice's even
//         and odd units, each product summed per unit into register totals,
//         and each writes its own partial row.
// Past MAX_ROW_C channels (256 in fp32) du is two launches: the GEMM in N
// tiles writes u to an fp32 scratch, and a row kernel (one warp a pixel)
// forms du and adds the small partials into its warp's fp32 row (owner
// lanes, pixel order).
// No atomics, a static schedule and fixed summation orders: two runs give
// the same bits. Its limit (PERF.md section 7): the du launch's epilogue
// (two GELU evaluations an element, the LayerNorm backward and the
// partials' shuffles) is not overlapped with the products, since both
// consumer warpgroups read every stage and reach their epilogues together:
// bf16 at (1, 896, 448, 256) du takes about 1.7 ms against the forward's
// 0.72, dpix 0.69 and dW1 0.59 (H100, 700 W).
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

// two adjacent channels of a (B, H, W, CD) output in its type
__device__ __forceinline__ void store_pair(bf16* dst, const float (&v)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v[0], v[1]);
}
__device__ __forceinline__ void store_pair(float* dst, const float (&v)[2]) {
  *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
}

// (du) du and the small partials
template <int NW, class T_>
struct DuEpi {
  static constexpr int kNW = NW;
  typedef T_ T;
  static constexpr bool EXACT = Ty<T>::PARTS == 2;  // fp32: tanhf, du^T
  static constexpr int BLK = NW / 32;  // blocks of 8 values a thread and row
  struct Params {
    const T* packed;
    const T* go;
    T* du;
    float* small_part;
    float* dut;       // fp32: du^T's big parts, small ones at + dut_half
    size_t dut_half;
    int approx;
  };
  // fp32 b1, LN scale, LN bias, W2T (3, NT); the exchange buffers; the
  // per-warp sums S (8 warps, NQ, BLK, 32 lanes) and db2 (8 warps, 4)
  static int prm_bytes(int nt) {
    return 6 * nt * 4 + XCH_BYTES + 8 * NQ * NW * 4 + 8 * 4 * 4;
  }

  static __device__ __forceinline__ void load(const Params& p, const Geo& geo,
                                              unsigned char* prm, int tid) {
    const int nt = geo.nt(NW), cd = geo.CD, parts = Ty<T>::PARTS;
    float* f = reinterpret_cast<float*>(prm);
    const T* pk = p.packed;
    for (int i = tid; i < nt; i += THREADS) {
      const bool in = i < cd;
      f[i] = in ? to_f(pk[off_b1(cd, parts) + i]) : 0.f;
      f[nt + i] = in ? to_f(pk[off_lns(cd, parts) + i]) : 0.f;
      f[2 * nt + i] = in ? to_f(pk[off_lnb(cd, parts) + i]) : 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        f[(3 + k) * nt + i] =
            in ? to_f(pk[off_w2(cd, parts) + 3 * i + k]) : 0.f;
    }
    float* sums = f + 6 * nt + XCH_BYTES / 4;
    for (int i = tid; i < 8 * NQ * NW + 32; i += THREADS) sums[i] = 0.f;
  }

  const float* prm;
  float* xch;
  float* S;    // this warp's sums
  float* D2;   // the CTA's db2 slots
  const T* go;
  T* du;
  float* small_part;
  float* dut;
  size_t dut_half;
  int nt, C, CD, H, W, WP, split, approx, wgl, warp, lane, g, tq, buf;
  float d2[3];  // this thread's db2 (lanes tq == 0)

  __device__ __forceinline__ DuEpi(const Params& p, const Geo& geo,
                                   unsigned char* smem)
      : prm(reinterpret_cast<const float*>(smem)),
        xch(reinterpret_cast<float*>(smem) + 6 * geo.nt(NW)),
        go(p.go), du(p.du), small_part(p.small_part), dut(p.dut),
        dut_half(p.dut_half), nt(geo.nt(NW)), C(geo.C), CD(geo.CD), H(geo.H),
        W(geo.W), WP(geo.xt * TILE), split(geo.split),
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
        gk[h][k] = in[h] ? to_f(go[pix[h] * 3 + k]) : 0.f;
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
          gelu_and_grad<APPROX, EXACT>(xh * lsc + (e ? sh.y : sh.x), gl, gd);
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

    // du, stored in its type pair by pair, and the partials summed over the
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
            gelu_and_grad<APPROX, EXACT>(xh * lsc + (e ? sh.y : sh.x), gl, gd);
            const float dg = gk[h][0] * (e ? wa.y : wa.x) +
                             gk[h][1] * (e ? wb.y : wb.x) +
                             gk[h][2] * (e ? wc.y : wc.x);
            const float dn = dg * gd;
            d[e] = 8 * j + e < lim
                ? rstd[h] * (dn * lsc - mx[h] - xh * mxx[h]) : 0.f;
            if (in[h]) {
              const float gr = round_as(gl, du);
              q[0][i] += d[e];
              q[1][i] += dn * xh;
              q[2][i] += dn;
              q[3][i] += gr * gk[h][0];
              q[4][i] += gr * gk[h][1];
              q[5][i] += gr * gk[h][2];
            }
          }
          if (in[h] && n0 + c < CD) store_pair(du + pix[h] * CD + n0 + c, d);
          if (EXACT && valid && n0 + c < CD) {
            // du^T split, every pixel of the unit (0 past W) for dW1's B
            float* dst = dut + (((size_t)b * H + y) * CD + n0 + c) * WP + x0
                + row0 + 8 * h;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              uint32_t big, small;
              tf32x3::split(in[h] ? d[e] : 0.f, big, small);
              dst[e * WP] = __uint_as_float(big);
              dst[e * WP + dut_half] = __uint_as_float(small);
            }
          }
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
template <int NW, class T_>
struct DpixEpi {
  static constexpr int kNW = NW;
  typedef T_ T;
  struct Params {
    T* dpix;
  };
  static int prm_bytes(int) { return 0; }
  static __device__ __forceinline__ void load(const Params&, const Geo&,
                                              unsigned char*, int) {}

  T* dpix;
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
      T* dst = dpix + (((size_t)b * H + y) * W + x) * CD + n0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
        if (n0 + 8 * j + 2 * tq < CD) {
          const float v[2] = {acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]};
          store_pair(dst + 8 * j, v);
        }
    }
  }

  __device__ __forceinline__ void finish() {}
};

// (C > Ty<T>::ROW_C) du and the small partials from each pixel's row of u,
// one warp a pixel; warp w of the grid owns partial row w (6 C + 3 fp32,
// zeroed first), each slot added to by one lane in pixel order. du's
// padded channels [C, CD) are written 0 (dpix reads them). fp32 also writes
// du^T split (see DuEpi), the columns past W of each image row zero, by the
// warp of the row's last pixel.
template <bool APPROX, class T>
__global__ void __launch_bounds__(ROW_WARPS * 32)
row_bwd_kernel(const float* __restrict__ u, const T* __restrict__ go,
               const T* __restrict__ pk, T* __restrict__ du,
               float* __restrict__ small_part, float* __restrict__ dut,
               size_t dut_half, int npix, int W, int WP, int C, int CD) {
  constexpr int PARTS = Ty<T>::PARTS;
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const T* lns = pk + off_lns(CD, PARTS);
  const T* lnb = pk + off_lnb(CD, PARTS);
  const T* w2 = pk + off_w2(CD, PARTS);
  float* part = small_part + (size_t)gw * (6 * C + 3);
  for (int i = lane; i < 6 * C + 3; i += 32) part[i] = 0.f;
  __syncwarp();
  for (int p = gw; p < npix; p += gridDim.x * ROW_WARPS) {
    const float* row = u + (size_t)p * CD;
    const int x = p % W;
    float gk[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) gk[k] = to_f(go[(size_t)p * 3 + k]);
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
      const float lsc = to_f(lns[c]);
      float gl, gd;
      gelu_and_grad<APPROX, PARTS == 2>(xh * lsc + to_f(lnb[c]), gl, gd);
      const float dg = gk[0] * to_f(w2[3 * c]) + gk[1] * to_f(w2[3 * c + 1]) +
                       gk[2] * to_f(w2[3 * c + 2]);
      const float dxh = dg * gd * lsc;
      s1 += dxh;
      s2 += dxh * xh;
    }
    const float mx = warp_sum(s1) / C, mxx = warp_sum(s2) / C;
    for (int c = lane; c < CD; c += 32) {
      float d = 0.f;
      if (c < C) {
        const float xh = (row[c] - mean) * rstd;
        const float lsc = to_f(lns[c]);
        float gl, gd;
        gelu_and_grad<APPROX, PARTS == 2>(xh * lsc + to_f(lnb[c]), gl, gd);
        const float dg = gk[0] * to_f(w2[3 * c]) +
                         gk[1] * to_f(w2[3 * c + 1]) +
                         gk[2] * to_f(w2[3 * c + 2]);
        const float dn = dg * gd;
        d = rstd * (dn * lsc - mx - xh * mxx);
        const float gr = round_as(gl, pk);
        part[c] += d;
        part[C + c] += dn * xh;
        part[2 * C + c] += dn;
#pragma unroll
        for (int k = 0; k < 3; ++k) part[3 * C + 3 * c + k] += gr * gk[k];
      }
      du[(size_t)p * CD + c] = from_f<T>(d);
      if (PARTS == 2) {
        float* col = dut + ((size_t)(p / W) * CD) * WP + x;  // (b, y, 0, x)
        uint32_t big, small;
        tf32x3::split(d, big, small);
        col[(size_t)c * WP] = __uint_as_float(big);
        col[(size_t)c * WP + dut_half] = __uint_as_float(small);
        if (x == W - 1)
          for (int xx = 1; xx < WP - x; ++xx) {
            col[(size_t)c * WP + xx] = 0.f;
            col[(size_t)c * WP + xx + dut_half] = 0.f;
          }
      }
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

// bf16
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

// fp32: jobs of one 64-channel c chunk (cpairs counts them) and one
// 64-channel o tile; a stage is one unit: its two pixel boxes (32 channels
// each) and du^T's (64 o, 2 x 32 pixels) boxes, big then small; the rows
// of the partial are 2 x slices (one per warpgroup)
inline DwGeo dw_plan_f32(int B, int H, int W, int C, int CD) {
  DwGeo d;
  d.H = H;
  d.C = C;
  d.CD = CD;
  d.xt = (W + TILE - 1) / TILE;
  d.units = B * H * d.xt;
  d.cpairs = (CD + 63) / 64;
  d.otiles = (C + 63) / 64;
  d.nwo = 64;
  const int jobs = TAPS * d.cpairs * d.otiles;
  d.slices = std::max(1, std::min(d.units, sm_count() / jobs));
  d.per = (d.units + d.slices - 1) / d.slices;
  d.stage_bytes = 6 * BOX;
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

// job j = ((slice * 9 + tap) * cpairs + c chunk) * otiles + o tile (fp32).
// Warpgroup w takes units i = w, w + 2, ... of the slice (stage i % S, so
// each stage has one reader), its A the shifted pixel boxes' (64 c, 64
// pixels) gathered from the two K-major boxes (c is M: box c / 32, row the
// pixel, column c % 32) and split in registers, its B du^T's boxes (64 o
// rows, pixels as K: k8 steps 0-3 in the first box, 4-7 in the second),
// 3 x 8 k8 products a unit into a zeroed accumulator, added into the
// totals; its partial row is 2 slice + w.
__global__ void __launch_bounds__(THREADS, 1)
dw1_tf32_kernel(const __grid_constant__ CUtensorMap tm_pix,
                const __grid_constant__ CUtensorMap tm_dut,
                float* __restrict__ part, const DwGeo dg, int B) {
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
  const int cc = job % dg.cpairs;
  job /= dg.cpairs;
  const int t = job % TAPS, sl = job / TAPS;
  const int dy = t / 3 - 1, dx = t % 3 - 1;
  const int u0 = sl * dg.per;
  const int n = max(0, min(dg.units, u0 + dg.per) - u0);
  // a second pixel box past the channels is not loaded (warps 2 and 3 read
  // stale shared memory; their rows are not written)
  const int n_a = cc * 64 + 32 < dg.CD ? 2 : 1;

  const int tid = threadIdx.x;
  if (tid == CONSUMERS) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS / 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      for (int i = 0; i < n; ++i) {
        const int u = u0 + i;
        const int x0 = (u % dg.xt) * TILE;
        const int y = (u / dg.xt) % dg.H;
        const int b = u / dg.xt / dg.H;
        const int s = i % S;
        mbar_wait(bar_empty + 8 * s, ((i / S) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, (4 + n_a) * BOX);
        const uint32_t dst = s_ring + s * dg.stage_bytes;
        for (int a = 0; a < n_a; ++a)
          tma_load_4d(dst + a * BOX, &tm_pix, cc * 64 + 32 * a, x0 + dx,
                      y + dy, b, bar_full + 8 * s);
        for (int q = 0; q < 2; ++q)
          for (int kq = 0; kq < 2; ++kq)
            tma_load_4d(dst + (2 + 2 * q + kq) * BOX, &tm_dut, x0 + 32 * kq,
                        ot * 64, y, b + q * B, bar_full + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    float tot[32], acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) tot[i] = 0.f;
    for (int i = wg; i < n; i += 2) {
      const int s = i % S;
      mbar_wait(bar_full + 8 * s, (i / S) & 1);
      const unsigned char* st = smem + s * dg.stage_bytes;
      // A (c, pixel): c = 16 warp + g (+ 8) lies in box c / 32
      const unsigned char* box = st + (warp >> 1) * BOX;
      const int cl = (warp & 1) * 16 + g;
      uint32_t ab[8][4], as[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int px = 8 * kk + tq + 4 * (r >> 1), c = cl + 8 * (r & 1);
          const float v = *reinterpret_cast<const float*>(
              box + tf32x3::sw_off(px, c, TILE));
          tf32x3::split(v, ab[kk][r], as[kk][r]);
        }
      const uint32_t sb = s_ring + s * dg.stage_bytes + 2 * BOX;
      wgmma_fence();
      tf32x3::mma3_rs<64, 8>(acc, ab, as, desc_sw128(sb, 16, 1024),
                             desc_sw128(sb + 2 * BOX, 16, 1024), TILE, 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      mbar_arrive(bar_empty + 8 * s);
#pragma unroll
      for (int k = 0; k < 32; ++k) tot[k] += acc[k];
    }

    const int C = dg.C;
    float* base = part + (((size_t)(2 * sl + wg)) * TAPS + t) * C * C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = cc * 64 + warp * 16 + g + 8 * h;
      if (c >= C) continue;
      float* row = base + (size_t)c * C;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = ot * 64 + 8 * j + 2 * tq + e;
          if (o < C) row[o] = tot[4 * j + 2 * h + e];
        }
    }
  }
}

// du^T (2, B, H, CD, WP) fp32 as 4-D boxes of (32 pixels, 64 channel rows)
inline bool map_dut(CUtensorMap* map, const void* dut, int B, int H, int CD,
                    int WP) {
  const cuuint64_t dims[4] = {(cuuint64_t)WP, (cuuint64_t)CD, (cuuint64_t)H,
                              (cuuint64_t)2 * B};
  const cuuint64_t strides[3] = {(cuuint64_t)WP * 4, (cuuint64_t)CD * WP * 4,
                                 (cuuint64_t)H * CD * WP * 4};
  const cuuint32_t box[4] = {32, 64, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dut, dims,
                    strides, box);
}

template <class T>
int bwd(const void* pix, const void* go, const void* packed, void* u,
        void* du, void* dut, void* dpix, void* dw1_part, void* small_part,
        int B, int H, int W, int C, int CD, int approx, cudaStream_t st) {
  constexpr bool F32 = Ty<T>::PARTS == 2;
  if (C < 1 || CD < C || CD % 8 || (C > Ty<T>::ROW_C && u == nullptr) ||
      (F32 && dut == nullptr))
    return (int)cudaErrorInvalidValue;
  const int split = split_for<T>(B, H, W, C);
  const int nw = width_for<T>(C, split);
  const T* pk = static_cast<const T*>(packed);
  const int parts = Ty<T>::PARTS;
  const int WP = (W + TILE - 1) / TILE * TILE;
  const size_t dut_half = (size_t)B * H * CD * WP;
  CUtensorMap m_pix, m_du, m_w1p, m_w1t, m_dut;
  if (!map_pixels<T>(&m_pix, pix, B, H, W, CD) ||
      !map_pixels<T>(&m_du, du, B, H, W, CD) ||
      !map_w1<T>(&m_w1p, pk, CD, nw) ||
      !map_w1<T>(&m_w1t, pk + off_w1t(CD, parts), CD, nw) ||
      (F32 && !map_dut(&m_dut, dut, B, H, CD, WP)))
    return (int)cudaErrorInvalidValue;
  int err;
  if (C > Ty<T>::ROW_C) {
    constexpr int NWM = Ty<T>::NW_MAX;
    const Geo geo = plan<T>(B, H, W, C, CD, split, NWM, 0, 0);
    const typename UEpi<NWM, T>::Params p = {pk, static_cast<float*>(u)};
    err = launch_conv<UEpi<NWM, T>>(m_pix, m_w1p, p, geo, st);
    if (err) return err;
    const int npix = B * H * W;
    if (approx)
      row_bwd_kernel<true, T><<<row_grid(npix), ROW_WARPS * 32, 0, st>>>(
          static_cast<const float*>(u), static_cast<const T*>(go), pk,
          static_cast<T*>(du), static_cast<float*>(small_part),
          static_cast<float*>(dut), dut_half, npix, W, WP, C, CD);
    else
      row_bwd_kernel<false, T><<<row_grid(npix), ROW_WARPS * 32, 0, st>>>(
          static_cast<const float*>(u), static_cast<const T*>(go), pk,
          static_cast<T*>(du), static_cast<float*>(small_part),
          static_cast<float*>(dut), dut_half, npix, W, WP, C, CD);
    err = (int)cudaGetLastError();
  } else {
    err = with_nw<T>(nw, [&](auto nn) {
      constexpr int NW = decltype(nn)::value;
      const int nt = split ? 2 * NW : NW;
      typedef DuEpi<NW, T> E;
      const Geo geo = plan<T>(B, H, W, C, CD, split, NW, 0,
                              E::prm_bytes(nt));
      const typename E::Params p = {
          pk, static_cast<const T*>(go), static_cast<T*>(du),
          static_cast<float*>(small_part), static_cast<float*>(dut), dut_half,
          approx};
      return launch_conv<E>(m_pix, m_w1p, p, geo, st);
    });
  }
  if (err) return err;
  err = with_nw<T>(nw, [&](auto nn) {
    constexpr int NW = decltype(nn)::value;
    typedef DpixEpi<NW, T> E;
    const Geo geo = plan<T>(B, H, W, C, CD, split, NW, 1, 0);
    const typename E::Params p = {static_cast<T*>(dpix)};
    return launch_conv<E>(m_du, m_w1t, p, geo, st);
  });
  if (err) return err;
  if constexpr (F32) {
    const DwGeo dg = dw_plan_f32(B, H, W, C, CD);
    const int smem = 1024 + dg.stages * dg.stage_bytes + BAR_BYTES;
    if (dg.stages < 2) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        dw1_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dw1_tf32_kernel<<<dg.slices * TAPS * dg.cpairs * dg.otiles, THREADS,
                      smem, st>>>(m_pix, m_dut,
                                  static_cast<float*>(dw1_part), dg, B);
    return (int)cudaGetLastError();
  } else {
    const DwGeo dg = dw_plan(B, H, W, C, CD);
    return with_nw<T>(dg.nwo, [&](auto nn) {
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
  return tc::bwd<tc::bf16>(pix, go, packed, u, du, nullptr, dpix, dw1_part,
                           small_part, B, H, W, C, CD, approx,
                           static_cast<cudaStream_t>(stream));
}

// the same in fp32 (packed by decoder_tail_tc_pack_f32; u past 256
// channels), with dut a (2, B, H, CD, 64 ceil(W / 64)) fp32 scratch for du^T
int decoder_tail_tc_bwd_f32(const void* pix, const void* go,
                            const void* packed, void* u, void* du, void* dut,
                            void* dpix, void* dw1_part, void* small_part,
                            int B, int H, int W, int C, int CD, int approx,
                            void* stream) {
  return tc::bwd<float>(pix, go, packed, u, du, dut, dpix, dw1_part,
                        small_part, B, H, W, C, CD, approx,
                        static_cast<cudaStream_t>(stream));
}

// shape[0]: the dW1 partial's rows, shape[1]: the small partial's rows
void decoder_tail_tc_partials(int B, int H, int W, int C, int CD,
                              int* shape) {
  shape[0] = tc::dw_plan(B, H, W, C, CD).slices;
  if (C > tc::MAX_ROW_C) {  // one row per warp of the row kernel
    shape[1] = tc::row_grid(B * H * W) * tc::ROW_WARPS;
    return;
  }
  const int split = tc::split_for<tc::bf16>(B, H, W, C);
  shape[1] = tc::plan<tc::bf16>(B, H, W, C, CD, split, tc::nw_for(C, split),
                                0, 0).grid;
}

// the same for the fp32 launcher (two dW1 rows per pixel slice)
void decoder_tail_tc_partials_f32(int B, int H, int W, int C, int CD,
                                  int* shape) {
  shape[0] = 2 * tc::dw_plan_f32(B, H, W, C, CD).slices;
  if (C > tc::Ty<float>::ROW_C) {
    shape[1] = tc::row_grid(B * H * W) * tc::ROW_WARPS;
    return;
  }
  const int split = tc::split_for<float>(B, H, W, C);
  shape[1] = tc::plan<float>(B, H, W, C, CD, split, tc::nw_for(C, split), 0,
                             0).grid;
}

const char* decoder_tail_tc_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
