// Width-generic fused decoder tail, forward on Hopper's tensor cores: K3g
// in bf16 at C >= 9 but 64, and the fp32 forward at every C >= 9 (K3's
// fp32 route at C = 64 and K3g's in 3xTF32); and the one launch that packs
// the parameters for these kernels and the backward's.
//
// Replaces the TPU kernel painter_tpu/kernels/decoder_head.py:_fwd_impl
// (kernel _make_fwd_kernel) where kernels/decoder_head.py sends a width by
// its shape and type: generic_tail_route's "tc" (bf16 at C >= 9 but 64,
// fp32 at C >= 9 but 64), and decoder_route's "vitl" in fp32 (C = 64; bf16
// there runs decoder_tail_fwd.cu). C <= 8 stays on decoder_tail_generic.cu.
//
// Contract: decoder_tail_fwd.cu's at C channels (conv3x3 + b1 ->
// LayerNorm over the C channels, eps 1e-6, mean and the centred variance
// in fp32 -> GELU, rounded to the input type -> the 3 output dots + b2,
// out in the input type), with the weights cast to the input type first
// (decoder_tail_tc_pack). The pixels are (B, H, W, CD) in the input type,
// CD = C rounded up to 8 (the wrapper pads only where C % 8 != 0); channels
// past CD read as zero through TMA's fill. In fp32 no value is rounded to
// a narrower type: the products keep ~21 of fp32's 24 bits (3xTF32), the
// sums are fp32, and GELU runs on erff / tanhf.
//
// What bounds it on an H100: operations, 2 N C (9 C + 3) FLOP for N =
// B H W pixels against N (C + 3) values of IO: bf16 at (1, 896, 448, 256)
// 4.74e11 FLOP, 0.479 ms at 989 TFLOP/s (0.062 ms of IO at 3.35 TB/s);
// fp32 at (2, 896, 448, 64) 5.95e10 FLOP, three tf32 products each, 0.361
// ms at 495 TFLOP/s TF32 (0.888 ms at fp32's 67 TFLOP/s without the tensor
// cores; 0.064 ms of IO).
//
// What this design does about it: the conv3x3 runs on wgmma as the implicit
// GEMM of decoder_tail_tc.cuh (bf16 in, or 3xTF32 from split fp32; fp32
// accumulate): 64-pixel units (M), the output channels (N, up to 256 a
// warpgroup in bf16, 128 in fp32), 9 taps x 128-byte channel chunks (K),
// pixel boxes and streamed W1 slabs through a TMA ring. Up to 512 channels
// (256 in fp32) u never leaves the registers: the LayerNorm, GELU and the
// C -> 3 dots run on the accumulator fragments (quad sums, exchanged
// between the two warpgroups where they split a pixel's channels), and only
// the 3 outputs are written. Past that the GEMM runs in N tiles, u goes
// through an fp32 scratch, and a row kernel (one warp a pixel) does the
// rest. fp32's W1 is split once, by the packing launch, into big and small
// tf32 parts; the pixels are split in the consumers' registers.
//
// Its limit (PERF.md section 7): W1 is re-read from L2 for every item
// (128 pixels in whole-rows mode, 64 in split mode), 9 CD^2 values per item
// (twice that in fp32); every (tap, chunk) step waits on its own pixel box
// (the input rows are not reused across the taps as the C = 64 strip kernel
// reuses them); and the epilogue is not overlapped with the products (both
// consumer warpgroups read every stage). bf16: 0.72 ms at (1, 896, 448,
// 256), 65% of its bound (H100, 700 W). fp32: each step also waits for its
// products before the totals take them (wait_group 0).
//
// The launchers allocate nothing and do not synchronize; they return
// cudaGetLastError() so the caller can raise on a refused launch.

#include "decoder_tail_tc.cuh"

namespace tc {

// W1 (C, C, 3, 3) = (o, c, kh, kw), b1, LN scale, LN bias (C), W2 (3, C,
// 1, 1) and b2 (3) fp32 (b2 may be null: zero) -> the packed buffer of
// decoder_tail_tc.cuh in T: rounded to nearest as torch's cast rounds
// (bf16), or W1 split into big = tf32_rn(w) and small = tf32_rn(w - big)
// (fp32; the other parameters as they are)
template <class T>
__global__ void pack_kernel(const float* __restrict__ w1,
                            const float* __restrict__ b1,
                            const float* __restrict__ lns,
                            const float* __restrict__ lnb,
                            const float* __restrict__ w2,
                            const float* __restrict__ b2,
                            T* __restrict__ out, int C, int CD) {
  constexpr int PARTS = Ty<T>::PARTS;
  const size_t n = packed_size(CD, PARTS);
  const size_t plane = (size_t)CD * CD;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    if (i < off_b1(CD, PARTS)) {
      // W1P (part, tap, o, c); else W1T (part, tap, c, o)
      const bool oc = i < off_w1t(CD, PARTS);
      const size_t r = oc ? i : i - off_w1t(CD, PARTS);
      const int q = (int)(r / (TAPS * plane));  // the part
      const size_t rt = r - q * TAPS * plane;
      const int t = (int)(rt / plane);
      const int rem = (int)(rt - t * plane);
      const int row = rem / CD, col = rem - row * CD;
      const int o = oc ? row : col, c = oc ? col : row;
      if (o < C && c < C) v = w1[((size_t)o * C + c) * TAPS + t];
      if (PARTS == 2) {
        uint32_t big, small;
        tf32x3::split(v, big, small);
        v = __uint_as_float(q ? small : big);
      }
    } else {
      const int r = (int)(i - off_b1(CD, PARTS));
      if (r < 3 * CD) {
        const int q = r / CD, c = r - q * CD;
        if (c < C) v = (q == 0 ? b1 : q == 1 ? lns : lnb)[c];
      } else if (r < 6 * CD) {
        const int c = (r - 3 * CD) / 3, k = (r - 3 * CD) % 3;
        if (c < C) v = w2[k * C + c];
      } else if (b2 != nullptr) {
        v = b2[r - 6 * CD];
      }
    }
    out[i] = from_f<T>(v);
  }
}

template <int NW, class T_>
struct FwdEpi {
  static constexpr int kNW = NW;
  typedef T_ T;
  static constexpr bool EXACT = Ty<T>::PARTS == 2;  // fp32: tanhf
  struct Params {
    const T* packed;
    T* out;
    int approx;
  };
  // fp32 b1, LN scale, LN bias, W2T (3, NT) and b2 (4) over the CTA's NT
  // channels, then the exchange buffers
  static int prm_bytes(int nt) { return (6 * nt + 4) * 4 + XCH_BYTES; }

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
    if (tid < 3) f[6 * nt + tid] = to_f(pk[off_b2(cd, parts) + tid]);
  }

  const float* prm;
  float* xch;
  T* out;
  int nt, C, H, W, split, approx, warp, lane, g, tq, buf;

  __device__ __forceinline__ FwdEpi(const Params& p, const Geo& geo,
                                    unsigned char* smem)
      : prm(reinterpret_cast<const float*>(smem)),
        xch(reinterpret_cast<float*>(smem) + 6 * geo.nt(NW) + 4),
        out(p.out), nt(geo.nt(NW)), C(geo.C), H(geo.H), W(geo.W),
        split(geo.split), approx(p.approx), warp((threadIdx.x & 127) >> 5),
        lane(threadIdx.x & 31), g(lane >> 2), tq(lane & 3), buf(0) {}

  __device__ __forceinline__ void unit(float (&acc)[NW / 2], int b, int y,
                                       int x0, bool valid, int wg, int n0) {
    if (approx) unit_as<true>(acc, b, y, x0, valid, wg, n0);
    else unit_as<false>(acc, b, y, x0, valid, wg, n0);
  }

  // one GELU flavour a unit: a branch per element on the flavour kept the
  // compiler from interleaving the elements (decoder_tail_fwd.cu)
  template <bool APPROX>
  __device__ __forceinline__ void unit_as(float (&acc)[NW / 2], int b, int y,
                                          int x0, bool valid, int wg,
                                          int n0) {
    const float* B1 = prm + n0;
    const float* LNS = B1 + nt;
    const float* LNB = LNS + nt;
    const float* W2T = LNB + nt;
    const int row0 = warp * 16 + g;
    float rstd[2];
    layer_norm<NW>(acc, B1, C, C - n0 - 2 * tq, split, xch, buf, wg, row0,
                   tq, rstd);
    float o[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
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
          const float n = acc[4 * j + 2 * h + e] * (e ? sc.y : sc.x)
              + (e ? sh.y : sh.x);
          const float gr = round_as(gelu<APPROX, EXACT>(n), out);
          o[h][0] += gr * (e ? wa.y : wa.x);
          o[h][1] += gr * (e ? wb.y : wb.x);
          o[h][2] += gr * (e ? wc.y : wc.x);
        }
    }
    quad_sums(o);
    if (split) exchange(o, xch, buf, wg, row0, tq);
    if ((split && wg) || !valid || tq == 3) return;
    const float b2 = prm[6 * nt + tq];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + row0 + 8 * h;
      if (x < W)
        out[(((size_t)b * H + y) * W + x) * 3 + tq] = from_f<T>(
            (tq == 0 ? o[h][0] : tq == 1 ? o[h][1] : o[h][2]) + b2);
    }
  }

  __device__ __forceinline__ void finish() {}
};

// (C > Ty<T>::ROW_C) the LayerNorm, GELU and 3 output dots of each
// pixel's row of u, one warp a pixel: the plain version's two-pass
// statistics over the real C, each a warp sum in a fixed order
template <bool APPROX, class T>
__global__ void __launch_bounds__(ROW_WARPS * 32)
row_fwd_kernel(const float* __restrict__ u, const T* __restrict__ pk,
               T* __restrict__ out, int npix, int C, int CD) {
  constexpr int PARTS = Ty<T>::PARTS;
  const int lane = threadIdx.x & 31;
  const T* lns = pk + off_lns(CD, PARTS);
  const T* lnb = pk + off_lnb(CD, PARTS);
  const T* w2 = pk + off_w2(CD, PARTS);
  for (int p = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5); p < npix;
       p += gridDim.x * ROW_WARPS) {
    const float* row = u + (size_t)p * CD;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mean = warp_sum(s) / C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / C + LN_EPS);
    float o[3] = {0.f, 0.f, 0.f};
    for (int c = lane; c < C; c += 32) {
      const float n = (row[c] - mean) * rstd * to_f(lns[c]) + to_f(lnb[c]);
      const float gr = round_as(gelu<APPROX, PARTS == 2>(n), pk);
#pragma unroll
      for (int k = 0; k < 3; ++k) o[k] += gr * to_f(w2[3 * c + k]);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) o[k] = warp_sum(o[k]);
    if (lane < 3)
      out[(size_t)p * 3 + lane] = from_f<T>(
          (lane == 0 ? o[0] : lane == 1 ? o[1] : o[2])
          + to_f(pk[off_b2(CD, PARTS) + lane]));
  }
}

template <class T>
int pack(const void* w1, const void* b1, const void* lns, const void* lnb,
         const void* w2, const void* b2, void* out, int C, int CD,
         cudaStream_t st) {
  if (C < 1 || CD < C || CD % 8) return (int)cudaErrorInvalidValue;
  const size_t n = packed_size(CD, Ty<T>::PARTS);
  const int blocks =
      (int)std::min<size_t>((n + 255) / 256, (size_t)4 * sm_count());
  pack_kernel<T><<<blocks, 256, 0, st>>>(
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(lns), static_cast<const float*>(lnb),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<T*>(out), C, CD);
  return (int)cudaGetLastError();
}

template <class T>
int fwd(const void* pix, const void* packed, void* u, void* out, int B,
        int H, int W, int C, int CD, int approx, cudaStream_t st) {
  if (C < 1 || CD < C || CD % 8 || (C > Ty<T>::ROW_C && u == nullptr))
    return (int)cudaErrorInvalidValue;
  const int split = split_for<T>(B, H, W, C);
  const int nw = width_for<T>(C, split);
  CUtensorMap m_pix, m_w1;
  if (!map_pixels<T>(&m_pix, pix, B, H, W, CD) ||
      !map_w1<T>(&m_w1, packed, CD, nw))
    return (int)cudaErrorInvalidValue;
  const T* pk = static_cast<const T*>(packed);
  if (C > Ty<T>::ROW_C) {
    constexpr int NWM = Ty<T>::NW_MAX;
    const Geo geo = plan<T>(B, H, W, C, CD, split, NWM, 0, 0);
    const typename UEpi<NWM, T>::Params p = {pk, static_cast<float*>(u)};
    const int err = launch_conv<UEpi<NWM, T>>(m_pix, m_w1, p, geo, st);
    if (err) return err;
    const int npix = B * H * W;
    const int grid = std::min(4 * sm_count(),
                              (npix + ROW_WARPS - 1) / ROW_WARPS);
    if (approx)
      row_fwd_kernel<true, T><<<grid, ROW_WARPS * 32, 0, st>>>(
          static_cast<const float*>(u), pk, static_cast<T*>(out), npix, C,
          CD);
    else
      row_fwd_kernel<false, T><<<grid, ROW_WARPS * 32, 0, st>>>(
          static_cast<const float*>(u), pk, static_cast<T*>(out), npix, C,
          CD);
    return (int)cudaGetLastError();
  }
  return with_nw<T>(nw, [&](auto n) {
    constexpr int NW = decltype(n)::value;
    typedef FwdEpi<NW, T> E;
    const Geo geo = plan<T>(B, H, W, C, CD, split, NW, 0,
                            E::prm_bytes(split ? 2 * NW : NW));
    const typename E::Params p = {pk, static_cast<T*>(out), approx};
    return launch_conv<E>(m_pix, m_w1, p, geo, st);
  });
}

}  // namespace tc

extern "C" {

// W1 (C, C, 3, 3), b1, LN scale, LN bias (C,), W2 (3, C, 1, 1), b2 (3,)
// (or null) fp32 -> packed: packed_size(CD) bf16 (decoder_tail_tc.cuh)
int decoder_tail_tc_pack(const void* w1, const void* b1, const void* lns,
                         const void* lnb, const void* w2, const void* b2,
                         void* packed, int C, int CD, void* stream) {
  return tc::pack<tc::bf16>(w1, b1, lns, lnb, w2, b2, packed, C, CD,
                            static_cast<cudaStream_t>(stream));
}

// the same into packed_size(CD, 2) fp32, W1 split into tf32 parts
int decoder_tail_tc_pack_f32(const void* w1, const void* b1, const void* lns,
                             const void* lnb, const void* w2, const void* b2,
                             void* packed, int C, int CD, void* stream) {
  return tc::pack<float>(w1, b1, lns, lnb, w2, b2, packed, C, CD,
                         static_cast<cudaStream_t>(stream));
}

// bf16 pix (B, H, W, CD), packed -> out (B, H, W, 3) bf16; u: an fp32
// (B, H, W, CD) scratch past 512 channels, else null
int decoder_tail_tc_fwd(const void* pix, const void* packed, void* u,
                        void* out, int B, int H, int W, int C, int CD,
                        int approx, void* stream) {
  return tc::fwd<tc::bf16>(pix, packed, u, out, B, H, W, C, CD, approx,
                           static_cast<cudaStream_t>(stream));
}

// the same in fp32 (packed by decoder_tail_tc_pack_f32); u past 256
// channels
int decoder_tail_tc_fwd_f32(const void* pix, const void* packed, void* u,
                            void* out, int B, int H, int W, int C, int CD,
                            int approx, void* stream) {
  return tc::fwd<float>(pix, packed, u, out, B, H, W, C, CD, approx,
                        static_cast<cudaStream_t>(stream));
}

// the packed buffer's length in bf16 values
long long decoder_tail_tc_packed_size(int CD) {
  return (long long)tc::packed_size(CD);
}

const char* decoder_tail_tc_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
