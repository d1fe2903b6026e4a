// The 3xTF32 pieces of the fp32 attention kernels (flash_relpos_fwd.cu,
// flash_relpos_bwd.cu): the split of an fp32 operand into two tf32 parts,
// the 128-byte-swizzled K-major layout of an fp32 operand in shared memory,
// the column order of the transposed copies, and the three products.
//
// Why three products. A tf32 value keeps 10 mantissa bits, so one TF32
// product of fp32 operands is off by ~2^-11 relative -- past the fp32
// tolerance of the port's checks (1e-4). x = big + small with big =
// tf32_rn(x) and small = tf32_rn(x - big) keeps ~21 bits, and
// A.B ~= A_small.B_big + A_big.B_small + A_big.B_big (the A_small.B_small
// term is below fp32's rounding), each a tensor-core product with fp32
// accumulation: fp32 accuracy at a third of the TF32 rate (495 / 3 = 165
// TFLOP/s on an H100 against 67 for fp32 FMAs).
//
// Why transposed copies. wgmma takes tf32 operands from shared memory
// K-major only (the transpose bits exist for f16 / bf16), so a product
// whose summed index is the row index of a tile in memory (P.V, dS.K,
// P^T.dO, dS^T.Q) reads a transposed copy, written by the pass that splits
// the tile. That pass also orders the summed index within each 8 as
// 0, 2, 4, 6, 1, 3, 5, 7 (perm_col): an fp32 accumulator fragment holds
// columns (2t, 2t + 1) of each 8 and the tf32 A fragment wants columns
// (t, t + 4), so with the copy's rows in that order the accumulator of one
// product is the A fragment of the next with no shuffle (frag_from_acc).
#pragma once

#include "flash_relpos_common.cuh"

namespace tf32x3 {

using namespace relpos;

// round to nearest, ties away from zero, to tf32 (the low 13 bits zero)
__device__ __forceinline__ uint32_t tf32_rn(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both tf32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rn(x);
  small = tf32_rn(x - __uint_as_float(big));
}

// Byte offset of element (row r, column k) of an fp32 operand stored
// K-major (k the summed index) for wgmma with the 128-byte swizzle: column
// blocks of 32 fp32 (one 128-byte row each) of `rows` rows, 8-row atoms of
// 1024 bytes whose 16-byte chunks are XOR-ed with the row, as TMA's
// 128-byte swizzle writes them. Every block base is 1024-byte aligned.
__host__ __device__ constexpr uint32_t sw_off(int r, int k, int rows) {
  return (uint32_t)((k >> 5) * rows * 128 + r * 128 +
                    ((((k & 31) >> 2) ^ (r & 7)) << 4) + (k & 3) * 4);
}

// bytes of one part (big or small) of a (rows x cols) K-major operand
__host__ __device__ constexpr int part_bytes(int rows, int cols) {
  return (cols + 31) / 32 * rows * 128;
}

// descriptor offset (16-byte units) of k8 step kk of such an operand
__host__ __device__ constexpr uint32_t k8_step(int kk, int rows) {
  return (uint32_t)(((kk >> 2) * rows * 128 + (kk & 3) * 32) >> 4);
}

// the stored column of summed index j in a transposed copy (see above)
__host__ __device__ constexpr int perm_col(int j) {
  return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// zero past `ok`
__device__ __forceinline__ float4 ld4(const float* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const float4*>(p))
            : make_float4(0.f, 0.f, 0.f, 0.f);
}

// four consecutive columns (16-byte aligned) of one row, split into the
// big and small copies at byte offset off
__device__ __forceinline__ void store4(unsigned char* big,
                                       unsigned char* small, uint32_t off,
                                       float4 x) {
  uint4 b, s;
  split(x.x, b.x, s.x);
  split(x.y, b.y, s.y);
  split(x.z, b.z, s.z);
  split(x.w, b.w, s.w);
  *reinterpret_cast<uint4*>(big + off) = b;
  *reinterpret_cast<uint4*>(small + off) = s;
}

// the same four values into a transposed copy of `rows` rows: rows
// r0 .. r0 + 3, summed index j (stored at perm_col(j))
__device__ __forceinline__ void store4_t(unsigned char* big,
                                         unsigned char* small, int r0, int j,
                                         int rows, float4 x) {
  const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t off = sw_off(r0 + e, perm_col(j), rows);
    uint32_t b, s;
    split(v[e], b, s);
    *reinterpret_cast<uint32_t*>(big + off) = b;
    *reinterpret_cast<uint32_t*>(small + off) = s;
  }
}

// The split A fragment of k8 step kk from an m64nN fp32 accumulator whose
// columns are a summed index stored in perm_col order by the B operand:
// (row g, col 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1) of block kk.
template <int M>
__device__ __forceinline__ void frag_from_acc(const float (&d)[M], int kk,
                                              uint32_t (&big)[4],
                                              uint32_t (&small)[4]) {
  split(d[4 * kk], big[0], small[0]);
  split(d[4 * kk + 2], big[1], small[1]);
  split(d[4 * kk + 1], big[2], small[2]);
  split(d[4 * kk + 3], big[3], small[3]);
}

// D (+)= A . B in 3xTF32 over K8 k8 steps, A from registers (the split
// fragments of each step), B = the big and small copies of a K-major
// operand of `rows` rows. Every step's small terms are issued before any
// big one: the tensor cores' fp32 accumulation truncates, so the terms
// that set the result's leading bits come last, after 2 x K8 additions of
// terms ~2^-11 of their size. acc = 0 overwrites D.
template <int N, int K8>
__device__ __forceinline__ void mma3_rs(float (&d)[N / 2],
                                        const uint32_t (&ab)[K8][4],
                                        const uint32_t (&as)[K8][4],
                                        uint64_t bb, uint64_t bs, int rows,
                                        int acc) {
#pragma unroll
  for (int kk = 0; kk < K8; ++kk)
    wgmma_tf32_rs<N>(d, as[kk][0], as[kk][1], as[kk][2], as[kk][3],
                     bb + k8_step(kk, rows), acc | kk);
#pragma unroll
  for (int kk = 0; kk < K8; ++kk)
    wgmma_tf32_rs<N>(d, ab[kk][0], ab[kk][1], ab[kk][2], ab[kk][3],
                     bs + k8_step(kk, rows), 1);
#pragma unroll
  for (int kk = 0; kk < K8; ++kk)
    wgmma_tf32_rs<N>(d, ab[kk][0], ab[kk][1], ab[kk][2], ab[kk][3],
                     bb + k8_step(kk, rows), 1);
}

// the same with A from shared memory too (its copies of `a_rows` rows)
template <int N, int K8>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], uint64_t ab,
                                        uint64_t as, int a_rows, uint64_t bb,
                                        uint64_t bs, int rows, int acc) {
#pragma unroll
  for (int kk = 0; kk < K8; ++kk)
    wgmma_tf32_ss<N>(d, as + k8_step(kk, a_rows), bb + k8_step(kk, rows),
                     acc | kk);
#pragma unroll
  for (int kk = 0; kk < K8; ++kk)
    wgmma_tf32_ss<N>(d, ab + k8_step(kk, a_rows), bs + k8_step(kk, rows), 1);
#pragma unroll
  for (int kk = 0; kk < K8; ++kk)
    wgmma_tf32_ss<N>(d, ab + k8_step(kk, a_rows), bb + k8_step(kk, rows), 1);
}

}  // namespace tf32x3
