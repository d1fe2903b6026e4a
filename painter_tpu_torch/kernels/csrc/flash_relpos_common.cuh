// Building blocks of the attention kernels (flash_relpos_fwd.cu,
// flash_relpos_bwd.cu): shared-memory copies and TMA tensor maps of
// (64, L, BH) bf16 tensors, over the generic Hopper pieces of hopper.cuh.
#pragma once

#include "hopper.cuh"

namespace relpos {

using namespace hopper;

// 16 bytes global -> shared; with valid == false the 16 bytes are zeroed
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies the elements [src, src + n) into shared memory at dst (16-byte
// aligned, room for n + 16 / sizeof(T) elements): 16-byte cp.async over the
// enclosing 16-byte-aligned window -- the bytes before src belong to the
// same tensor, whose base is 16-byte aligned -- and plain loads for the
// elements past the window's last whole 16 bytes, so nothing past src + n
// is read. Returns the offset of src's first element in dst. Every thread
// of the block calls it with the same arguments; the caller commits, waits
// and synchronizes.
template <typename T>
__device__ __forceinline__ int copy_block(T* dst, const T* src, int n,
                                          int tid, int nthreads) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a = p & ~uintptr_t(15);
  const uintptr_t end = p + sizeof(T) * (uintptr_t)n;
  const uintptr_t end16 = end & ~uintptr_t(15);
  const int chunks = end16 > a ? (int)((end16 - a) >> 4) : 0;
  const uint32_t d = smem_u32(dst);
  for (int i = tid; i < chunks; i += nthreads)
    cp_async16(d + 16 * i, reinterpret_cast<const void*>(a + 16 * i), true);
  const uintptr_t t0 = end16 > a ? end16 : a;
  const int off = (int)((t0 - a) / sizeof(T));
  const int tail = (int)((end - t0) / sizeof(T));
  const T* ts = reinterpret_cast<const T*>(t0);
  for (int i = tid; i < tail; i += nthreads) dst[off + i] = ts[i];
  return (int)((p - a) / sizeof(T));
}

// elements of a copy_block destination for n elements, in 16-byte units
template <typename T>
__host__ __device__ constexpr int block_room(int n) {
  return (n * (int)sizeof(T) + 16 + 15) / 16 * (16 / (int)sizeof(T));
}

// box at (0, row, bh) of a 3-D (64, L, BH) tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int row, int bh, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(bh),
      "r"(bar)
      : "memory");
}

// a (64, L, BH) bf16 tensor as 3-D TMA boxes of (64, rows, 1), 128-byte
// swizzle; reads past L (the ragged last tile of a head) are zero-filled
inline bool make_map(CUtensorMap* map, const void* ptr, int bh, int L,
                     int rows) {
  const cuuint64_t dims[3] = {64, (cuuint64_t)L, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {128, (cuuint64_t)L * 128};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims,
                    strides, box);
}

}  // namespace relpos
