// Hopper's warpgroup matrix multiply (wgmma, sm_90a only) for the kernels whose
// product runs at the tensor cores' full rate (dyconv.cu, post_stem_block.cu):
// four warps start one
// asynchronous m64nNk16 bf16 product with f32 sums. A comes from registers, in
// mma.sync's m16k16 fragment layout per warp (warp w of the warpgroup holds rows
// 16 w .. 16 w + 15, loaded with ldmatrix); B is read from shared memory through
// a 64-bit matrix descriptor; the sums stay in registers, in mma.sync's m16n8
// layout per warp and 8 columns (d[4 j + e] is element e of column block j).
//
// B is N-major here (the channel-out index is contiguous, as the weights lie in
// device memory), in the 128-byte-swizzled canonical layout: a block of 64
// channels x 8 K rows is 8 rows of 128 bytes (1024 bytes, 1024-byte aligned);
// within row r the 16-byte group g lies at position g ^ (r % 8). Blocks of the
// next 8 K rows follow at the stride byte offset (SBO), blocks of the next 64
// channels at the leading byte offset (LBO).
#pragma once

#include "mma.cuh"

namespace uavdet {

// Registers written by other instructions (ldmatrix, mov) are ordered before
// the wgmma that reads them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared memory written through the generic proxy (st.shared, cp.async) becomes
// visible to the asynchronous proxy that wgmma reads descriptors' data through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// An A fragment stays allocated up to here: wgmma reads its registers while it
// runs, after the instruction that named them has retired.
__device__ __forceinline__ void keep_alive(const uint32_t (&a)[4]) {
  asm volatile("" ::"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]) : "memory");
}

// Descriptor of a 128-byte-swizzled operand at shared address `addr` (a
// multiple of 1024), with the two byte offsets above.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Descriptor of a 64-byte-swizzled N-major operand (post_stem_block.cu): a block
// of 32 channels x 8 K rows is 8 rows of 64 bytes (512 bytes, 512-byte aligned);
// within row r the 16-byte group g lies at position g ^ ((r / 2) % 4). Blocks of
// the next 8 K rows follow at `sbo`; an operand of 32 channels has no next block
// of channels, so the leading byte offset is not read.
__device__ __forceinline__ uint64_t wgmma_desc_sw64(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

// d (64 x 32, f32) += a (64 x 16 bf16, registers) * b (16 x 32 bf16, shared memory, N-major).
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t b_desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// d (64 x 64, f32) += a (64 x 16 bf16, registers) * b (16 x 64 bf16, shared memory, N-major).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t b_desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// d (64 x 128, f32) += a (64 x 16 bf16, registers) * b (16 x 128 bf16, shared memory, N-major).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t b_desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], const uint32_t (&a)[4],
                                          uint64_t b_desc) {
  static_assert(N == 64 || N == 128, "the two widths the kernels use");
  if constexpr (N == 64)
    wgmma_m64n64k16(d, a, b_desc);
  else
    wgmma_m64n128k16(d, a, b_desc);
}

}  // namespace uavdet
