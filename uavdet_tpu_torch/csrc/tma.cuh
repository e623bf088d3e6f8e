// Hopper's Tensor Memory Accelerator, transaction barriers and thread block
// clusters, for the kernels that let the hardware copy their tiles (dyconv.cu,
// post_stem_block.cu) or that reach another block's shared memory (nms.cu,
// post_stem_block.cu).
//
// One thread asks for a box of a tensor in device memory; the copy engine
// computes the addresses, fills what lies outside the tensor with zeros, writes
// the box into shared memory (here in the 128-byte-swizzled layout wgmma reads)
// and reports the bytes to an mbarrier there. With .multicast::cluster the same
// box lands at the same shared-memory offset in every block of the cluster
// named in the mask, and each of those blocks' barriers is told: blocks that
// need the same tile fetch it from the L2 cache once.
//
// The tensor map (the box's description) is encoded on the host per launch,
// because it holds the tensor's address, and passed to the kernel as a
// __grid_constant__ argument. cuTensorMapEncodeTiled is a driver function; it
// is looked up at run time, so nothing links against the driver library.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace uavdet {

// ---- host ----

// A tiled bf16 tensor map of `rank` (3 to 5) dimensions, innermost first: the
// tensor's sizes, the byte strides of dimensions 1.., and the box. 128-byte
// swizzle (the box's innermost dimension must be 64 values), zero fill.
inline cudaError_t encode_bf16_map_sw128(CUtensorMap* map, const void* base, int rank,
                                         const cuuint64_t* dims, const cuuint64_t* strides,
                                         const cuuint32_t* box) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
             const_cast<void*>(base), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- device ----

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives and waits; what each wrote
// to shared memory before is visible to the others after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address, in the cluster's shared window, of the shared-memory location
// `addr` (of this block) in the block of rank `rank`.
__device__ __forceinline__ uint32_t cluster_map_shared(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into the cluster's shared window (distributed shared memory).
__device__ __forceinline__ void st_cluster_v4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
}

// 8 bytes from the cluster's shared window (distributed shared memory).
__device__ __forceinline__ unsigned long long ld_cluster_u64(uint32_t addr) {
  unsigned long long v;
  asm volatile("ld.shared::cluster.u64 %0, [%1];\n" : "=l"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

// Barriers just initialised become visible to the cluster and the copy engine.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of copies to come in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed. A barrier
// that never completes is a fault of the kernel: it traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 22)) __trap();
  }
}

// One arrival on the barrier at `addr` in the cluster's shared window (of this
// block or another), after this thread's earlier writes are visible to the
// cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}

// mbar_wait for a barrier that other blocks of the cluster arrive on: what
// they wrote before arriving is visible after it. Traps instead of hanging.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 22)) __trap();
  }
}

// Box at coordinates (c0, c1, c2, c3) of a 4-d tensor map into shared memory at
// `dst` of every block in `cta_mask`; each of their barriers at `bar`'s offset
// receives the bytes.
__device__ __forceinline__ void tma_load_4d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1, int c2, int c3,
                                                      uint16_t cta_mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "h"(cta_mask)
      : "memory");
}

// Box at coordinates (c0, c1, c2, c3) of a 4-d tensor map into this block's
// shared memory at `dst`; the barrier at `bar` receives the bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The box at `src` in shared memory to coordinates (c0, c1, c2, c3) of a 4-d
// tensor map; what lies outside the tensor is not written. Completion is
// tracked per thread in bulk groups (bulk_commit, bulk_wait_read).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk stores have read their shared memory (it may be rewritten).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

}  // namespace uavdet
