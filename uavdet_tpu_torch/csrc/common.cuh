// Shared helpers of the port's CUDA kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// uavdet_tpu_torch/kernels.py), launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() right after its launch
// so that a refused launch (too many threads, too much shared memory) is
// reported instead of silently never running.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define UAVDET_EXPORT extern "C" __attribute__((visibility("default")))

namespace uavdet {

// SiLU in f32 on the special-function unit: v / (1 + 2^(-v log2 e)) with
// ex2.approx and rcp.approx (about two units in the last place of f32 each, and
// results below 2^-126 flushed to zero): far inside the bf16 store's half unit,
// and five instructions where expf and a true division take some thirty. Every
// kernel that applies SiLU uses this one form; a kernel's output bits depend on
// it.
__device__ __forceinline__ float silu_fast(float v) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(v * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return v * r;
}

// Two f32 values rounded to bf16 and packed little-endian (a in the low half).
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&p);
}

}  // namespace uavdet
