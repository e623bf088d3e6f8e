// The first stem layer on 16 output pixels, from shared memory, on the tensor
// cores: the device code that kernel A (stem_l1.cu) and the fused stem
// (stem_fused.cu) share, so that the two give the same bits. It replaces the
// per-strip body of the TPU kernel uavdet_tpu/ops/pallas_stem_split.py:
// make_l1_kernel, which is itself a (32, 28) @ (28, pixels) bf16 product with
// the bias as a row of ones.
//
//     a1 = bf16(SiLU(conv3x3 s1 p1(x, K1[b]) + bias))            3 -> 32 channels
//
// What bounds the layer on this card: the 64 bytes it writes per pixel (419 MB
// at batch 16, 640 px, 0.13 ms at 3.35 TB/s), once its arithmetic is off the
// f32 pipe: a first version made 27 shared-memory loads, 112 FMAs and four
// exact SiLUs per pixel and thread and took 0.83 ms (NVIDIA H100 80GB HBM3,
// 700 W), each of the three costing about as much as the write. So:
//   The product is mma.sync m16n8k16 bf16 with f32 sums: M = 16 pixels, N = 32
//     channels (four n8 tiles), K = 48 = one k16 step per kernel row ki. uint8
//     0..255 is exact in bf16 and a bf16 x bf16 product is exact in f32, so
//     only the order of the f32 sums differs from a loop over the taps.
//   The frame window is staged once as bf16, four values per pixel: r, g, b
//     and 1.0, eight bytes. Within a step, K slots 2t, 2t+1, 2t+8, 2t+9 (the
//     four a thread of an A fragment holds per row) are the four values of the
//     pixel kj = t of the tap row, so a thread's A operand is ONE aligned
//     8-byte load per pixel and step, six per 16 pixels, and no tap pair ever
//     straddles a pixel. K1[b]'s weights sit in the slots of r, g, b; the bias
//     sits in the 1.0 slot of tap (0, 0), the TPU kernel's ones row; every
//     other slot's weight is zero. Lane t = 3 of a quad has only zero weights
//     and re-reads lane 2's pixel.
//   K1[b] lives in registers as B fragments for the whole block (24 per
//     thread), read once from device memory.
//   Column 2t+e of n8 tile j is channel 8t + 2j + e (the order of B's columns
//     is free), so after the product thread t of a quad holds channels 8t ..
//     8t+7 of its two pixels: one 16-byte store each, 64 contiguous bytes per
//     quad, 512 per warp and instruction, no trip through shared memory.
//   SiLU is silu_fast, on the special-function unit (two MUFU per value).
#pragma once

#include "mma.cuh"

namespace uavdet {
namespace l1 {

constexpr int C_OUT = 32;
constexpr int K1W = 28;                          // K1 row: 27 taps + bias
constexpr int KSTEPS = 3;                        // one k16 step per kernel row
constexpr uint32_t ONE_HI = 0x3f800000u;         // bf16 (0, 1.0) packed: the ones slot

// One frame pixel as the four staged bf16 values (r, g | b, 1.0).
__device__ __forceinline__ uint2 stage_pixel(const uint8_t* px) {
  return make_uint2(pack_bf16x2(static_cast<float>(px[0]), static_cast<float>(px[1])),
                    pack_bf16x2(static_cast<float>(px[2]), 1.0f));
}
__device__ __forceinline__ uint2 stage_pixel(const __nv_bfloat16* px) {
  const uint16_t* v = reinterpret_cast<const uint16_t*>(px);
  return make_uint2(v[0] | (static_cast<uint32_t>(v[1]) << 16), v[2] | ONE_HI);
}
// A pixel outside the frame: the conv's zero padding, and the ones slot.
__device__ __forceinline__ uint2 pad_pixel() { return make_uint2(0u, ONE_HI); }

// K1[b] (32, 28) bf16 in device memory -> this lane's B fragments, bf[ki][j]
// for the n8 tile j. Lane (g, t) = (lane / 4, lane % 4) holds column g, which
// is channel 8 (g / 2) + 2 j + g % 2, and the K slots of pixel kj = t.
__device__ __forceinline__ void load_k1(const __nv_bfloat16* __restrict__ k1b, int lane,
                                        uint32_t (&bf)[KSTEPS][4][2]) {
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint16_t* row =
        reinterpret_cast<const uint16_t*>(k1b) + (8 * (g / 2) + 2 * j + g % 2) * K1W;
#pragma unroll
    for (int ki = 0; ki < KSTEPS; ++ki) {
      uint32_t b0 = 0u, b1 = 0u;
      if (t < 3) {
        const uint16_t* tap = row + (3 * ki + t) * 3;
        b0 = tap[0] | (static_cast<uint32_t>(tap[1]) << 16);
        b1 = tap[2];
        if (ki == 0 && t == 0) b1 |= static_cast<uint32_t>(row[K1W - 1]) << 16;  // the bias
      }
      bf[ki][j][0] = b0;
      bf[ki][j][1] = b1;
    }
  }
}

// The lane's offset from a pixel's top-left tap to the tap pixel it loads.
__device__ __forceinline__ int tap_lane(int lane) { return min(lane % 4, 2); }

// acc = the 27 taps + bias for 16 pixels. p_lo / p_hi: the staged window at
// the top-left tap of the lane's pixel g / g + 8 of the 16, plus tap_lane();
// pitch: staged pixels per window row. acc[j][e]: e = 0, 1 are channels
// 8t + 2j + e of pixel g, e = 2, 3 the same of pixel g + 8.
__device__ __forceinline__ void tile_mma(const uint2* p_lo, const uint2* p_hi, int pitch,
                                         const uint32_t (&bf)[KSTEPS][4][2], float (&acc)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
  for (int ki = 0; ki < KSTEPS; ++ki) {
    const uint2 lo = p_lo[ki * pitch];
    const uint2 hi = p_hi[ki * pitch];
    const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_bf16(acc[j], a, bf[ki][j][0], bf[ki][j][1]);
  }
}

// SiLU and the rounding to bf16: the lane's 8 channels (8t .. 8t+7) of pixel
// g (lo) and of pixel g + 8 (hi), as they are stored.
__device__ __forceinline__ void activate(const float (&acc)[4][4], uint4& lo, uint4& hi) {
  uint32_t v[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[0][j] = pack_bf16x2(silu_fast(acc[j][0]), silu_fast(acc[j][1]));
    v[1][j] = pack_bf16x2(silu_fast(acc[j][2]), silu_fast(acc[j][3]));
  }
  lo = make_uint4(v[0][0], v[0][1], v[0][2], v[0][3]);
  hi = make_uint4(v[1][0], v[1][1], v[1][2], v[1][3]);
}

}  // namespace l1
}  // namespace uavdet
