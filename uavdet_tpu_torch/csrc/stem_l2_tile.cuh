// The stride-2 second stem layer on one output tile, from shared memory: the
// device code that kernel B (stem_l2.cu), its stage ladder and the fused stem
// (stem_fused.cu) share.
//
//     out = bf16(SiLU(conv3x3 s2 p1(a1, K2[b]) + bias))          32 -> 64 channels
//
// A block keeps K2[b] in shared memory as f32, [tap][channel out] with the taps
// ki-major, then kj, then channel in, and the bias row behind them. Per output
// tile of TR x 16 pixels it holds the (2 TR + 1) x 33 x 32 window of the first
// activation, with its zero halo, as bf16 with 72-byte pixels (the four pixels
// a warp reads at once then fall in distinct banks). Each thread accumulates 4
// output pixels x 8 channels in registers: per input value 8 FMAs, per 4 pixels
// 8 weights as two float4 broadcasts. The block has 32 TR threads.
#pragma once

#include "common.cuh"

namespace uavdet {
namespace l2 {

constexpr int CI = 32;
constexpr int CO = 64;
constexpr int KT = 9 * CI;                       // 288 taps
constexpr int KW = KT + 1;                       // K2 row: taps + bias column
constexpr int TC = 16;                           // output tile columns
constexpr int IC = 2 * TC + 1;                   // staged input columns (with halo)
constexpr int IN_STRIDE = CI + 4;                // bf16 per staged pixel (72 bytes)
constexpr int CG = 8;                            // channel groups of 4 + 4 channels
constexpr int PX = 4;                            // output pixels per thread
constexpr size_t W_BYTES = sizeof(float) * (KT * CO + CO);

template <int TR>
struct Tile {
  static constexpr int IR = 2 * TR + 1;          // staged input rows (with halo)
  static constexpr int THREADS = CG * TR * TC / PX;
  static constexpr int ROW_STEP = TR / PX;       // rows between a thread's pixels
  static constexpr size_t IN_BYTES = sizeof(__nv_bfloat16) * IR * IC * IN_STRIDE;
  static_assert(TR % PX == 0, "a thread's 4 pixels are TR / 4 rows apart");
};

// What a thread owns: channels 4cg..4cg+3 and 32+4cg..32+4cg+3 of the tile's
// pixels (pr + ROW_STEP j, pc), j = 0..3.
struct Lane {
  int cg, pr, pc;
  __device__ __forceinline__ explicit Lane(int tid)
      : cg(tid % CG), pr(tid / CG / TC), pc(tid / CG % TC) {}
};

__device__ __forceinline__ void fma8(float* acc, float x, const float4& lo, const float4& hi) {
  acc[0] = fmaf(x, lo.x, acc[0]);
  acc[1] = fmaf(x, lo.y, acc[1]);
  acc[2] = fmaf(x, lo.z, acc[2]);
  acc[3] = fmaf(x, lo.w, acc[3]);
  acc[4] = fmaf(x, hi.x, acc[4]);
  acc[5] = fmaf(x, hi.y, acc[5]);
  acc[6] = fmaf(x, hi.z, acc[6]);
  acc[7] = fmaf(x, hi.w, acc[7]);
}

// K2[b] (64, 289) bf16 -> s_w [KT][CO] f32 and s_bias [CO] f32.
template <int THREADS>
__device__ __forceinline__ void stage_k2(const __nv_bfloat16* __restrict__ kb, float* s_w,
                                         float* s_bias, int tid) {
  for (int i = tid; i < CO * KW; i += THREADS) {
    const int o = i / KW;
    const int k = i % KW;
    const float v = __bfloat162float(kb[i]);
    if (k < KT)
      s_w[k * CO + o] = v;
    else
      s_bias[o] = v;
  }
}

// The tile's window of a1[b] (H, W, 32) from device memory, rows from iy0 and
// columns from ix0; pixels outside the image are zero.
template <int TR>
__device__ __forceinline__ void stage_window(const __nv_bfloat16* __restrict__ ab,
                                             __nv_bfloat16* s_in, int H, int W, int iy0, int ix0,
                                             int tid) {
  for (int i = tid; i < Tile<TR>::IR * IC * 4; i += Tile<TR>::THREADS) {
    const int q = i % 4;
    const int p = i / 4;
    const int gy = iy0 + p / IC;
    const int gx = ix0 + p % IC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = reinterpret_cast<const uint4*>(ab + (static_cast<size_t>(gy) * W + gx) * CI)[q];
    uint2* dst = reinterpret_cast<uint2*>(s_in + p * IN_STRIDE + q * 8);
    dst[0] = make_uint2(v.x, v.y);
    dst[1] = make_uint2(v.z, v.w);
  }
}

// acc += the nine taps of the staged window, for the thread's 4 pixels x 8 channels.
template <int TR>
__device__ __forceinline__ void tile_fma(const __nv_bfloat16* s_in, const float* s_w,
                                         const Lane& t, float (&acc)[PX][8]) {
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ki = tap / 3;
    const int kj = tap % 3;
    const __nv_bfloat16* src[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j)
      src[j] = s_in + ((2 * (t.pr + Tile<TR>::ROW_STEP * j) + ki) * IC + 2 * t.pc + kj) * IN_STRIDE;
    const float* wt = s_w + tap * CI * CO + t.cg * 4;
#pragma unroll 4
    for (int c = 0; c < CI; c += 2) {
      const float4 lo0 = *reinterpret_cast<const float4*>(wt + c * CO);
      const float4 hi0 = *reinterpret_cast<const float4*>(wt + c * CO + 32);
      const float4 lo1 = *reinterpret_cast<const float4*>(wt + (c + 1) * CO);
      const float4 hi1 = *reinterpret_cast<const float4*>(wt + (c + 1) * CO + 32);
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src[j] + c));
        fma8(acc[j], xv.x, lo0, hi0);
        fma8(acc[j], xv.y, lo1, hi1);
      }
    }
  }
}

// The thread's pixels of the tile at (oy0, ox0) into out[b] of (B, Ho, Wo, 64):
// SiLU(acc + bias) when ACTIVATE, else acc as it is; one rounding to bf16.
template <int TR, bool ACTIVATE>
__device__ __forceinline__ void tile_store(const float (&acc)[PX][8], const float* s_bias,
                                           const Lane& t, __nv_bfloat16* __restrict__ out, int b,
                                           int Ho, int Wo, int oy0, int ox0) {
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int oy = oy0 + t.pr + Tile<TR>::ROW_STEP * j;
    const int ox = ox0 + t.pc;
    if (oy >= Ho || ox >= Wo) continue;
    float v[8];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      if (ACTIVATE) {
        v[o] = silu(acc[j][o] + s_bias[4 * t.cg + o]);
        v[4 + o] = silu(acc[j][4 + o] + s_bias[32 + 4 * t.cg + o]);
      } else {
        v[o] = acc[j][o];
        v[4 + o] = acc[j][4 + o];
      }
    }
    __nv_bfloat16* dst = out + ((static_cast<size_t>(b) * Ho + oy) * Wo + ox) * CO + 4 * t.cg;
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
    *reinterpret_cast<uint2*>(dst + 32) =
        make_uint2(pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  }
}

}  // namespace l2
}  // namespace uavdet
