// The stride-2 second stem layer on one output tile, from shared memory, on the
// tensor cores: the device code that kernel B (stem_l2.cu), its stage ladder
// and the fused stem (stem_fused.cu) share. It replaces the per-strip body of
// the TPU kernel uavdet_tpu/ops/pallas_stem_split.py: make_l2_kernel.
//
//     out = bf16(SiLU(conv3x3 s2 p1(a1, K2[b]) + bias))          32 -> 64 channels
//
// What bounds the layer on this card: bytes (630 MB at batch 16, 640 px, for
// 60.4 GFLOP), once the product is off the CUDA cores, where it took 2.3 of a
// first version's 3.1 ms (NVIDIA H100 80GB HBM3, 700 W). So the tile code is
// an implicit GEMM on mma.sync m16n8k16 bf16 fragments with f32 sums (M = 16
// output pixels of a row, N = 64, K = 288 = 9 taps x 2 k16 steps), and what it
// is given is laid out for it:
//   K2[b] stays as it lies in device memory, [channel out][tap] bf16 with the
//     taps ki-major, then kj, then channel in: that is mma's "col" B operand,
//     read by plain ldmatrix. Rows are 592 bytes apart (296 bf16), so the eight
//     rows of an ldmatrix phase fall in eight distinct 16-byte bank groups. The
//     bias column is kept apart as f32. 38 KB, where f32 weights took 74 KB.
//   The window of the first activation a tile of 16 x 16 output pixels reads is
//     33 x 33 pixels (zero halo). A fragment's 16 output pixels read input
//     columns two apart, and 16-byte-aligned pixels two apart collide in pairs
//     on the banks, so the window is split by column parity: [row][parity][17]
//     pixels of 80 bytes (32 channels + 16 bytes). Tap kj reads parity kj % 2 at
//     entry ox + kj / 2: consecutive entries, 80 bytes apart, no bank conflict.
// A warp owns RW rows of the tile x 16 columns x 64 channels (RW x 32 sums per
// thread) and reuses every B fragment for its RW A fragments. The epilogue adds
// the bias, applies SiLU with the fast exponential and division (silu_fast: B,
// the ladder's last stage and the fused stem share it and agree bit for bit)
// and stores each thread's channel pairs straight from the accumulator layout.
#pragma once

#include "mma.cuh"

namespace uavdet {
namespace l2 {

constexpr int CI = 32;
constexpr int CO = 64;
constexpr int KT = 9 * CI;                       // 288 taps
constexpr int KW = KT + 1;                       // K2 row: taps + bias column
constexpr int TR = 16;                           // output tile rows
constexpr int TC = 16;                           // output tile columns: one M fragment
constexpr int IR = 2 * TR + 1;                   // window rows (with halo)
constexpr int IC = 2 * TC + 1;                   // window columns (with halo)
constexpr int PC = TC + 1;                       // entries of a column-parity plane
constexpr int IN_STRIDE = CI + 8;                // bf16 per staged pixel (80 bytes)
constexpr int W_STRIDE = KT + 8;                 // bf16 per staged row of K2 (592 bytes)
constexpr int IN_ELEMS = IR * 2 * PC * IN_STRIDE;
constexpr size_t IN_BYTES = sizeof(__nv_bfloat16) * IN_ELEMS;
constexpr size_t W_BYTES = sizeof(__nv_bfloat16) * CO * W_STRIDE + sizeof(float) * CO;

static_assert(W_BYTES % 16 == 0 && IN_BYTES % 16 == 0, "16-byte aligned regions");

// Index (in bf16) of window pixel (r, c), c in [0, IC).
__device__ __forceinline__ int window_index(int r, int c) {
  return ((r * 2 + (c & 1)) * PC + (c >> 1)) * IN_STRIDE;
}

// K2[b] (64, 289) bf16 -> s_w [CO][W_STRIDE] bf16 and s_bias [CO] f32. K2's
// rows are 578 bytes apart, so they are copied value by value.
template <int THREADS>
__device__ __forceinline__ void stage_k2(const __nv_bfloat16* __restrict__ kb, __nv_bfloat16* s_w,
                                         float* s_bias, int tid) {
  for (int i = tid; i < CO * KW; i += THREADS) {
    const int o = i / KW;
    const int k = i % KW;
    const __nv_bfloat16 v = kb[i];
    if (k < KT)
      s_w[o * W_STRIDE + k] = v;
    else
      s_bias[o] = __bfloat162float(v);
  }
}

// Starts the copies of a tile's window of a1[b] (H, W, 32) from device memory,
// rows from iy0 and columns from ix0; pixels outside the image become zero.
// The caller commits and waits for the cp.async group.
template <int THREADS>
__device__ __forceinline__ void load_window(const __nv_bfloat16* __restrict__ ab,
                                            __nv_bfloat16* s_in, int H, int W, int iy0, int ix0,
                                            int tid) {
  for (int i = tid; i < IR * IC * (CI / 8); i += THREADS) {
    const int q = i % (CI / 8);
    const int p = i / (CI / 8);
    const int r = p / IC;
    const int c = p % IC;
    const int gy = iy0 + r;
    const int gx = ix0 + c;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const __nv_bfloat16* src = ok ? ab + (static_cast<size_t>(gy) * W + gx) * CI + 8 * q : ab;
    cp_async16(smem_u32(s_in + window_index(r, c) + 8 * q), src, ok);
  }
}

// acc += the nine taps of the staged window for the warp's tile rows
// [row0, row0 + RW), all 16 columns and 64 channels. acc[i][nt] is mma's
// m16n8 fragment of row row0 + i and channels [8 nt, 8 nt + 8).
template <int RW>
__device__ __forceinline__ void tile_mma(const __nv_bfloat16* s_in, const __nv_bfloat16* s_w,
                                         int row0, int lane, float (&acc)[RW][CO / 8][4]) {
  // A: lane l addresses output column l % 16 of a row, 8 channels further along
  // for lanes 16..31. B: lane l addresses channel out l % 8 + 8 (l / 16) of a
  // block of 16, 8 taps further along for lanes 8..15 and 24..31.
  const uint32_t a_base = smem_u32(s_in + window_index(2 * row0, 0) + (lane % 16) * IN_STRIDE +
                                   8 * (lane / 16));
  const uint32_t b_base =
      smem_u32(s_w + (lane % 8 + 8 * (lane / 16)) * W_STRIDE + 8 * ((lane / 8) % 2));
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int ki = tap / 3;
    const int kj = tap % 3;
#pragma unroll
    for (int ks = 0; ks < CI / 16; ++ks) {
      uint32_t a[RW][4];
      uint32_t bq[CO / 16][4];
#pragma unroll
      for (int i = 0; i < RW; ++i)
        ldmatrix_x4(a[i], a_base + 2 * (window_index(2 * i + ki, kj) + 16 * ks));
#pragma unroll
      for (int j = 0; j < CO / 16; ++j)
        ldmatrix_x4(bq[j], b_base + 2 * (16 * j * W_STRIDE + tap * CI + 16 * ks));
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int nt = 0; nt < CO / 8; ++nt)
          mma_bf16(acc[i][nt], a[i], bq[nt / 2][2 * (nt % 2)], bq[nt / 2][2 * (nt % 2) + 1]);
    }
  }
}

// The warp's rows of the tile at (oy0, ox0) into out[b] of (B, Ho, Wo, 64):
// SiLU(acc + bias) when ACTIVATE, else acc as it is; one rounding to bf16. The
// values leave straight from the accumulator layout, 4 bytes per thread and 16
// contiguous bytes per pixel and instruction. (Staging them through shared
// memory for 16-byte stores halved the time of the bare store and made the
// whole kernel a quarter slower on an H100: the stores then start only after
// the last SiLU instead of between them.)
template <int RW, bool ACTIVATE>
__device__ __forceinline__ void tile_store(const float (&acc)[RW][CO / 8][4], const float* s_bias,
                                           int row0, int lane, __nv_bfloat16* __restrict__ out,
                                           int b, int Ho, int Wo, int oy0, int ox0) {
  const int cl = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int oy = oy0 + row0 + i;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = ox0 + lane / 4 + 8 * half;
      if (oy >= Ho || ox >= Wo) continue;
      __nv_bfloat16* dst = out + ((static_cast<size_t>(b) * Ho + oy) * Wo + ox) * CO + cl;
#pragma unroll
      for (int nt = 0; nt < CO / 8; ++nt) {
        float v0 = acc[i][nt][2 * half];
        float v1 = acc[i][nt][2 * half + 1];
        if (ACTIVATE) {
          v0 = silu_fast(v0 + s_bias[8 * nt + cl]);
          v1 = silu_fast(v1 + s_bias[8 * nt + cl + 1]);
        }
        *reinterpret_cast<uint32_t*>(dst + 8 * nt) = pack_bf16x2(v0, v1);
      }
    }
  }
}

}  // namespace l2
}  // namespace uavdet
