// Kernel A of the two-pass dynamic-conv stem, for Hopper (sm_90a).
//
// Replaces the TPU kernel uavdet_tpu/ops/pallas_stem_split.py:
// make_l1_kernel / pallas_l1. Per image b it computes
//     a1[b] = bf16(SiLU(conv3x3 s1 p1(x[b], K1[b]) + bias))      3 -> 32 channels
// in NHWC, plus the per-channel sums of the STORED bf16 values: the global
// average pool that kernel B's dynamic-conv attention needs, so nobody
// re-reads the activation to take it.
//
// K1 is (B, 32, 28) bf16: 27 taps ordered ki-major, then kj, then channel
// (mix_and_fold's order), and the bias as column 27. For uint8 frames the
// caller has folded /255 into the 27 tap columns before rounding to bf16; the
// bias column is not scaled. Float frames arrive already rounded to bf16.
// Accumulation and SiLU are f32, the store is bf16: what the TPU kernel does.
// The TPU kernel's quad-parity bank layout exists only for Mosaic's (8, 128)
// tiling and is not reproduced.
//
// What bounds it on this card: the 32-channel bf16 write. At B=16, 640x640
// that is 419 MB written against 20 MB of uint8 read and 11.7 GFLOP, about
// 0.13 ms of HBM time at 3.35 TB/s. Design: a block stages its input tile,
// with a one-pixel zero halo (the conv's padding, applied to the input only),
// in shared memory once. Each thread owns 4 of the 32 output channels: their
// 4 x 28 weights stay in registers for the whole tile, and per pixel it reads
// the 27 taps from shared memory (the 8 threads of one pixel read the same
// words, a broadcast) and issues 112 FMAs. The 8 threads of a pixel write its
// 64 output bytes as 8-byte stores side by side, so a warp writes 256
// contiguous bytes of NHWC. (A first version gave each thread a whole pixel;
// its 32 accumulators and 32 sums spilled at 255 registers.) The channel
// sums are reduced in a fixed order inside the block and written as one
// partial row per block (no atomics); the wrapper adds the partials with
// torch.sum, so the sums are deterministic.
#include "common.cuh"

namespace {

constexpr int C_IN = 3;
constexpr int C_OUT = 32;
constexpr int K = 28;                   // 27 taps + the bias column
constexpr int TW = 64;                  // output tile: TW columns ...
constexpr int TH = 16;                  // ... by TH rows per block
constexpr int THREADS = 128;
constexpr int CH = 4;                   // output channels per thread
constexpr int CG = C_OUT / CH;          // threads per pixel
constexpr int SLOTS = THREADS / CG;     // pixels a block works on at once
constexpr int WARPS = THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
stem_l1_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ k1,
               __nv_bfloat16* __restrict__ out, float* __restrict__ partial,
               int H, int W) {
  __shared__ float s_in[TH + 2][TW + 2][C_IN];
  __shared__ float s_red[WARPS][C_OUT];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int cg = tid % CG;              // this thread: channels CH*cg ..
  const int slot = tid / CG;

  const T* xb = x + static_cast<size_t>(b) * H * W * C_IN;
  for (int i = tid; i < (TH + 2) * (TW + 2) * C_IN; i += THREADS) {
    const int c = i % C_IN;
    const int col = (i / C_IN) % (TW + 2);
    const int row = i / (C_IN * (TW + 2));
    const int gy = y0 + row - 1;
    const int gx = x0 + col - 1;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = uavdet::to_f32(xb[(static_cast<size_t>(gy) * W + gx) * C_IN + c]);
    s_in[row][col][c] = v;
  }

  float w[CH][K];
  const __nv_bfloat16* kb = k1 + (static_cast<size_t>(b) * C_OUT + CH * cg) * K;
#pragma unroll
  for (int o = 0; o < CH; ++o)
#pragma unroll
    for (int t = 0; t < K; ++t) w[o][t] = __bfloat162float(kb[o * K + t]);
  __syncthreads();

  float sum[CH] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int p = slot; p < TH * TW; p += SLOTS) {
    const int ty = p / TW;
    const int tx = p % TW;
    const int gy = y0 + ty;
    const int gx = x0 + tx;
    if (gy >= H || gx >= W) continue;  // pixels past the image are not stored or summed
    float acc[CH] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ki = 0; ki < 3; ++ki)
#pragma unroll
      for (int kj = 0; kj < 3; ++kj)
#pragma unroll
        for (int c = 0; c < C_IN; ++c) {
          const float v = s_in[ty + ki][tx + kj][c];
          const int t = (ki * 3 + kj) * C_IN + c;
#pragma unroll
          for (int o = 0; o < CH; ++o) acc[o] = fmaf(w[o][t], v, acc[o]);
        }
    uint32_t packed[CH / 2];
#pragma unroll
    for (int o = 0; o < CH; o += 2) {
      // + the bias column, times the TPU kernel's ones row
      const uint32_t q = uavdet::pack_bf16x2(uavdet::silu(acc[o] + w[o][K - 1]),
                                             uavdet::silu(acc[o + 1] + w[o + 1][K - 1]));
      packed[o / 2] = q;
      // the sums take the stored bf16 values, which is what kernel B reads
      sum[o] += __uint_as_float(q << 16);
      sum[o + 1] += __uint_as_float(q & 0xffff0000u);
    }
    *reinterpret_cast<uint2*>(out + ((static_cast<size_t>(b) * H + gy) * W + gx) * C_OUT +
                              CH * cg) = make_uint2(packed[0], packed[1]);
  }

  // lanes l, l^8, l^16, l^24 of a warp hold the same channels
  const int lane = tid % 32;
  const int warp = tid / 32;
#pragma unroll
  for (int o = 0; o < CH; ++o) {
    float v = sum[o];
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (lane < CG) s_red[warp][CH * lane + o] = v;
  }
  __syncthreads();
  if (tid < C_OUT) {
    float v = 0.0f;
    for (int i = 0; i < WARPS; ++i) v += s_red[i][tid];
    const size_t blk = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    const size_t per_image = static_cast<size_t>(gridDim.x) * gridDim.y;
    partial[(static_cast<size_t>(b) * per_image + blk) * C_OUT + tid] = v;
  }
}

}  // namespace

// Rows of channel-sum partials the kernel writes per image (one per block).
UAVDET_EXPORT int uavdet_stem_l1_num_partials(int H, int W) {
  return ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
}

// x: (B, H, W, 3) uint8 (x_is_u8 != 0) or bf16; k1: (B, 32, 28) bf16;
// out: (B, H, W, 32) bf16; partial: (B, uavdet_stem_l1_num_partials(H, W), 32) f32.
UAVDET_EXPORT int uavdet_stem_l1(const void* x, int x_is_u8, const void* k1, void* out,
                                 void* partial, int B, int H, int W, void* stream) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* kp = static_cast<const __nv_bfloat16*>(k1);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* pp = static_cast<float*>(partial);
  if (x_is_u8)
    stem_l1_kernel<uint8_t><<<grid, THREADS, 0, s>>>(static_cast<const uint8_t*>(x), kp, op,
                                                     pp, H, W);
  else
    stem_l1_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), kp, op, pp, H, W);
  return static_cast<int>(cudaGetLastError());
}
