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
// tiling and is not reproduced. H and W may be any size.
//
// What bounds it on this card: the 32-channel bf16 write. At B=16, 640x640
// that is 419 MB written against 20 MB of uint8 read and 11.7 GFLOP, about
// 0.13 ms of HBM time at 3.35 TB/s. Everything else has to hide under that
// write, so the arithmetic is on the units that do it for nothing: the tap
// product on the tensor cores (mma.sync), the SiLU on the special-function
// unit, and the accumulator layout chosen so that every thread stores 16
// contiguous bytes straight from its registers (stem_l1_tile.cuh has the
// details; the fused stem shares that code and its bits). A block of four
// warps stages the bf16 window of its 16 x 64 tile with a one-pixel zero halo
// (the conv's padding, applied to the input only) and holds K1[b] as B
// fragments in registers; warp w owns the tile's columns 16w .. 16w+15 and
// walks its 16 rows, one m16 fragment each. Many small blocks rather than one
// persistent block per SM: six are resident per SM, so while one stages its
// window the others' stores keep device memory busy. The channel sums are
// taken from the packed bf16 values, reduced over the warp's pixels by
// shuffles and over the block's warps in a fixed order, and written as one
// partial row per block (no atomics); the wrapper adds the partials with
// torch.sum, so two launches give the same bits.
//
// On an NVIDIA H100 80GB HBM3 at 700 W, (16, 640, 640, 3) uint8: 0.19 ms (the
// first version 0.77), where the same stores with no arithmetic take 0.17 and
// a memset of the output 0.13. Dropping the SiLU gains 0.011 ms, dropping the
// sums 0.008; tiles of 8 or 32 rows or 32 or 128 columns, 4 or 8 blocks per SM,
// streaming stores and a one-MUFU SiLU by tanh.approx all came out within 5 %,
// so the simple grid stayed and no persistent one was written.
#include "stem_l1_tile.cuh"

namespace {

using namespace uavdet;
using namespace uavdet::l1;

constexpr int C_IN = 3;
constexpr int TW = 64;                  // output tile: TW columns ...
constexpr int TH = 16;                  // ... by TH rows per block
constexpr int WARPS = TW / 16;          // one m16 column block per warp
constexpr int THREADS = 32 * WARPS;
constexpr int PITCH = TW + 2;           // staged pixels per window row
constexpr int WIN = (TH + 2) * PITCH;

// the 8 stored bf16 values of a pixel, added to the lane's channel sums
__device__ __forceinline__ void add_stored(float (&sum)[8], const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sum[2 * j] += __uint_as_float(w[j] << 16);
    sum[2 * j + 1] += __uint_as_float(w[j] & 0xffff0000u);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 6)
stem_l1_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ k1,
               __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int H, int W) {
  __shared__ uint2 s_x[WIN];            // the window: (r, g | b, 1.0) bf16 per pixel
  __shared__ float s_red[WARPS][C_OUT];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const T* xb = x + static_cast<size_t>(b) * H * W * C_IN;
  for (int i = tid; i < WIN; i += THREADS) {
    const int gy = y0 + i / PITCH - 1;
    const int gx = x0 + i % PITCH - 1;
    s_x[i] = gy >= 0 && gy < H && gx >= 0 && gx < W
                 ? stage_pixel(xb + (static_cast<size_t>(gy) * W + gx) * C_IN)
                 : pad_pixel();
  }
  uint32_t bf[KSTEPS][4][2];
  load_k1(k1 + static_cast<size_t>(b) * C_OUT * K1W, lane, bf);
  __syncthreads();

  float sum[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const int gx = x0 + 16 * warp + g;    // the lane's pixel g; pixel g + 8 is 8 further
  if (x0 + 16 * warp < W) {
    const uint2* p = s_x + 16 * warp + g + tap_lane(lane);
    const int rows = min(TH, H - y0);
    for (int ty = 0; ty < rows; ++ty, p += PITCH) {
      float acc[4][4];
      tile_mma(p, p + 8, PITCH, bf, acc);
      uint4 lo, hi;
      activate(acc, lo, hi);
      // pixels past the image are not stored or summed
      __nv_bfloat16* dst =
          out + ((static_cast<size_t>(b) * H + y0 + ty) * W + gx) * C_OUT + 8 * t;
      if (gx < W) {
        *reinterpret_cast<uint4*>(dst) = lo;
        add_stored(sum, lo);
      }
      if (gx + 8 < W) {
        *reinterpret_cast<uint4*>(dst + 8 * C_OUT) = hi;
        add_stored(sum, hi);
      }
    }
  }

  // lanes of equal t hold the same 8 channels: add over g, then over the warps
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float v = sum[c];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (g == 0) s_red[warp][8 * t + c] = v;
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
  if (B < 1 || B > 65535 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
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
