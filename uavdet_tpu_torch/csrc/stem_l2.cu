// Kernel B of the two-pass dynamic-conv stem, for Hopper (sm_90a).
//
// Replaces the TPU kernel uavdet_tpu/ops/pallas_stem_split.py:
// make_l2_kernel / pallas_l2. Per image b it computes
//     out[b] = bf16(SiLU(conv3x3 s2 p1(a1[b], K2[b]) + bias))    32 -> 64 channels
// from kernel A's NHWC bf16 activation a1 (B, H, W, 32) into NHWC bf16
// (B, ceil(H/2), ceil(W/2), 64). Output row r reads input rows 2r-1, 2r and
// 2r+1; taps outside the image read 0, the conv's zero padding. K2 is
// (B, 64, 289) bf16: 288 taps ordered ki-major, then kj, then channel, and the
// bias as column 288. Accumulation and SiLU are f32, the store is bf16, as on
// the TPU. H and W may be any size (the TPU kernel's H % 16 rule is a strip
// rule of its own).
//
// What bounds it on this card: arithmetic. At B=16, 640x640 it is 60.6 GFLOP
// (1,638,400 output pixels x 64 x 289 x 2) against 210 MB read and 105 MB
// written, so on the CUDA cores (about 67 TFLOP/s FP32 on the data sheet) the
// floor is about 1 ms. This first version is a per-sample-weight implicit GEMM
// on the CUDA cores; moving it to the tensor cores is later work. Design: one
// block per (image, worker) keeps K2[b] in shared memory as f32 (74 KB, loaded
// once) and walks many 8x16 output tiles of its image. For each tile it stages
// the 17x33x32 input window (with its zero halo) in shared memory, then each
// thread accumulates 4 output pixels x 8 channels in registers: per input
// value it issues 8 FMAs, and per 4 pixels it reads 8 weights as two float4
// broadcasts. The staged pixel stride is 72 bytes so that the four pixels a
// warp reads at once fall in distinct banks. Two blocks fit on one SM.
#include "common.cuh"

namespace {

constexpr int CI = 32;
constexpr int CO = 64;
constexpr int KT = 9 * CI;                       // 288 taps
constexpr int KW = KT + 1;                       // K2 row: taps + bias column
constexpr int TR = 8;                            // output tile rows
constexpr int TC = 16;                           // output tile columns
constexpr int IR = 2 * TR + 1;                   // staged input rows (with halo)
constexpr int IC = 2 * TC + 1;                   // staged input columns (with halo)
constexpr int IN_STRIDE = CI + 4;                // bf16 per staged pixel (72 bytes)
constexpr int THREADS = 256;
constexpr int CG = 8;                            // channel groups of 4 + 4 channels
constexpr int PX = 4;                            // output pixels per thread
constexpr size_t SMEM_BYTES = sizeof(float) * (KT * CO + CO) +
                              sizeof(__nv_bfloat16) * IR * IC * IN_STRIDE;

static_assert(THREADS == CG * TR * TC / PX, "one thread per 4 pixels x 8 channels");

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

__global__ void __launch_bounds__(THREADS)
stem_l2_kernel(const __nv_bfloat16* __restrict__ a1, const __nv_bfloat16* __restrict__ k2,
               __nv_bfloat16* __restrict__ out, int H, int W, int Ho, int Wo, int tiles_x,
               int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_w = reinterpret_cast<float*>(smem);                           // [KT][CO]
  float* s_bias = s_w + KT * CO;                                          // [CO]
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(s_bias + CO);   // [IR][IC][IN_STRIDE]

  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  const __nv_bfloat16* kb = k2 + static_cast<size_t>(b) * CO * KW;
  for (int i = tid; i < CO * KW; i += THREADS) {
    const int o = i / KW;
    const int k = i % KW;
    const float v = __bfloat162float(kb[i]);
    if (k < KT)
      s_w[k * CO + o] = v;
    else
      s_bias[o] = v;
  }

  const __nv_bfloat16* ab = a1 + static_cast<size_t>(b) * H * W * CI;
  // this thread: channels 4cg..4cg+3 and 32+4cg..32+4cg+3 of the tile's
  // pixels (pr + 2j, pc), j = 0..3
  const int cg = tid % CG;
  const int pg = tid / CG;
  const int pr = pg / TC;
  const int pc = pg % TC;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int oy0 = (tile / tiles_x) * TR;
    const int ox0 = (tile % tiles_x) * TC;
    const int iy0 = 2 * oy0 - 1;
    const int ix0 = 2 * ox0 - 1;
    __syncthreads();  // K2 is staged, and the previous tile is done with s_in
    for (int i = tid; i < IR * IC * 4; i += THREADS) {
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
    __syncthreads();

    float acc[PX][8];
#pragma unroll
    for (int j = 0; j < PX; ++j)
#pragma unroll
      for (int o = 0; o < 8; ++o) acc[j][o] = 0.0f;

#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int ki = t / 3;
      const int kj = t % 3;
      const __nv_bfloat16* src[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j)
        src[j] = s_in + ((2 * (pr + 2 * j) + ki) * IC + 2 * pc + kj) * IN_STRIDE;
      const float* wt = s_w + t * CI * CO + cg * 4;
#pragma unroll 4
      for (int c = 0; c < CI; c += 2) {
        const float4 lo0 = *reinterpret_cast<const float4*>(wt + c * CO);
        const float4 hi0 = *reinterpret_cast<const float4*>(wt + c * CO + 32);
        const float4 lo1 = *reinterpret_cast<const float4*>(wt + (c + 1) * CO);
        const float4 hi1 = *reinterpret_cast<const float4*>(wt + (c + 1) * CO + 32);
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          const float2 xv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src[j] + c));
          fma8(acc[j], xv.x, lo0, hi0);
          fma8(acc[j], xv.y, lo1, hi1);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int oy = oy0 + pr + 2 * j;
      const int ox = ox0 + pc;
      if (oy >= Ho || ox >= Wo) continue;
      float v[8];
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        v[o] = uavdet::silu(acc[j][o] + s_bias[4 * cg + o]);
        v[4 + o] = uavdet::silu(acc[j][4 + o] + s_bias[32 + 4 * cg + o]);
      }
      __nv_bfloat16* dst = out + ((static_cast<size_t>(b) * Ho + oy) * Wo + ox) * CO + 4 * cg;
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(uavdet::pack_bf16x2(v[0], v[1]), uavdet::pack_bf16x2(v[2], v[3]));
      *reinterpret_cast<uint2*>(dst + 32) =
          make_uint2(uavdet::pack_bf16x2(v[4], v[5]), uavdet::pack_bf16x2(v[6], v[7]));
    }
  }
}

}  // namespace

// a1: (B, H, W, 32) bf16; k2: (B, 64, 289) bf16; out: (B, ceil(H/2), ceil(W/2), 64) bf16.
UAVDET_EXPORT int uavdet_stem_l2(const void* a1, const void* k2, void* out, int B, int H, int W,
                                 void* stream) {
  const int Ho = (H + 1) / 2;
  const int Wo = (W + 1) / 2;
  const int tiles_x = (Wo + TC - 1) / TC;
  const int n_tiles = tiles_x * ((Ho + TR - 1) / TR);
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stem_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  // two blocks per SM across the batch; each walks several tiles of one image
  int workers = (2 * sms + B - 1) / B;
  if (workers > n_tiles) workers = n_tiles;
  if (workers < 1) workers = 1;
  stem_l2_kernel<<<dim3(workers, B), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a1), static_cast<const __nv_bfloat16*>(k2),
      static_cast<__nv_bfloat16*>(out), H, W, Ho, Wo, tiles_x, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
