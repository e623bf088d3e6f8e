// Kernel E: both layers of the dynamic-conv stem in one kernel, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel uavdet_tpu/ops/pallas_stem.py: _stem_kernel /
// pallas_dyconv_stem. Per image b it computes
//     a1     = bf16(SiLU(conv3x3 s1 p1(x[b], K1[b]) + bias1))       3 -> 32 channels
//     out[b] = bf16(SiLU(conv3x3 s2 p1(a1, K2[b]) + bias2))         32 -> 64 channels
// from NHWC frames x (B, H, W, 3), uint8 or bf16, into NHWC bf16
// (B, ceil(H/2), ceil(W/2), 64); the first activation a1 never reaches device
// memory. K1 (B, 32, 28) and K2 (B, 64, 289) are bf16 with the taps ki-major,
// then kj, then channel, and the bias as the last column; for uint8 frames the
// caller has folded /255 into K1's 27 tap columns. Sums, the bias and SiLU are
// f32; a1 is rounded to bf16 before the second layer reads it, as kernel A
// stores it. The second layer's zero padding applies to a1: a pixel of a1
// outside the image is 0, rows and columns both, not SiLU(bias1). H and W may
// be any size. The TPU kernel's strips, row-pair fold, rolls and 0/1 selection
// product answer Mosaic's tiling and are not reproduced.
//
// What bounds it on this card: at B=16, 640x640 it moves 19.7 MB in and 210 MB
// out for 71.7 GFLOP (0.07 ms either way), so neither: its first layer runs on
// the CUDA cores like kernel A (K = 27 is too short for the tensor cores) and
// is bound by their f32 rate and the shared-memory loads that feed it; the
// second layer runs on the tensor cores with kernel B's device code. Design: a
// block of 512 threads keeps K2[b] (bf16, 38 KB) and K1[b] in shared memory and
// walks 16x16 output tiles of its image. Per tile it stages the 35x35x3 frame
// window as f32, computes the 33x33x32 window of a1 the tile needs into shared
// memory (8 threads per pixel, 4 channels each, the products in kernel A's
// order and kernel A's SiLU, so a1 has kernel A's bits), written in the
// column-parity layout kernel B's tile code reads (stem_l2_tile.cuh), and runs
// the second layer from there, one tile row per warp: the same MMAs in the same
// order as kernel B, so the output has kernel B's bits. 148 KB of shared memory
// and one block per SM. A tile recomputes a1's one-pixel halo: 1089 pixels for
// 1024 it owns.
#include "stem_l2_tile.cuh"

namespace {

using namespace uavdet::l2;

constexpr int THREADS = 512;
constexpr int RW = TR / (THREADS / 32);          // tile rows per warp: 1
constexpr int CG = 8;                            // threads per pixel of a1, 4 channels each
constexpr int XR = IR + 2;                       // rows of the frame window
constexpr int XC = IC + 2;                       // columns of the frame window
constexpr int C1 = 32;                           // channels of a1
constexpr int K1W = 28;                          // K1 row: 27 taps + bias
constexpr int SLOTS = THREADS / CG;              // a1 pixels the block computes at once
constexpr size_t K1_BYTES = sizeof(float) * K1W * C1;
constexpr size_t X_BYTES = sizeof(float4) * XR * XC;
constexpr size_t SMEM_BYTES = W_BYTES + K1_BYTES + X_BYTES + IN_BYTES;

static_assert(CI == C1 && C1 == 4 * CG, "8 threads of 4 channels cover a pixel of a1");
static_assert(RW * (THREADS / 32) == TR, "the warps cover the tile's rows");
static_assert((W_BYTES + K1_BYTES + X_BYTES) % 16 == 0, "the a1 window is 16-byte aligned");

template <typename T>
__global__ void __launch_bounds__(THREADS)
stem_fused_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ k1,
                  const __nv_bfloat16* __restrict__ k2, __nv_bfloat16* __restrict__ out, int H,
                  int W, int Ho, int Wo, int tiles_x, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);            // [CO][W_STRIDE]
  float* s_bias = reinterpret_cast<float*>(s_w + CO * W_STRIDE);          // [CO]
  float* s_k1 = s_bias + CO;                                              // [K1W][C1]
  float4* s_x = reinterpret_cast<float4*>(s_k1 + K1W * C1);               // [XR][XC] (r, g, b, -)
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(s_x + XR * XC);  // [IR][2][PC][IN_STRIDE]

  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  stage_k2<THREADS>(k2 + static_cast<size_t>(b) * CO * KW, s_w, s_bias, tid);
  const __nv_bfloat16* k1b = k1 + static_cast<size_t>(b) * C1 * K1W;
  for (int i = tid; i < C1 * K1W; i += THREADS)
    s_k1[(i % K1W) * C1 + i / K1W] = __bfloat162float(k1b[i]);

  const T* xb = x + static_cast<size_t>(b) * H * W * 3;
  const int cg = tid % CG;
  const int slot = tid / CG;
  const int lane = tid % 32;
  const int row0 = RW * (tid / 32);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int oy0 = (tile / tiles_x) * TR;
    const int ox0 = (tile % tiles_x) * TC;
    const int ly0 = 2 * oy0 - 1;  // a1 window origin
    const int lx0 = 2 * ox0 - 1;
    __syncthreads();  // K1 and K2 are staged, and the previous tile is done with its windows
    for (int i = tid; i < XR * XC; i += THREADS) {
      const int gy = ly0 - 1 + i / XC;
      const int gx = lx0 - 1 + i % XC;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // the first layer's zero padding
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const T* px = xb + (static_cast<size_t>(gy) * W + gx) * 3;
        v = make_float4(uavdet::to_f32(px[0]), uavdet::to_f32(px[1]), uavdet::to_f32(px[2]), 0.0f);
      }
      s_x[i] = v;
    }
    __syncthreads();

    // the first layer over the a1 window, rounded to bf16; zero outside the image
    for (int p = slot; p < IR * IC; p += SLOTS) {
      const int r = p / IC;
      const int c = p % IC;
      const int ly = ly0 + r;
      const int lx = lx0 + c;
      uint2 packed = make_uint2(0u, 0u);
      if (ly >= 0 && ly < H && lx >= 0 && lx < W) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const float4 xv = s_x[(r + tap / 3) * XC + c + tap % 3];
          const float in[3] = {xv.x, xv.y, xv.z};
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float4 w =
                *reinterpret_cast<const float4*>(s_k1 + (3 * tap + ch) * C1 + 4 * cg);
            acc[0] = fmaf(w.x, in[ch], acc[0]);
            acc[1] = fmaf(w.y, in[ch], acc[1]);
            acc[2] = fmaf(w.z, in[ch], acc[2]);
            acc[3] = fmaf(w.w, in[ch], acc[3]);
          }
        }
        const float4 bias = *reinterpret_cast<const float4*>(s_k1 + (K1W - 1) * C1 + 4 * cg);
        packed = make_uint2(
            uavdet::pack_bf16x2(uavdet::silu(acc[0] + bias.x), uavdet::silu(acc[1] + bias.y)),
            uavdet::pack_bf16x2(uavdet::silu(acc[2] + bias.z), uavdet::silu(acc[3] + bias.w)));
      }
      *reinterpret_cast<uint2*>(s_in + window_index(r, c) + 4 * cg) = packed;
    }
    __syncthreads();

    float acc[RW][CO / 8][4];
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int nt = 0; nt < CO / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.0f;
    tile_mma<RW>(s_in, s_w, row0, lane, acc);
    tile_store<RW, true>(acc, s_bias, row0, lane, out, b, Ho, Wo, oy0, ox0);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* k1, const void* k2, void* out, int B, int H, int W,
                   cudaStream_t stream) {
  const int Ho = (H + 1) / 2;
  const int Wo = (W + 1) / 2;
  const int tiles_x = (Wo + TC - 1) / TC;
  const int n_tiles = tiles_x * ((Ho + TR - 1) / TR);
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stem_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  // one block per SM across the batch, no second wave; each walks several tiles of one image
  int workers = sms / B;
  if (workers > n_tiles) workers = n_tiles;
  if (workers < 1) workers = 1;
  stem_fused_kernel<T><<<dim3(workers, B), THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(k1),
      static_cast<const __nv_bfloat16*>(k2), static_cast<__nv_bfloat16*>(out), H, W, Ho, Wo,
      tiles_x, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// x: (B, H, W, 3) uint8 (x_is_u8 != 0) or bf16; k1: (B, 32, 28) bf16; k2: (B, 64, 289) bf16;
// out: (B, ceil(H/2), ceil(W/2), 64) bf16.
UAVDET_EXPORT int uavdet_stem_fused(const void* x, int x_is_u8, const void* k1, const void* k2,
                                    void* out, int B, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(x_is_u8 ? launch<uint8_t>(x, k1, k2, out, B, H, W, s)
                                  : launch<__nv_bfloat16>(x, k1, k2, out, B, H, W, s));
}
