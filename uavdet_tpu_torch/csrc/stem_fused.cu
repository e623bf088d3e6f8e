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
// out for 71.7 GFLOP (0.07 ms either way), so neither: what it costs is the
// instruction slots, shared-memory traffic and barriers of two layers that run one
// after the other in each block. Both layers run on the tensor cores: the
// first with kernel A's tile code (stem_l1_tile.cuh: K = 48 with the bias in a
// ones slot, one 8-byte shared-memory load per pixel and tap row, SiLU on the
// special-function unit), the second with kernel B's (stem_l2_tile.cuh).
// Design: a block of 256 threads keeps K2[b] (bf16, 38 KB) in shared memory
// and K1[b] as B fragments in registers and walks output tiles of 8 rows x 16
// columns of its image. Per tile it stages the 19x35 frame window as bf16
// (r, g, b, 1.0), computes the 17x33x32 window of a1 the tile needs into
// shared memory, 16
// consecutive pixels of the flattened window per warp and step (an mma.sync
// output element's bits depend on the instruction and the K order, not on
// where in a fragment the pixel sits, so a1 has kernel A's bits), written in
// the column-parity layout kernel B's tile code reads, and runs the second
// layer from there, one tile row per warp: the same MMAs in the same order as
// kernel B, so the output has kernel B's bits. The tile is half of kernel B's
// so that two blocks fit an SM (88 KB of shared memory each): a block's phases
// (frame loads, first layer, second layer, stores) follow one another between
// barriers, and the second block's phases fill the units the first leaves
// idle. One block of 512 threads on 16x16 tiles (138 KB) took 0.63 ms where
// this takes 0.49 (NVIDIA H100 80GB HBM3, 700 W, launches back to back). A
// tile recomputes a1's one-pixel halo: 561 pixels for the 512 it owns.
#include "stem_l1_tile.cuh"
#include "stem_l2_tile.cuh"

namespace {

using namespace uavdet::l2;
namespace l1 = uavdet::l1;

constexpr int THREADS = 256;
constexpr int TRF = 8;                           // output tile rows here (kernel B's tile has 16)
constexpr int RW = TRF / (THREADS / 32);         // tile rows per warp: 1
constexpr int IRF = 2 * TRF + 1;                 // rows of the a1 window
constexpr int XR = IRF + 2;                      // rows of the frame window
constexpr int XC = IC + 2;                       // columns of the frame window
constexpr int A1_PIXELS = IRF * IC;              // pixels of the a1 window
constexpr size_t X_BYTES = (sizeof(uint2) * XR * XC + 15) / 16 * 16;
constexpr size_t A1_BYTES = sizeof(__nv_bfloat16) * IRF * 2 * PC * IN_STRIDE;
constexpr size_t SMEM_BYTES = W_BYTES + X_BYTES + A1_BYTES;

static_assert(CI == l1::C_OUT, "the first layer's channels are the second's input");
static_assert(RW * (THREADS / 32) == TRF, "the warps cover the tile's rows");
static_assert((W_BYTES + X_BYTES) % 16 == 0, "the a1 window is 16-byte aligned");

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
stem_fused_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ k1,
                  const __nv_bfloat16* __restrict__ k2, __nv_bfloat16* __restrict__ out, int H,
                  int W, int Ho, int Wo, int tiles_x, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);            // [CO][W_STRIDE]
  float* s_bias = reinterpret_cast<float*>(s_w + CO * W_STRIDE);          // [CO]
  uint2* s_x = reinterpret_cast<uint2*>(s_bias + CO);                     // [XR][XC] (r, g | b, 1)
  __nv_bfloat16* s_in =
      reinterpret_cast<__nv_bfloat16*>(smem + W_BYTES + X_BYTES);         // [IRF][2][PC][IN_STRIDE]

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = RW * warp;

  stage_k2<THREADS>(k2 + static_cast<size_t>(b) * CO * KW, s_w, s_bias, tid);
  uint32_t bf[l1::KSTEPS][4][2];
  l1::load_k1(k1 + static_cast<size_t>(b) * l1::C_OUT * l1::K1W, lane, bf);

  const T* xb = x + static_cast<size_t>(b) * H * W * 3;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int oy0 = (tile / tiles_x) * TRF;
    const int ox0 = (tile % tiles_x) * TC;
    const int ly0 = 2 * oy0 - 1;  // a1 window origin
    const int lx0 = 2 * ox0 - 1;
    __syncthreads();  // K2 is staged, and the previous tile is done with its windows
    for (int i = tid; i < XR * XC; i += THREADS) {
      const int gy = ly0 - 1 + i / XC;
      const int gx = lx0 - 1 + i % XC;
      s_x[i] = gy >= 0 && gy < H && gx >= 0 && gx < W
                   ? l1::stage_pixel(xb + (static_cast<size_t>(gy) * W + gx) * 3)
                   : l1::pad_pixel();  // the first layer's zero padding
    }
    __syncthreads();

    // the first layer over the a1 window, rounded to bf16; zero outside the image
    for (int m = warp; 16 * m < A1_PIXELS; m += THREADS / 32) {
      int r[2], c[2];
      bool in_window[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * m + lane / 4 + 8 * h;
        in_window[h] = p < A1_PIXELS;
        r[h] = in_window[h] ? p / IC : 0;
        c[h] = in_window[h] ? p % IC : 0;
      }
      float acc[4][4];
      l1::tile_mma(s_x + r[0] * XC + c[0] + l1::tap_lane(lane),
                   s_x + r[1] * XC + c[1] + l1::tap_lane(lane), XC, bf, acc);
      uint4 v[2];
      l1::activate(acc, v[0], v[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ly = ly0 + r[h];
        const int lx = lx0 + c[h];
        if (ly < 0 || ly >= H || lx < 0 || lx >= W) v[h] = make_uint4(0u, 0u, 0u, 0u);
        if (in_window[h])
          *reinterpret_cast<uint4*>(s_in + window_index(r[h], c[h]) + 8 * (lane % 4)) = v[h];
      }
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
  const int n_tiles = tiles_x * ((Ho + TRF - 1) / TRF);
  int dev = 0;
  int sms = 0;
  int resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stem_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM_BYTES));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, stem_fused_kernel<T>, THREADS,
                                                        SMEM_BYTES);
  if (err != cudaSuccess) return err;
  // one wave: as many workers per image as fit on the card at once, rounded
  // down; each walks several tiles of one image
  int workers = resident * sms / B;
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
