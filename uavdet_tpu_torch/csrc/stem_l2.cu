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
// What bounds it on this card: bytes. At B=16, 640x640 it reads 419 MB and
// writes 210 MB (0.19 ms at 3.35 TB/s) for 60.4 GFLOP (0.06 ms at 989 TFLOP/s
// bf16). A first version ran the product on the CUDA cores and took 3.1 ms on
// an NVIDIA H100 80GB HBM3 at 700 W, 2.3 of them in the tap loop. Design now:
// the product runs on the tensor cores (mma.sync m16n8k16 through
// stem_l2_tile.cuh, which the fused stem shares), and the rest is arranged so
// that device memory waits as little as it can. One block of 8 warps per SM
// keeps K2[b] in shared memory as bf16 (38 KB, loaded once) and walks 16 x 16
// output tiles of its image; each warp owns two tile rows. The 33 x 33 x 32 input windows are double-buffered: the next tile's
// window is copied with cp.async (zero fill outside the image) while this
// tile's 288 MMAs per warp and its stores run, 213 KB of shared memory in all.
// The window is split by column parity so that the stride-2 ldmatrix rows are
// free of bank conflicts. The grid is one wave: floor(resident blocks / B)
// workers per image, from the occupancy the runtime reports. What stays: the
// block's warps move through load, product, SiLU and store together, so device
// memory idles during part of each tile (0.33 ms against the 0.19 ms bound on
// an NVIDIA H100 80GB HBM3 at 700 W), and the epilogue stores 4 bytes per
// thread from the accumulator layout.
//
// The same source is also the stage ladder of this kernel (it replaces the TPU
// harness scripts/l2_ablate.py: make_kernel / run_variant): the kernel is a
// template over the stage it is cut off after, uavdet_stem_l2_stage launches
// any stage, and uavdet_stem_l2 launches the last one.
#include "stem_l2_tile.cuh"

namespace {

using namespace uavdet;
using namespace uavdet::l2;

constexpr int THREADS = 256;
constexpr int RW = TR / (THREADS / 32);          // tile rows per warp: 2
constexpr size_t SMEM_BYTES = W_BYTES + 2 * IN_BYTES;

static_assert(RW * (THREADS / 32) == TR, "the warps cover the tile's rows");

// The stage ladder over this kernel: each stage adds one step to the one
// before it and still stores every output tile, a cheap function of what the
// last step produced, so that the compiler cannot drop the step. FULL is
// kernel B.
enum Stage {
  STORE = 0,   // write the output tiles only
  K2 = 1,      // + stage K2[b] in shared memory
  WINDOW = 2,  // + each tile's input window, double-buffered with cp.async
  MMA = 3,     // + the tap loop on the tensor cores
  FULL = 4     // + bias, SiLU: kernel B
};

template <int STAGE>
__global__ void __launch_bounds__(THREADS, 1)
stem_l2_kernel(const __nv_bfloat16* __restrict__ a1, const __nv_bfloat16* __restrict__ k2,
               __nv_bfloat16* __restrict__ out, int H, int W, int Ho, int Wo, int tiles_x,
               int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const s_w = reinterpret_cast<__nv_bfloat16*>(smem);            // [CO][W_STRIDE]
  float* const s_bias = reinterpret_cast<float*>(s_w + CO * W_STRIDE);          // [CO]
  __nv_bfloat16* const s_in = reinterpret_cast<__nv_bfloat16*>(s_bias + CO);    // 2 windows

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int row0 = RW * (tid / 32);

  if (STAGE >= K2) stage_k2<THREADS>(k2 + static_cast<size_t>(b) * CO * KW, s_w, s_bias, tid);

  const __nv_bfloat16* ab = a1 + static_cast<size_t>(b) * H * W * CI;
  auto load = [&](int tile, __nv_bfloat16* dst) {
    if (STAGE >= WINDOW && tile < n_tiles)
      load_window<THREADS>(ab, dst, H, W, 2 * (tile / tiles_x) * TR - 1,
                           2 * (tile % tiles_x) * TC - 1, tid);
    cp_async_commit();
  };

  int tile = blockIdx.x;
  load(tile, s_in);
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const __nv_bfloat16* cur = s_in + (it & 1) * IN_ELEMS;
    load(tile + gridDim.x, s_in + ((it + 1) & 1) * IN_ELEMS);
    cp_async_wait<1>();
    __syncthreads();  // this tile's window (and K2) is staged for every thread

    const int oy0 = (tile / tiles_x) * TR;
    const int ox0 = (tile % tiles_x) * TC;
    float acc[RW][CO / 8][4];
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int nt = 0; nt < CO / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.0f;

    if (STAGE >= MMA) {
      tile_mma<RW>(cur, s_w, row0, lane, acc);
    } else if (STAGE == WINDOW) {
      // the centre tap's channels of each of the thread's pixels
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int nt = 0; nt < CO / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][nt][e] = __bfloat162float(
                cur[window_index(2 * (row0 + i) + 1, 2 * (lane / 4 + 8 * (e / 2)) + 1) +
                    (8 * nt + 2 * (lane % 4) + e % 2) % CI]);
    } else if (STAGE == K2) {
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int nt = 0; nt < CO / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = 8 * nt + 2 * (lane % 4) + e % 2;
            acc[i][nt][e] =
                __bfloat162float(s_w[o * W_STRIDE + (row0 + i) * TC + lane / 4 + 8 * (e / 2)]) +
                s_bias[o];
          }
    }
    tile_store<RW, STAGE == FULL>(acc, s_bias, row0, lane, out, b, Ho, Wo, oy0, ox0);
    __syncthreads();  // every warp is done with this window before it is refilled
  }
}

template <int STAGE>
cudaError_t launch(const void* a1, const void* k2, void* out, int B, int H, int W,
                   cudaStream_t stream) {
  const int Ho = (H + 1) / 2;
  const int Wo = (W + 1) / 2;
  const int tiles_x = (Wo + TC - 1) / TC;
  const int n_tiles = tiles_x * ((Ho + TR - 1) / TR);
  int dev = 0;
  int sms = 0;
  int resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stem_l2_kernel<STAGE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM_BYTES));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, stem_l2_kernel<STAGE>, THREADS,
                                                        SMEM_BYTES);
  if (err != cudaSuccess) return err;
  // one wave: as many workers per image as fit on the card at once, rounded
  // down; each walks several tiles of one image
  int workers = resident * sms / B;
  if (workers > n_tiles) workers = n_tiles;
  if (workers < 1) workers = 1;
  stem_l2_kernel<STAGE><<<dim3(workers, B), THREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(a1), static_cast<const __nv_bfloat16*>(k2),
      static_cast<__nv_bfloat16*>(out), H, W, Ho, Wo, tiles_x, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// a1: (B, H, W, 32) bf16; k2: (B, 64, 289) bf16; out: (B, ceil(H/2), ceil(W/2), 64) bf16.
UAVDET_EXPORT int uavdet_stem_l2(const void* a1, const void* k2, void* out, int B, int H, int W,
                                 void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<FULL>(a1, k2, out, B, H, W, static_cast<cudaStream_t>(stream)));
}

// Kernel B cut off after `stage` (see Stage), same operands as uavdet_stem_l2.
// Only the last stage's output is the layer's; the others time their steps.
UAVDET_EXPORT int uavdet_stem_l2_stage(const void* a1, const void* k2, void* out, int B, int H,
                                       int W, int stage, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (stage) {
    case STORE: return static_cast<int>(launch<STORE>(a1, k2, out, B, H, W, s));
    case K2: return static_cast<int>(launch<K2>(a1, k2, out, B, H, W, s));
    case WINDOW: return static_cast<int>(launch<WINDOW>(a1, k2, out, B, H, W, s));
    case MMA: return static_cast<int>(launch<MMA>(a1, k2, out, B, H, W, s));
    case FULL: return static_cast<int>(launch<FULL>(a1, k2, out, B, H, W, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
