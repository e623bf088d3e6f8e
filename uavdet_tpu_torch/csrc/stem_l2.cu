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
// warp reads at once fall in distinct banks. Two blocks fit on one SM. The
// per-tile device code is in stem_l2_tile.cuh, which the fused stem shares.
//
// The same source is also the stage ladder of this kernel (it replaces the TPU
// harness scripts/l2_ablate.py: make_kernel / run_variant): the kernel is a
// template over the stage it is cut off after, uavdet_stem_l2_stage launches
// any stage, and uavdet_stem_l2 launches the last one.
#include "stem_l2_tile.cuh"

namespace {

using namespace uavdet::l2;

constexpr int TR = 8;                            // output tile rows
constexpr int THREADS = Tile<TR>::THREADS;       // 256
constexpr size_t SMEM_BYTES = W_BYTES + Tile<TR>::IN_BYTES;

// The stage ladder over this kernel: each stage adds one step to the one
// before it and still stores every output tile, a cheap function of what the
// last step produced, so that the compiler cannot drop the step. FULL is
// kernel B.
enum Stage {
  STORE = 0,   // write the output tiles only
  K2 = 1,      // + stage K2[b] in shared memory
  WINDOW = 2,  // + stage each tile's input window
  FMA = 3,     // + the tap loop
  FULL = 4     // + bias, SiLU: kernel B
};

template <int STAGE>
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

  if (STAGE >= K2) stage_k2<THREADS>(k2 + static_cast<size_t>(b) * CO * KW, s_w, s_bias, tid);

  const __nv_bfloat16* ab = a1 + static_cast<size_t>(b) * H * W * CI;
  const Lane t(tid);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int oy0 = (tile / tiles_x) * TR;
    const int ox0 = (tile % tiles_x) * TC;
    __syncthreads();  // K2 is staged, and the previous tile is done with s_in
    if (STAGE >= WINDOW) stage_window<TR>(ab, s_in, H, W, 2 * oy0 - 1, 2 * ox0 - 1, tid);
    __syncthreads();

    float acc[PX][8];
#pragma unroll
    for (int j = 0; j < PX; ++j)
#pragma unroll
      for (int o = 0; o < 8; ++o) acc[j][o] = 0.0f;

    if (STAGE >= FMA) {
      tile_fma<TR>(s_in, s_w, t, acc);
    } else if (STAGE == WINDOW) {
      // the centre tap's first 8 channels of each of the thread's pixels
#pragma unroll
      for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int o = 0; o < 8; ++o)
          acc[j][o] = __bfloat162float(s_in[((2 * (t.pr + Tile<TR>::ROW_STEP * j) + 1) * IC +
                                             2 * t.pc + 1) * IN_STRIDE + o]);
    } else if (STAGE == K2) {
#pragma unroll
      for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          acc[j][o] = s_w[(t.pr * TC + t.pc + j) * CO + 4 * t.cg + o];
          acc[j][4 + o] = s_bias[32 + 4 * t.cg + o];
        }
    }
    tile_store<TR, STAGE == FULL>(acc, s_bias, t, out, b, Ho, Wo, oy0, ox0);
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
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stem_l2_kernel<STAGE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  // two blocks per SM across the batch; each walks several tiles of one image
  int workers = (2 * sms + B - 1) / B;
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
  return static_cast<int>(launch<FULL>(a1, k2, out, B, H, W, static_cast<cudaStream_t>(stream)));
}

// Kernel B cut off after `stage` (see Stage), same operands as uavdet_stem_l2.
// Only the last stage's output is the layer's; the others time their steps.
UAVDET_EXPORT int uavdet_stem_l2_stage(const void* a1, const void* k2, void* out, int B, int H,
                                       int W, int stage, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case STORE: return static_cast<int>(launch<STORE>(a1, k2, out, B, H, W, s));
    case K2: return static_cast<int>(launch<K2>(a1, k2, out, B, H, W, s));
    case WINDOW: return static_cast<int>(launch<WINDOW>(a1, k2, out, B, H, W, s));
    case FMA: return static_cast<int>(launch<FMA>(a1, k2, out, B, H, W, s));
    case FULL: return static_cast<int>(launch<FULL>(a1, k2, out, B, H, W, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
