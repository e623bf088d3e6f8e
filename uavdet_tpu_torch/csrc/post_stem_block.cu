// Kernel G: the post-stem block of the Darknet tail in one kernel, and its stage
// ladder, for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/block_ablate.py: build_kernel / run_variant
// (the fused ResidualBlock(64) + 3x3 stride-2 downsample and its cumulative
// stages). With inference BatchNorm folded into shared (not per-sample)
// weights it computes, from NHWC bf16 x (B, H, W, 64),
//     z   = bf16(leaky(conv1x1(x, w1) + b1))                      64 -> 32 channels
//     y   = bf16(leaky(conv3x3 p1(z, k2) + b2) + x)               32 -> 64, the residual
//     out = bf16(leaky(conv3x3 s2 p1(y, k3) + b3))                64 -> 128 channels
// into NHWC bf16 (B, ceil(H/2), ceil(W/2), 128); leaky(v) = max(v, 0.1 v). The
// sums, biases, leaky and the residual add are f32; z and y are rounded to bf16
// before the next conv reads them. Each conv's zero padding applies to its own
// input: z and y outside the image are 0, not leaky(bias). The weights arrive
// as [k][n] bf16 (k: tap ki-major, kj, then channel in; n: channel out) with the
// biases apart as f32; the Python wrapper makes them from the (n, k + 1)
// matrices of the TPU kernel. H and W may be any size. The TPU kernel's strip
// DMAs, rolls, row-pair fold, lane padding and 0/1 selection product answer
// Mosaic's tiling and are not reproduced.
//
// What bounds it on this card: arithmetic. At B=16, 320x320 it is 127.5 GFLOP
// against 210 MB read and 105 MB written (0.13 ms at 989 TFLOP/s bf16, 0.09 ms
// at 3.35 TB/s), so the three convs run as implicit GEMMs on mma.sync m16n8k16
// bf16 fragments with f32 accumulators, and neither z nor y reaches device
// memory. Design: one block of 8 warps owns an 8x8 output tile of one image.
// Three nested halos: the tile needs y on 17x17 pixels and z and x on 19x19.
// Every window is kept flattened with rows of 19 pixels, so a 3x3 tap is a
// constant shift of the pixel index and any 16 consecutive indices are one M
// fragment: z is 23 fragments over the 361 window pixels, y is 21 fragments
// over 17 rows of 19 (two unused columns in each row). The output conv reads y
// through per-lane ldmatrix addresses two pixels apart (its stride), one
// fragment per two output rows. w1 and k2 are staged whole; k3 (147 KB) is
// streamed tap by tap (64 x 128) through two buffers with cp.async while the
// MMAs of the tap before run. Staged pixels and weight rows are padded by 16
// bytes so that ldmatrix phases touch distinct bank groups (the stride-2 reads
// of y keep a two-way conflict). The output tile leaves through shared memory
// as 16-byte vectors. 209 KB of shared memory, one block per SM.
//
// The stage ladder: the kernel is a template over the stage it is cut off
// after; a cut-off stage stores a tile of what it produced last, so that the
// compiler cannot drop the work. FULL is the block.
#include "mma.cuh"

namespace {

using namespace uavdet;

constexpr int C0 = 64;                     // channels of x and y
constexpr int C1 = 32;                     // channels of z
constexpr int C2 = 128;                    // channels of out
constexpr int TO = 8;                      // output tile edge
constexpr int WY = 2 * TO + 1;             // edge of the y window: 17
constexpr int WX = WY + 2;                 // edge of the x and z windows, and every row stride: 19
constexpr int MT1 = (WX * WX + 15) / 16;   // M fragments of z: 23
constexpr int MT2 = (WY * WX + 15) / 16;   // M fragments of y: 21
constexpr int X_STRIDE = C0 + 8;           // bf16 per staged pixel of x (144 bytes)
constexpr int Z_STRIDE = C1 + 8;           // ... of z (80 bytes)
constexpr int Y_STRIDE = C0 + 8;           // ... of y (144 bytes)
constexpr int X_ROWS = MT1 * 16;           // 368 pixels
constexpr int Z_ROWS = 384;                // >= MT1 * 16 written, >= MT2 * 16 + 2 * WX + 2 read
constexpr int Y_ROWS = MT2 * 16;           // 336 pixels
constexpr int W1_STRIDE = C1 + 8;          // bf16 per staged row of w1 [64][32]
constexpr int K2_STRIDE = C0 + 8;          // ... of k2 [288][64]
constexpr int K3_STRIDE = C2 + 8;          // ... of one tap of k3 [64][128]
constexpr int OUT_STRIDE = C2 + 8;         // bf16 per pixel of the staged output tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

constexpr int X_ELEMS = X_ROWS * X_STRIDE;
constexpr int Z_ELEMS = Z_ROWS * Z_STRIDE;
constexpr int Y_ELEMS = Y_ROWS * Y_STRIDE;
constexpr int W1_ELEMS = C0 * W1_STRIDE;
constexpr int K2_ELEMS = 9 * C1 * K2_STRIDE;
constexpr int K3_ELEMS = C0 * K3_STRIDE;   // one tap
constexpr size_t SMEM_BYTES =
    sizeof(__nv_bfloat16) * (X_ELEMS + Z_ELEMS + Y_ELEMS + W1_ELEMS + K2_ELEMS + 2 * K3_ELEMS) +
    sizeof(float) * (C1 + C0 + C2);

static_assert(X_ROWS >= MT2 * 16 + WX + 2, "the residual reads x one row and one column in");
static_assert(Z_ROWS >= MT1 * 16 && Z_ROWS >= MT2 * 16 + 2 * WX + 2, "z rows written and read");
static_assert(TO * TO * OUT_STRIDE <= X_ELEMS, "the output tile reuses x's window");
static_assert(WARPS == (TO / 2) * (C2 / 64), "one warp per 2 output rows x 64 channels");
static_assert((X_ELEMS * 2) % 16 == 0 && (Z_ELEMS * 2) % 16 == 0 && (Y_ELEMS * 2) % 16 == 0 &&
                  (W1_ELEMS * 2) % 16 == 0 && (K2_ELEMS * 2) % 16 == 0 && (K3_ELEMS * 2) % 16 == 0,
              "16-byte aligned regions");

enum Stage {
  LOAD = 0,   // stage x's window, w1, k2 and the biases
  DOT1 = 1,   // + the 1x1 conv: z
  DOT2 = 2,   // + the 3x3 conv and the residual: y
  FULL = 3    // + k3's stream and the stride-2 conv: the block
};

__device__ __forceinline__ float leaky(float v) { return fmaxf(v, 0.1f * v); }

// rows x (8 * vecs) bf16 from device memory (row stride src_stride) into padded shared rows
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int dst_stride,
                                           const __nv_bfloat16* src, int src_stride, int rows,
                                           int vecs, int tid) {
  for (int i = tid; i < rows * vecs; i += THREADS) {
    const int q = i % vecs;
    const int r = i / vecs;
    cp_async16(smem_u32(dst + r * dst_stride + 8 * q),
               src + static_cast<size_t>(r) * src_stride + 8 * q, true);
  }
}

// A cut-off stage's store: per output pixel, 128 channels copied from `src` at
// the window pixel under it (`origin` + 2 rows and 2 columns per output pixel).
__device__ __forceinline__ void store_from_window(const __nv_bfloat16* src, int stride,
                                                  int channels, int origin,
                                                  __nv_bfloat16* __restrict__ ob, int Ho, int Wo,
                                                  int oy0, int ox0, int tid) {
  for (int i = tid; i < TO * TO * (C2 / 8); i += THREADS) {
    const int q = i % (C2 / 8);
    const int pix = i / (C2 / 8);
    const int oy = oy0 + pix / TO;
    const int ox = ox0 + pix % TO;
    if (oy >= Ho || ox >= Wo) continue;
    const int p = origin + 2 * (pix / TO) * WX + 2 * (pix % TO);
    const uint4 v = *reinterpret_cast<const uint4*>(src + p * stride + (8 * q) % channels);
    *reinterpret_cast<uint4*>(ob + (static_cast<size_t>(oy) * Wo + ox) * C2 + 8 * q) = v;
  }
}

template <int STAGE>
__global__ void __launch_bounds__(THREADS, 1)
post_stem_block_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                       const __nv_bfloat16* __restrict__ k2, const __nv_bfloat16* __restrict__ k3,
                       const float* __restrict__ b1, const float* __restrict__ b2,
                       const float* __restrict__ b3, __nv_bfloat16* __restrict__ out, int H, int W,
                       int Ho, int Wo, int tiles_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* const s_x = reinterpret_cast<__nv_bfloat16*>(smem);  // [X_ROWS][X_STRIDE]
  __nv_bfloat16* const s_z = s_x + X_ELEMS;                            // [Z_ROWS][Z_STRIDE]
  __nv_bfloat16* const s_y = s_z + Z_ELEMS;                            // [Y_ROWS][Y_STRIDE]
  __nv_bfloat16* const s_w1 = s_y + Y_ELEMS;                           // [C0][W1_STRIDE]
  __nv_bfloat16* const s_k2 = s_w1 + W1_ELEMS;                         // [9 C1][K2_STRIDE]
  __nv_bfloat16* const s_k3 = s_k2 + K2_ELEMS;                         // [2][C0][K3_STRIDE]
  float* const s_b1 = reinterpret_cast<float*>(s_k3 + 2 * K3_ELEMS);   // [C1]
  float* const s_b2 = s_b1 + C1;                                       // [C0]
  float* const s_b3 = s_b2 + C0;                                       // [C2]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int oy0 = (tile / tiles_x) * TO;
  const int ox0 = (tile % tiles_x) * TO;
  const int gy0 = 2 * oy0 - 2;  // image row and column of window pixel 0 of x and z
  const int gx0 = 2 * ox0 - 2;

  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * H * W * C0;
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * Ho * Wo * C2;

  // group 0: x's window (zero outside the image), w1, k2
  for (int i = tid; i < WX * WX * (C0 / 8); i += THREADS) {
    const int q = i % (C0 / 8);
    const int p = i / (C0 / 8);
    const int gy = gy0 + p / WX;
    const int gx = gx0 + p % WX;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const __nv_bfloat16* src = ok ? xb + (static_cast<size_t>(gy) * W + gx) * C0 + 8 * q : xb;
    cp_async16(smem_u32(s_x + p * X_STRIDE + 8 * q), src, ok);
  }
  stage_rows(s_w1, W1_STRIDE, w1, C1, C0, C1 / 8, tid);
  stage_rows(s_k2, K2_STRIDE, k2, C0, 9 * C1, C0 / 8, tid);
  cp_async_commit();
  if (STAGE == FULL) {  // groups 1 and 2: the first two taps of k3
    stage_rows(s_k3, K3_STRIDE, k3, C2, C0, C2 / 8, tid);
    cp_async_commit();
    stage_rows(s_k3 + K3_ELEMS, K3_STRIDE, k3 + static_cast<size_t>(C0) * C2, C2, C0, C2 / 8, tid);
    cp_async_commit();
  }
  // rows past the windows that fragments read but no copy or conv writes
  for (int i = tid; i < (X_ROWS - WX * WX) * (X_STRIDE / 8); i += THREADS)
    reinterpret_cast<uint4*>(s_x + WX * WX * X_STRIDE)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < (Z_ROWS - MT1 * 16) * (Z_STRIDE / 8); i += THREADS)
    reinterpret_cast<uint4*>(s_z + MT1 * 16 * Z_STRIDE)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid < C1) s_b1[tid] = b1[tid];
  if (tid < C0) s_b2[tid] = b2[tid];
  if (tid < C2) s_b3[tid] = b3[tid];
  if (STAGE == FULL)
    cp_async_wait<2>();
  else
    cp_async_wait<0>();
  __syncthreads();

  if (STAGE == LOAD) {
    store_from_window(s_x, X_STRIDE, C0, 2 * WX + 2, ob, Ho, Wo, oy0, ox0, tid);
    return;
  }

  // ldmatrix: lane l addresses row l % 16 of a 16-row operand, 8 elements
  // further along the row for lanes 16..31
  const int frag_row = lane % 16;
  const int frag_off = 8 * (lane / 16);
  // accumulator fragment: rows lane / 4 and lane / 4 + 8, columns 2 (lane % 4), + 1
  const int c_row = lane / 4;
  const int c_col = 2 * (lane % 4);

  // ---- z = leaky(w1 x + b1) on the 19 x 19 window, zero outside the image ----
  for (int mt = warp; mt < MT1; mt += WARPS) {
    float acc[C1 / 8][4];
#pragma unroll
    for (int nt = 0; nt < C1 / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    const uint32_t a_base = smem_u32(s_x + (mt * 16 + frag_row) * X_STRIDE + frag_off);
    const uint32_t b_base = smem_u32(s_w1 + frag_row * W1_STRIDE + frag_off);
#pragma unroll
    for (int ks = 0; ks < C0 / 16; ++ks) {
      uint32_t a[4];
      uint32_t bq[C1 / 16][4];
      ldmatrix_x4(a, a_base + 2 * (16 * ks));
#pragma unroll
      for (int j = 0; j < C1 / 16; ++j)
        ldmatrix_x4_trans(bq[j], b_base + 2 * (16 * ks * W1_STRIDE + 16 * j));
#pragma unroll
      for (int nt = 0; nt < C1 / 8; ++nt)
        mma_bf16(acc[nt], a, bq[nt / 2][2 * (nt % 2)], bq[nt / 2][2 * (nt % 2) + 1]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = mt * 16 + c_row + 8 * half;
      const int gy = gy0 + p / WX;
      const int gx = gx0 + p % WX;
      const bool ok = p < WX * WX && gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int nt = 0; nt < C1 / 8; ++nt) {
        const int cl = 8 * nt + c_col;
        const uint32_t packed =
            ok ? pack_bf16x2(leaky(acc[nt][2 * half] + s_b1[cl]),
                             leaky(acc[nt][2 * half + 1] + s_b1[cl + 1]))
               : 0u;
        *reinterpret_cast<uint32_t*>(s_z + p * Z_STRIDE + cl) = packed;
      }
    }
  }
  __syncthreads();

  if (STAGE == DOT1) {
    store_from_window(s_z, Z_STRIDE, C1, 2 * WX + 2, ob, Ho, Wo, oy0, ox0, tid);
    return;
  }

  // ---- y = leaky(conv3x3(z, k2) + b2) + x on 17 rows of 19, zero outside the image ----
  // y index q = r * 19 + c is image pixel (gy0 + 1 + r, gx0 + 1 + c); its tap
  // (dy, dx) is z index q + 19 dy + dx, its residual x index q + 20
  for (int mt = warp; mt < MT2; mt += WARPS) {
    float acc[C0 / 8][4];
#pragma unroll
    for (int nt = 0; nt < C0 / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    const uint32_t a_base = smem_u32(s_z + (mt * 16 + frag_row) * Z_STRIDE + frag_off);
    const uint32_t b_base = smem_u32(s_k2 + frag_row * K2_STRIDE + frag_off);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * WX + tap % 3;
#pragma unroll
      for (int ks = 0; ks < C1 / 16; ++ks) {
        uint32_t a[4];
        uint32_t bq[C0 / 16][4];
        ldmatrix_x4(a, a_base + 2 * (shift * Z_STRIDE + 16 * ks));
#pragma unroll
        for (int j = 0; j < C0 / 16; ++j)
          ldmatrix_x4_trans(bq[j], b_base + 2 * ((tap * C1 + 16 * ks) * K2_STRIDE + 16 * j));
#pragma unroll
        for (int nt = 0; nt < C0 / 8; ++nt)
          mma_bf16(acc[nt], a, bq[nt / 2][2 * (nt % 2)], bq[nt / 2][2 * (nt % 2) + 1]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = mt * 16 + c_row + 8 * half;
      const int gy = gy0 + 1 + q / WX;
      const int gx = gx0 + 1 + q % WX;
      const bool ok = q < WY * WX && q % WX < WY && gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int nt = 0; nt < C0 / 8; ++nt) {
        const int cl = 8 * nt + c_col;
        uint32_t packed = 0u;
        if (ok) {
          const float2 res = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(s_x + (q + WX + 1) * X_STRIDE + cl));
          packed = pack_bf16x2(leaky(acc[nt][2 * half] + s_b2[cl]) + res.x,
                               leaky(acc[nt][2 * half + 1] + s_b2[cl + 1]) + res.y);
        }
        *reinterpret_cast<uint32_t*>(s_y + q * Y_STRIDE + cl) = packed;
      }
    }
  }
  __syncthreads();

  if (STAGE == DOT2) {
    store_from_window(s_y, Y_STRIDE, C0, WX + 1, ob, Ho, Wo, oy0, ox0, tid);
    return;
  }

  // ---- out = leaky(conv3x3 s2(y, k3) + b3) on the 8 x 8 tile ----
  // this warp: output rows 2 wm, 2 wm + 1 and channels [64 wn, 64 wn + 64);
  // fragment row i is output pixel (2 wm + i / 8, i % 8), whose tap (dy, dx) is
  // y index (2 (2 wm + i / 8) + dy) * 19 + 2 (i % 8) + dx
  const int wm = warp % (TO / 2);
  const int wn = warp / (TO / 2);
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  const uint32_t a_base = smem_u32(
      s_y + (2 * (2 * wm + frag_row / 8) * WX + 2 * (frag_row % 8)) * Y_STRIDE + frag_off);
  const int b_lane = frag_row * K3_STRIDE + 64 * wn + frag_off;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    if (tap < 8)
      cp_async_wait<1>();  // all but the newest group: this tap has landed
    else
      cp_async_wait<0>();
    __syncthreads();
    const uint32_t b_base = smem_u32(s_k3 + (tap & 1) * K3_ELEMS + b_lane);
    const int shift = (tap / 3) * WX + tap % 3;
#pragma unroll
    for (int ks = 0; ks < C0 / 16; ++ks) {
      uint32_t a[4];
      uint32_t bq[4][4];
      ldmatrix_x4(a, a_base + 2 * (shift * Y_STRIDE + 16 * ks));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ldmatrix_x4_trans(bq[j], b_base + 2 * (16 * ks * K3_STRIDE + 16 * j));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mma_bf16(acc[nt], a, bq[nt / 2][2 * (nt % 2)], bq[nt / 2][2 * (nt % 2) + 1]);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
    if (tap + 2 < 9) {
      stage_rows(s_k3 + (tap & 1) * K3_ELEMS, K3_STRIDE,
                 k3 + static_cast<size_t>(tap + 2) * C0 * C2, C2, C0, C2 / 8, tid);
      cp_async_commit();
    }
  }

  // epilogue through shared memory (x's window is free since y was made)
  __nv_bfloat16* const s_out = s_x;  // [TO * TO][OUT_STRIDE]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pix = (2 * wm + half) * TO + c_row;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int cl = 64 * wn + 8 * nt + c_col;
      *reinterpret_cast<uint32_t*>(s_out + pix * OUT_STRIDE + cl) =
          pack_bf16x2(leaky(acc[nt][2 * half] + s_b3[cl]),
                      leaky(acc[nt][2 * half + 1] + s_b3[cl + 1]));
    }
  }
  __syncthreads();
  for (int i = tid; i < TO * TO * (C2 / 8); i += THREADS) {
    const int q = i % (C2 / 8);
    const int pix = i / (C2 / 8);
    const int oy = oy0 + pix / TO;
    const int ox = ox0 + pix % TO;
    if (oy >= Ho || ox >= Wo) continue;
    *reinterpret_cast<uint4*>(ob + (static_cast<size_t>(oy) * Wo + ox) * C2 + 8 * q) =
        *reinterpret_cast<const uint4*>(s_out + pix * OUT_STRIDE + 8 * q);
  }
}

template <int STAGE>
cudaError_t launch(const void* x, const void* w1, const void* k2, const void* k3, const void* b1,
                   const void* b2, const void* b3, void* out, int B, int H, int W,
                   cudaStream_t stream) {
  const int Ho = (H + 1) / 2;
  const int Wo = (W + 1) / 2;
  const int tiles_x = (Wo + TO - 1) / TO;
  const int n_tiles = tiles_x * ((Ho + TO - 1) / TO);
  cudaError_t err = cudaFuncSetAttribute(post_stem_block_kernel<STAGE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  post_stem_block_kernel<STAGE><<<dim3(n_tiles, B), THREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(k2), static_cast<const __nv_bfloat16*>(k3),
      static_cast<const float*>(b1), static_cast<const float*>(b2), static_cast<const float*>(b3),
      static_cast<__nv_bfloat16*>(out), H, W, Ho, Wo, tiles_x);
  return cudaGetLastError();
}

}  // namespace

// x: (B, H, W, 64) bf16; w1: (64, 32), k2: (288, 64), k3: (576, 128) bf16, [k][n];
// b1: (32,), b2: (64,), b3: (128,) f32; out: (B, ceil(H/2), ceil(W/2), 128) bf16.
// stage: where the ladder is cut off (see Stage); only the last stage's output
// is the block's.
UAVDET_EXPORT int uavdet_post_stem_block(const void* x, const void* w1, const void* k2,
                                         const void* k3, const void* b1, const void* b2,
                                         const void* b3, void* out, int B, int H, int W, int stage,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (stage) {
    case LOAD: return static_cast<int>(launch<LOAD>(x, w1, k2, k3, b1, b2, b3, out, B, H, W, s));
    case DOT1: return static_cast<int>(launch<DOT1>(x, w1, k2, k3, b1, b2, b3, out, B, H, W, s));
    case DOT2: return static_cast<int>(launch<DOT2>(x, w1, k2, k3, b1, b2, b3, out, B, H, W, s));
    case FULL: return static_cast<int>(launch<FULL>(x, w1, k2, k3, b1, b2, b3, out, B, H, W, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
