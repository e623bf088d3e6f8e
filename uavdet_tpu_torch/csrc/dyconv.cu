// Kernel D: the per-sample dynamic 3x3 conv of DySOEM's DynamicSOEM, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel uavdet_tpu/ops/pallas_dyconv.py: _make_kernel,
// _make_fold_kernel / pallas_dyconv. Per image b it computes
//     out[b] = bf16(SiLU(conv3x3 SAME s1(x[b], k[b]) * mul + add[b]))
// from NHWC bf16 x (B, H, W, C) and the image's own attention-mixed kernel
// k (B, 9, C, Co) bf16 (tap 3*dy + dx, then c, then co), with mul (Co,) f32
// and add (B, Co) f32 (inference BN and the mixed expert bias folded by the
// caller). Sums are f32, the affine and the SiLU are f32, the store rounds to
// bf16 once. Zero padding applies to x only. Two options of the same kernel:
// fold_out stores the values as (B, H/2, W, 2 Co), out[b, i/2, j, Co (i%2) + c]
// (index arithmetic at the store); emit_gap (partial != NULL) also writes, per
// block, the f32 sums of the stored bf16 values by (row parity, column parity,
// channel), which the wrapper adds up in a fixed order: no atomics, so the
// sums are the same in every run. H and W may be any size; C and Co must be
// multiples of 8 (16-byte loads). The TPU kernel's strip DMAs, f32 rolls and
// its C % 128, Co % 128, W % 8, H % rs rules were Mosaic's and are gone.
//
// What bounds it on this card: arithmetic. A DySOEM site at batch 32, 1280 px
// is 1.93 TFLOP against at most 5.0 GB moved (1.95 ms at 989 TFLOP/s bf16,
// 1.5 ms at 3.35 TB/s), so the work belongs on the tensor cores. Design: a
// per-sample implicit GEMM (M = pixels, N = Co, K = 9 C) on mma.sync
// m16n8k16 bf16 fragments with f32 accumulators. One block of 8 warps owns an
// 8 x 16 pixel tile and 64 output channels of one image; each warp 2 tile rows
// x 32 channels. k[b] does not fit in shared memory (2.4 MB at the last site),
// so K is walked in chunks of 32 input channels: a chunk's 10 x 18 x 32 input
// window (with its zero halo) and its 9 x 32 x 64 weights are staged once with
// cp.async (zero fill outside the image and past C or Co) and serve all nine
// taps; two stages overlap the next chunk's loads with this chunk's 144 MMAs
// per warp. Staged rows are padded (80-byte pixels, 144-byte weight rows) so
// that every ldmatrix phase touches eight distinct 16-byte bank groups. The
// epilogue goes through shared memory: the bf16 tile is written there and stored
// to device memory as 16-byte vectors; for emit_gap the same rounded values are
// summed in registers, across lanes by shuffles and across warps in shared
// memory, in one fixed order. wgmma and TMA are the next step, not this version.
#include "mma.cuh"

namespace {

using namespace uavdet;

constexpr int TH = 8;                      // tile rows (pixels)
constexpr int TW = 16;                     // tile columns: one m16 fragment per tile row
constexpr int NT = 64;                     // output channels per block
constexpr int KC = 32;                     // input channels per K chunk
constexpr int IR = TH + 2;                 // staged input rows (with halo)
constexpr int IC = TW + 2;                 // staged input columns (with halo)
constexpr int IN_STRIDE = KC + 8;          // bf16 per staged pixel (80 bytes)
constexpr int W_STRIDE = NT + 8;           // bf16 per staged weight row (144 bytes)
constexpr int OUT_STRIDE = NT + 8;         // bf16 per pixel of the output tile
constexpr int IN_ELEMS = IR * IC * IN_STRIDE;
constexpr int W_ELEMS = 9 * KC * W_STRIDE;
constexpr int STAGE_ELEMS = IN_ELEMS + W_ELEMS;
constexpr int THREADS = 256;
constexpr size_t SMEM_BYTES = sizeof(__nv_bfloat16) * 2 * STAGE_ELEMS;

static_assert(THREADS == 32 * (TH / 2) * (NT / 32), "one warp per 2 tile rows x 32 channels");
static_assert(THREADS == 4 * NT, "one thread per (row parity, column parity, channel)");
static_assert(sizeof(__nv_bfloat16) * TH * TW * OUT_STRIDE + sizeof(float) * 2 * TH * NT <= SMEM_BYTES,
              "the output tile and the parity sums reuse the stages");
static_assert((TH * TW * OUT_STRIDE * 2) % 16 == 0, "aligned parity sums");
static_assert((IN_ELEMS * 2) % 16 == 0 && (STAGE_ELEMS * 2) % 16 == 0, "16-byte aligned stages");

// Stage input channels [c0, c0 + KC) of the tile's window and of the weights of
// output channels [n0, n0 + NT). Everything outside the image, past C or past
// Co is zero.
__device__ __forceinline__ void load_stage(__nv_bfloat16* s_in, __nv_bfloat16* s_w,
                                           const __nv_bfloat16* xb, const __nv_bfloat16* kb,
                                           int H, int W, int C, int Co, int iy0, int ix0, int c0,
                                           int n0, int tid) {
  for (int i = tid; i < IR * IC * (KC / 8); i += THREADS) {
    const int q = i % (KC / 8);
    const int p = i / (KC / 8);
    const int gy = iy0 + p / IC;
    const int gx = ix0 + p % IC;
    const int c = c0 + 8 * q;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
    const __nv_bfloat16* src = ok ? xb + (static_cast<size_t>(gy) * W + gx) * C + c : xb;
    cp_async16(smem_u32(s_in + p * IN_STRIDE + 8 * q), src, ok);
  }
  for (int i = tid; i < 9 * KC * (NT / 8); i += THREADS) {
    const int q = i % (NT / 8);
    const int row = i / (NT / 8);  // tap * KC + channel within the chunk
    const int c = c0 + row % KC;
    const int n = n0 + 8 * q;
    const bool ok = c < C && n < Co;
    const __nv_bfloat16* src = ok ? kb + (static_cast<size_t>(row / KC) * C + c) * Co + n : kb;
    cp_async16(smem_u32(s_w + row * W_STRIDE + 8 * q), src, ok);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
dyconv_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ k,
              const float* __restrict__ mul, const float* __restrict__ add,
              __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int H, int W, int C,
              int Co, int tiles_x, int fold_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_mul[NT];
  __shared__ float s_add[NT];
  __nv_bfloat16* const s_base = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % (TH / 2);  // tile rows 2 wm, 2 wm + 1
  const int wn = warp / (TH / 2);  // channels [32 wn, 32 wn + 32) of the block's NT
  const int tile = blockIdx.x;
  const int n0 = blockIdx.y * NT;
  const int b = blockIdx.z;
  const int oy0 = (tile / tiles_x) * TH;
  const int ox0 = (tile % tiles_x) * TW;

  if (tid < NT) {
    const int n = n0 + tid;
    s_mul[tid] = n < Co ? mul[n] : 0.0f;
    s_add[tid] = n < Co ? add[static_cast<size_t>(b) * Co + n] : 0.0f;
  }

  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * H * W * C;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * 9 * C * Co;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // ldmatrix: lane l addresses row l % 16 of a 16-row operand, 8 elements
  // further along the row for lanes 16..31
  const int frag_row = lane % 16;
  const int frag_off = 8 * (lane / 16);
  const int a_lane = ((2 * wm) * IC + frag_row) * IN_STRIDE + frag_off;
  const int b_lane = frag_row * W_STRIDE + 32 * wn + frag_off;

  const int n_chunks = (C + KC - 1) / KC;
  load_stage(s_base, s_base + IN_ELEMS, xb, kb, H, W, C, Co, oy0 - 1, ox0 - 1, 0, n0, tid);
  cp_async_commit();

  for (int ch = 0; ch < n_chunks; ++ch) {
    __nv_bfloat16* const s_in = s_base + (ch & 1) * STAGE_ELEMS;
    __nv_bfloat16* const s_w = s_in + IN_ELEMS;
    if (ch + 1 < n_chunks) {
      __nv_bfloat16* const nxt = s_base + ((ch + 1) & 1) * STAGE_ELEMS;
      load_stage(nxt, nxt + IN_ELEMS, xb, kb, H, W, C, Co, oy0 - 1, ox0 - 1, (ch + 1) * KC, n0,
                 tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk's stage has landed for every thread

    const uint32_t a_base = smem_u32(s_in + a_lane);
    const uint32_t b_base = smem_u32(s_w + b_lane);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t a[2][4];
        uint32_t bq[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldmatrix_x4(a[i], a_base + 2 * (((i + dy) * IC + dx) * IN_STRIDE + 16 * ks));
#pragma unroll
        for (int j = 0; j < 2; ++j)
          ldmatrix_x4_trans(bq[j], b_base + 2 * ((tap * KC + 16 * ks) * W_STRIDE + 16 * j));
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[i][nt], a[i], bq[nt / 2][2 * (nt % 2)], bq[nt / 2][2 * (nt % 2) + 1]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // epilogue: affine + SiLU in f32, one rounding to bf16, into the output tile
  // [TH * TW][OUT_STRIDE] in shared memory (all stages are free by now). For
  // emit_gap the rounded values are summed on the way: a lane's two columns
  // have one parity, lanes 8 and 16 apart hold the other columns of that
  // parity, and a warp's two tile rows are the two row parities (tile origins
  // are even, so parity in the tile is parity in the image).
  __nv_bfloat16* const s_out = s_base;
  float* const s_gap = reinterpret_cast<float*>(s_out + TH * TW * OUT_STRIDE);  // [TH/2][2][2][NT]
  const bool emit_gap = partial != nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool row_in = oy0 + 2 * wm + i < H;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int cl = 32 * wn + 8 * nt + 2 * (lane % 4);
      const float m0 = s_mul[cl], m1 = s_mul[cl + 1];
      const float a0 = s_add[cl], a1 = s_add[cl + 1];
      float g0 = 0.0f, g1 = 0.0f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = lane / 4 + 8 * half;
        const float v0 = uavdet::silu(acc[i][nt][2 * half] * m0 + a0);
        const float v1 = uavdet::silu(acc[i][nt][2 * half + 1] * m1 + a1);
        const uint32_t packed = uavdet::pack_bf16x2(v0, v1);
        *reinterpret_cast<uint32_t*>(s_out + ((2 * wm + i) * TW + col) * OUT_STRIDE + cl) = packed;
        if (emit_gap && row_in && ox0 + col < W) {
          g0 += __uint_as_float(packed << 16);
          g1 += __uint_as_float(packed & 0xffff0000u);
        }
      }
      if (emit_gap) {
        g0 += __shfl_xor_sync(0xffffffffu, g0, 8);
        g1 += __shfl_xor_sync(0xffffffffu, g1, 8);
        g0 += __shfl_xor_sync(0xffffffffu, g0, 16);
        g1 += __shfl_xor_sync(0xffffffffu, g1, 16);
        if (lane < 8) {
          float* dst = s_gap + ((wm * 2 + i) * 2 + (lane / 4)) * NT + cl;
          dst[0] = g0;
          dst[1] = g1;
        }
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < TH * TW * (NT / 8); i += THREADS) {
    const int q = i % (NT / 8);
    const int pix = i / (NT / 8);
    const int oy = oy0 + pix / TW;
    const int ox = ox0 + pix % TW;
    const int n = n0 + 8 * q;
    if (oy >= H || ox >= W || n >= Co) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(s_out + pix * OUT_STRIDE + 8 * q);
    const size_t off =
        fold_out ? ((static_cast<size_t>(b) * (H / 2) + oy / 2) * W + ox) * (2 * Co) +
                       static_cast<size_t>(Co) * (oy & 1) + n
                 : ((static_cast<size_t>(b) * H + oy) * W + ox) * Co + n;
    *reinterpret_cast<uint4*>(out + off) = v;
  }

  if (emit_gap) {
    // the four row pairs of the tile, always in this order
    const int c = tid % NT;
    const int pp = tid / NT;  // 2 * row parity + column parity
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < TH / 2; ++r) sum += s_gap[(r * 4 + pp) * NT + c];
    if (n0 + c < Co)
      partial[((static_cast<size_t>(b) * gridDim.x + tile) * 4 + pp) * Co + n0 + c] = sum;
  }
}

}  // namespace

// Number of per-block partial sums per image that emit_gap writes.
UAVDET_EXPORT int uavdet_dyconv_num_partials(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// x: (B, H, W, C) bf16; k: (B, 9, C, Co) bf16; mul: (Co,) f32; add: (B, Co) f32;
// out: (B, H, W, Co) bf16, or (B, H/2, W, 2 Co) when fold_out; partial: NULL, or
// (B, num_partials, 2, 2, Co) f32.
UAVDET_EXPORT int uavdet_dyconv(const void* x, const void* k, const void* mul, const void* add,
                                void* out, void* partial, int B, int H, int W, int C, int Co,
                                int fold_out, void* stream) {
  const int tiles_x = (W + TW - 1) / TW;
  const int n_tiles = uavdet_dyconv_num_partials(H, W);
  const int co_tiles = (Co + NT - 1) / NT;
  if (B < 1 || H < 1 || W < 1 || C < 8 || Co < 8 || C % 8 || Co % 8 || B > 65535 ||
      co_tiles > 65535 || (fold_out && H % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(dyconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dyconv_kernel<<<dim3(n_tiles, co_tiles, B), THREADS, SMEM_BYTES,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(k),
      static_cast<const float*>(mul), static_cast<const float*>(add),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(partial), H, W, C, Co, tiles_x,
      fold_out);
  return static_cast<int>(cudaGetLastError());
}
