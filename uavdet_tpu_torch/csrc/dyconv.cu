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
// What bounds it on this card: arithmetic, and right behind it the operands'
// way into shared memory and out of it. A DySOEM site at batch 32, 1280 px is
// 1.93 TFLOP against at most 5.0 GB moved (1.95 ms at 989 TFLOP/s bf16, 1.5 ms
// at 3.35 TB/s). Only wgmma reaches the card's bf16 rate. As a per-sample
// implicit GEMM (M = pixels, N = Co, K = 9 C) a block of M pixels stages all of
// k[b]'s rows of its N channels, so the weights cross from the L2 cache once
// per M pixels: 15.1 GB a site at M = 128, 7.5 GB at M = 256, 3.8 GB when two
// blocks share one fetch, beside about 1.3 x the size of x per N tile for the
// haloed input windows. A 64-row wgmma reads its 16 x N weight tile from shared
// memory once per instruction, so the wider N is, the fewer shared-memory bytes
// a FLOP costs: at N = 64 the weights and the ldmatrix of A together ask for
// all 128 bytes per clock an SM has, at N = 128 for three quarters of them.
//
// Design: a block of two warpgroups owns a 16 x 16 pixel tile (M = 256) and
// N = 128 output channels of one image (N = 64 where Co <= 64): at N = 128 as
// many f32 sums as half the register file holds. Each warpgroup owns 8 tile
// rows as two m64 tiles (a warp's 16 rows of a tile are 16 pixels of one image
// row) and runs wgmma.mma_async m64nNk16 with
//   A from registers: ldmatrix out of the padded input window, where a tap is
//     an address shift; three fragment sets rotate so that a set is rewritten
//     only after the wgmma that read it has completed (wait_group 1);
//   B from shared memory through a matrix descriptor: the weights are N-major
//     (Co contiguous, as in device memory) in the 128-byte-swizzled canonical
//     layout, transpose bit set.
// K is walked in chunks of 16 input channels (one k16 step per tap); a chunk's
// 18 x 18 x 16 window and its 9 x 16 x N weights are one stage of a ring,
// loaded two chunks ahead:
//   the weights by TMA. k is described to the copy engine as a (Co, C, 9, B)
//     tensor (a tensor map encoded per launch, since it holds k's address); a
//     box is 64 channels out x 8 channels in x 9 taps, written swizzled, zeros
//     past C and Co. Two neighbouring tiles of an image form a thread block
//     cluster: each block asks for the boxes of 8 of the chunk's 16 channels
//     and the engine writes them into both blocks' stages (multicast) and
//     reports to both blocks' mbarriers, so the pair fetches k[b] once;
//   the window by cp.async (its pixels are 48 bytes apart so that every
//     ldmatrix phase touches eight distinct 16-byte bank groups, which a dense
//     TMA box would not give), zero fill outside the image and past C, started
//     in slices between the wgmmas of the chunk in work.
// One cluster barrier per chunk makes the windows visible and tells both blocks
// that the stage about to be refilled is free in both. At N = 128 (one block
// per SM) the ring has four stages and a stage is refilled two chunks after its
// use: one wgmma group may still be in flight across the chunk boundary, so the
// pipe does not drain there. At N = 64 (128 registers) two blocks share an SM,
// each with a ring of three whose stages are refilled as soon as the chunk's
// wgmmas are complete: one block's prologue, epilogue and chunk ends run under
// the other's products. The epilogue goes through shared memory: the bf16 tile
// is written there (SiLU on the special-function unit, silu_fast) and stored
// to device memory as 16-byte vectors; for emit_gap the same rounded values are
// summed in registers, across lanes by shuffles and across warps in shared
// memory, in one fixed order. What is left: a producer warp and a persistent
// block that stores one tile under the next one's products.
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using namespace uavdet;

constexpr int TH = 16;                     // tile rows (pixels)
constexpr int TW = 16;                     // tile columns: one m16 fragment per tile row
constexpr int KC = 16;                     // input channels per K chunk: one k16 step per tap
constexpr int IR = TH + 2;                 // staged input rows (with halo)
constexpr int IC = TW + 2;                 // staged input columns (with halo)
constexpr int IN_STRIDE = KC + 8;          // bf16 per staged pixel (48 bytes)
constexpr int IN_COPIES = IR * IC * (KC / 8);
constexpr int IN_BYTES = 16 * 1024;        // the window, rounded up to the swizzle's 1024 bytes
constexpr int ROW_BYTES = 128;             // 64 output channels of one K row
constexpr int ATOM_BYTES = 8 * ROW_BYTES;  // 8 K rows x 64 channels: the swizzle's unit
constexpr int HALF_BYTES = 9 * ATOM_BYTES;  // one TMA box: 9 taps x 8 channels in x 64 out
constexpr int BLOCK_BYTES = 2 * HALF_BYTES;  // a chunk's weights of one 64-channel block
constexpr int CLUSTER = 2;                 // blocks that share one fetch of the weights
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MT = TH * TW / 64 / (THREADS / 128);  // m64 tiles per warpgroup: 2
constexpr int IN_SLICES = (IN_COPIES + THREADS - 1) / THREADS;

static_assert(IR * IC * IN_STRIDE * 2 <= IN_BYTES, "the window fits its region");
static_assert(IN_SLICES <= 9, "a window's copies start within a chunk's nine steps");
static_assert(CLUSTER * 8 == KC, "each block of a cluster fetches 8 of a chunk's channels");

template <int NT>
struct Cfg {
  static constexpr int NB = NT / 64;                       // 64-channel blocks of the N tile
  static constexpr int W_BYTES = NB * BLOCK_BYTES;
  static constexpr int STAGE_BYTES = IN_BYTES + W_BYTES;
  // N = 128: one block per SM, a ring of four stages, and one wgmma group stays
  // in flight across a chunk's end, so a stage is refilled two chunks after its
  // use. N = 64 (half the sums): two blocks per SM, a ring of three; a chunk
  // ends with its wgmmas complete, its stage is refilled at once, and the other
  // block's work covers the gap.
  static constexpr bool DRAIN = NT == 64;
  static constexpr int MIN_BLOCKS = DRAIN ? 2 : 1;
  static constexpr int STAGES = DRAIN ? 3 : 4;
  static constexpr int AHEAD = DRAIN ? STAGES - 1 : STAGES - 2;  // chunks loaded ahead
  static constexpr int OUT_STRIDE = NT + 8;                // bf16 per pixel of the output tile
  static constexpr int OUT_BYTES = TH * TW * OUT_STRIDE * 2;
  static constexpr int GAP_BYTES = WARPS * 2 * NT * 4;
  // stages, mul and add, the stages' barriers, and room to align the stages to
  // 1024 bytes
  static constexpr size_t SMEM_BYTES = STAGES * STAGE_BYTES + 2 * NT * 4 + 8 * STAGES + 1024;
  static_assert(STAGE_BYTES % 1024 == 0, "every stage's weights are 1024-byte aligned");
  static_assert(OUT_BYTES + GAP_BYTES <= STAGES * STAGE_BYTES,
                "the output tile and the parity sums reuse the stages");
  static_assert(OUT_BYTES % 16 == 0, "aligned parity sums");
};

// One slice of the copies of a chunk's input window: channels [c0, c0 + KC) of
// the 18 x 18 pixels from (iy0, ix0). Outside the image and past C it is zero.
__device__ __forceinline__ void load_window_slice(uint32_t s_in, const __nv_bfloat16* xb, int H,
                                                  int W, int C, int iy0, int ix0, int c0, int slice,
                                                  int tid) {
  const int i = tid + THREADS * slice;
  if (i >= IN_COPIES) return;
  const int q = i % (KC / 8);
  const int p = i / (KC / 8);
  const int gy = iy0 + p / IC;
  const int gx = ix0 + p % IC;
  const int c = c0 + 8 * q;
  const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
  const __nv_bfloat16* src = ok ? xb + (static_cast<size_t>(gy) * W + gx) * C + c : xb;
  cp_async16(s_in + 2 * (p * IN_STRIDE + 8 * q), src, ok);
}

// A chunk's weights, k[b, :, c0 .. c0 + KC, n0 .. n0 + NT), fetched once for the
// cluster: block `rank` asks for the boxes of channels in [c0 + 8 rank, c0 + 8
// rank + 8) (9 taps x 8 x 64, one box per 64 channels out), and the copy engine
// writes each into both blocks' stages and tells both blocks' barriers. In a
// stage a 64-channel block is [half][tap][8 rows of 128 bytes], swizzled: the
// two 8-row groups of a tap's k16 step lie HALF_BYTES apart. Past C or Co the
// engine fills zeros.
template <int NT>
__device__ __forceinline__ void load_weights(uint32_t s_w, uint32_t bar, const CUtensorMap* k_map,
                                             int b, int c0, int n0, uint32_t rank) {
#pragma unroll
  for (int nb = 0; nb < Cfg<NT>::NB; ++nb)
    tma_load_4d_multicast(s_w + nb * BLOCK_BYTES + rank * HALF_BYTES, k_map, bar, n0 + 64 * nb,
                          c0 + 8 * static_cast<int>(rank), 0, b, (1u << CLUSTER) - 1);
}

template <int NT>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, Cfg<NT>::MIN_BLOCKS)
dyconv_kernel(const __grid_constant__ CUtensorMap k_map, const __nv_bfloat16* __restrict__ x,
              const float* __restrict__ mul, const float* __restrict__ add,
              __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int H, int W, int C,
              int Co, int tiles_x, int fold_out) {
  using cfg = Cfg<NT>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: stages start at multiples of 1024
  unsigned char* const smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* const s_mul = reinterpret_cast<float*>(smem + cfg::STAGES * cfg::STAGE_BYTES);  // [NT]
  float* const s_add = s_mul + NT;                                                 // [NT]
  const uint32_t s_base = smem_u32(smem);
  const uint32_t s_full = smem_u32(s_add + NT);  // [STAGES] barriers: a stage's weights are in
  const uint32_t rank = cluster_ctarank();

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wq = warp % 4;   // the warp's 16 rows of its warpgroup's m64 tiles
  const int wg = warp / 4;   // warpgroup: tile rows [8 wg, 8 wg + 8)
  const int tile = blockIdx.x;  // a cluster is two neighbouring tiles of one image
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

  float acc[MT][NT / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) acc[i][j] = 0.0f;

  const int n_chunks = (C + KC - 1) / KC;

  // the copies of chunk `ch` that belong to step `step` of the chunk in work:
  // the weights at once (one thread asks), the window in slices (every thread)
  auto start_copies = [&](int ch, int step) {
    const uint32_t st = s_base + (ch % cfg::STAGES) * cfg::STAGE_BYTES;
    if (step == 0 && tid == 0) {
      const uint32_t bar = s_full + 8 * (ch % cfg::STAGES);
      mbar_arrive_expect_tx(bar, cfg::W_BYTES);
      load_weights<NT>(st + IN_BYTES, bar, &k_map, b, ch * KC, n0, rank);
    }
    if (step < IN_SLICES)
      load_window_slice(st, xb, H, W, C, oy0 - 1, ox0 - 1, ch * KC, step, tid);
  };

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < cfg::STAGES; ++st) mbar_init(s_full + 8 * st, 1);
    fence_mbar_init();
  }
  cluster_sync();  // both blocks' barriers exist before either block's copies report to them

#pragma unroll
  for (int ch = 0; ch < cfg::AHEAD; ++ch) {
    if (ch < n_chunks)
      for (int step = 0; step < IN_SLICES; ++step) start_copies(ch, step);
    cp_async_commit();
  }

  // ldmatrix: lane l addresses row l % 16 of a 16-row operand (a pixel of the
  // warp's image row), 8 channels further along for lanes 16..31. Tile row of
  // m64 tile i: 8 wg + 4 i + wq.
  const int a_lane = 2 * (((8 * wg + wq) * IC + lane % 16) * IN_STRIDE + 8 * (lane / 16));

  uint32_t a[3][MT][4] = {};  // A fragments: step s of a chunk uses set s % 3

  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<cfg::AHEAD - 1>();  // this thread's copies of chunk ch's window have landed
    // ... as have every other thread's; and every warp of both blocks has started
    // the chunk before this one, so the stage refilled below is free in both
    cluster_sync();
    mbar_wait(s_full + 8 * (ch % cfg::STAGES), (ch / cfg::STAGES) & 1);  // ... and its weights
    const uint32_t st = s_base + (ch % cfg::STAGES) * cfg::STAGE_BYTES;
    const uint32_t a_base = st + a_lane;
    const uint64_t b_desc = wgmma_desc_sw128(st + IN_BYTES, BLOCK_BYTES, HALF_BYTES);
    const int ahead = ch + cfg::AHEAD;

#pragma unroll
    for (int i = 0; i < MT; ++i) ldmatrix_x4(a[0][i], a_base + 2 * (4 * i * IC * IN_STRIDE));
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      if (tap + 1 < 9) {
        const int dy = (tap + 1) / 3;
        const int dx = (tap + 1) % 3;
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldmatrix_x4(a[(tap + 1) % 3][i], a_base + 2 * (((4 * i + dy) * IC + dx) * IN_STRIDE));
      }
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < MT; ++i)
        wgmma_k16<NT>(acc[i], a[tap % 3][i], b_desc + ((tap * ATOM_BYTES) >> 4));
      wgmma_commit();
      if (ahead < n_chunks) start_copies(ahead, tap);
      wgmma_wait<1>();  // the step before this one is complete: its fragments are free
#pragma unroll
      for (int i = 0; i < MT; ++i) keep_alive(a[(tap + 2) % 3][i]);
    }
    if (cfg::DRAIN) wgmma_wait<0>();
    cp_async_commit();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
  fence_proxy_async();  // the stages, last written by the copy engine, are rewritten below
  __syncthreads();      // every warpgroup is done with the stages

  // epilogue: affine + SiLU in f32, one rounding to bf16, into the output tile
  // [TH * TW][OUT_STRIDE] in shared memory. For emit_gap the rounded values are
  // summed on the way: a lane's two columns have one parity, lanes 8 and 16
  // apart hold the other columns of that parity, and a warp's tile rows (one
  // per m64 tile) all have the parity of wq (tile origins are even, so parity
  // in the tile is parity in the image).
  __nv_bfloat16* const s_out = reinterpret_cast<__nv_bfloat16*>(smem);
  float* const s_gap = reinterpret_cast<float*>(smem + cfg::OUT_BYTES);  // [WARPS][2][NT]
  const bool emit_gap = partial != nullptr;
#pragma unroll
  for (int nt = 0; nt < NT / 8; ++nt) {
    const int cl = 8 * nt + 2 * (lane % 4);
    const float m0 = s_mul[cl], m1 = s_mul[cl + 1];
    const float a0 = s_add[cl], a1 = s_add[cl + 1];
    float g0 = 0.0f, g1 = 0.0f;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = 8 * wg + 4 * i + wq;
      const bool row_in = oy0 + r < H;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = lane / 4 + 8 * half;
        const float v0 = uavdet::silu_fast(acc[i][4 * nt + 2 * half] * m0 + a0);
        const float v1 = uavdet::silu_fast(acc[i][4 * nt + 2 * half + 1] * m1 + a1);
        const uint32_t packed = uavdet::pack_bf16x2(v0, v1);
        *reinterpret_cast<uint32_t*>(s_out + (r * TW + col) * cfg::OUT_STRIDE + cl) = packed;
        if (emit_gap && row_in && ox0 + col < W) {
          g0 += __uint_as_float(packed << 16);
          g1 += __uint_as_float(packed & 0xffff0000u);
        }
      }
    }
    if (emit_gap) {
      g0 += __shfl_xor_sync(0xffffffffu, g0, 8);
      g1 += __shfl_xor_sync(0xffffffffu, g1, 8);
      g0 += __shfl_xor_sync(0xffffffffu, g0, 16);
      g1 += __shfl_xor_sync(0xffffffffu, g1, 16);
      if (lane < 8) {
        float* dst = s_gap + (warp * 2 + lane / 4) * NT + cl;
        dst[0] = g0;
        dst[1] = g1;
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
    const uint4 v = *reinterpret_cast<const uint4*>(s_out + pix * cfg::OUT_STRIDE + 8 * q);
    const size_t off =
        fold_out ? ((static_cast<size_t>(b) * (H / 2) + oy / 2) * W + ox) * (2 * Co) +
                       static_cast<size_t>(Co) * (oy & 1) + n
                 : ((static_cast<size_t>(b) * H + oy) * W + ox) * Co + n;
    *reinterpret_cast<uint4*>(out + off) = v;
  }

  if (emit_gap) {
    // the warps of one row parity, always in this order
    for (int i = tid; i < 4 * NT; i += THREADS) {
      const int c = i % NT;
      const int pp = i / NT;  // 2 * row parity + column parity
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS / 2; ++w) sum += s_gap[((2 * w + pp / 2) * 2 + pp % 2) * NT + c];
      if (n0 + c < Co)
        partial[((static_cast<size_t>(b) * gridDim.x + tile) * 4 + pp) * Co + n0 + c] = sum;
    }
  }
}

// Tiles per image, rounded up to whole clusters: a tile past the image computes
// on zeros, stores nothing and adds zeros to the sums.
int padded_tiles(int H, int W) {
  const int tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  return (tiles + CLUSTER - 1) / CLUSTER * CLUSTER;
}

template <int NT>
cudaError_t launch(const void* x, const void* k, const void* mul, const void* add, void* out,
                   void* partial, int B, int H, int W, int C, int Co, int fold_out,
                   cudaStream_t stream) {
  const int tiles_x = (W + TW - 1) / TW;
  const int n_tiles = padded_tiles(H, W);
  const int co_tiles = (Co + NT - 1) / NT;
  if (co_tiles > 65535) return cudaErrorInvalidValue;
  // k as (Co, C, 9, B), innermost first; a box is 64 channels out x 8 in x 9 taps
  CUtensorMap k_map;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Co), static_cast<cuuint64_t>(C), 9,
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * Co, 2ull * Co * C, 2ull * Co * C * 9};
  const cuuint32_t box[4] = {64, 8, 9, 1};
  cudaError_t err = encode_bf16_map_sw128(&k_map, k, 4, dims, strides, box);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dyconv_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Cfg<NT>::SMEM_BYTES));
  if (err != cudaSuccess) return err;
  dyconv_kernel<NT><<<dim3(n_tiles, co_tiles, B), THREADS, Cfg<NT>::SMEM_BYTES, stream>>>(
      k_map, static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mul),
      static_cast<const float*>(add), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(partial), H, W, C, Co, tiles_x, fold_out);
  return cudaGetLastError();
}

}  // namespace

// Number of per-block partial sums per image that emit_gap writes: one per tile.
UAVDET_EXPORT int uavdet_dyconv_num_partials(int H, int W) { return padded_tiles(H, W); }

// x: (B, H, W, C) bf16; k: (B, 9, C, Co) bf16; mul: (Co,) f32; add: (B, Co) f32;
// out: (B, H, W, Co) bf16, or (B, H/2, W, 2 Co) when fold_out; partial: NULL, or
// (B, num_partials, 2, 2, Co) f32.
UAVDET_EXPORT int uavdet_dyconv(const void* x, const void* k, const void* mul, const void* add,
                                void* out, void* partial, int B, int H, int W, int C, int Co,
                                int fold_out, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 8 || Co < 8 || C % 8 || Co % 8 || B > 65535 ||
      (fold_out && H % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the N tile: 64 channels where that is all there are, else 128
  return static_cast<int>(Co <= 64 ? launch<64>(x, k, mul, add, out, partial, B, H, W, C, Co,
                                                fold_out, s)
                                   : launch<128>(x, k, mul, add, out, partial, B, H, W, C, Co,
                                                 fold_out, s));
}
