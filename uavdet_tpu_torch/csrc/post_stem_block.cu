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
// input: z and y outside the image are 0, not leaky(bias). H and W may be any
// size. The TPU kernel's strip DMAs, rolls, row-pair fold, lane padding and 0/1
// selection product answer Mosaic's tiling and are not reproduced.
//
// What bounds it on this card: arithmetic. At B=16, 320x320 it is 127.5 GFLOP
// against 210 MB read and 105 MB written (0.129 ms at 989 TFLOP/s bf16, 0.094
// ms at 3.35 TB/s). The first version (mma.sync, one block per 8x8 output
// tile, w1 and k2 staged and all of k3 streamed again by every one of the 6400
// blocks, every step behind __syncthreads) took 1.07-1.13 ms on an NVIDIA H100
// 80GB HBM3 at 700.00 W; this one about 0.8 (chip_smoke.py,
// scripts/block_ablate.py and scripts/kernel_probe.py on the same card). By
// count, its products take 0.16 ms at the bf16 peak (padding and z's
// recomputation included) and its shared-memory traffic about 0.25 ms at 128
// bytes a clock; what holds it is latency: a block of two warpgroups goes
// through z, y and the output conv of one tile in turn, with two block-wide
// syncs and a wait for the other block's sums per tile, and each product is
// m64n32, whose A fragments cost as many shared-memory bytes as it does
// tensor cycles.
// Design now:
//   Weights resident, products on wgmma. w1, k2 and k3 (188 KB) do not fit one
//     block beside the windows, so a thread block cluster of two blocks on two
//     SMs works on one 8x8 output tile. Block r computes z whole (5 % of the
//     work, twice), y's channels [32 r, 32 r + 32), and the output conv's sums
//     over those 32 channels of y for all 128 output channels; it keeps w1,
//     its half of k2 (by output channel) and its half of k3 (by input channel),
//     96 KB, loaded once. y never leaves its block: the two blocks' f32 sums
//     meet instead (32 KB a tile, pushed by 16-byte st.shared::cluster into the
//     block that finishes channels [64 r, 64 r + 64)), signalled on two
//     mbarriers of the receiving and the sending block (full, empty) by
//     remote arrives: each warpgroup waits for its partner only. The
//     grid is persistent: as many clusters as can be resident
//     (cudaOccupancyMaxActiveClusters), each walking the tiles in turn, so the
//     weights cross from the L2 cache once per block, not once per tile (1.2 GB
//     a call before).
//   All three convs are implicit GEMMs on wgmma.mma_async m64n32k16: A from
//     registers (ldmatrix out of the windows with per-lane pixel addresses, so
//     a tap is an address shift and the rows of a 64-row product can be any
//     pixels: z over the 19x19 x window, y over the 17x17 y window, out over the
//     8x8 tile with its stride-2 taps), B (the weights, 32 channels per product)
//     from shared memory through 64-byte-swizzled N-major descriptors. Two
//     warpgroups: z and y split by 64-row tiles (three each), out by 64-channel
//     halves of the 128. Three sets of A fragments rotate: a tap's fragments
//     load two taps ahead of its products, one wgmma group stays in flight.
//     No wgmma sits under a runtime condition (one that did, skipping y's last
//     64-row tile in one warpgroup, made ptxas serialize every wgmma of the
//     kernel: 1.07 ms against 0.86).
//   Loads under the math. x's 19x19 window comes by TMA (a 4-d tensor map of x,
//     128-byte swizzle, zeros outside the image, which is x's padding). The next
//     tile's window is requested as soon as this tile's z is made (the residual
//     is taken into registers first) and lands while the y and output convs
//     run; the tile leaves by a TMA store from a swizzled staging buffer
//     (clipped at the image's edge) while the next tile is computed. The
//     asynchronous copies need no producer warp: one thread starts each.
//   Bank conflicts: x is 128-byte swizzled; z's and y's pixels are 80 bytes
//     apart; y is split by column parity, so the output conv's stride-2 reads
//     are consecutive pixels.
//
// The stage ladder: the kernel is a template over the stage it is cut off
// after; a cut-off stage stores a tile of what it produced last (the pixel
// under each output pixel, repeated to the block's 64 channels), so that the
// compiler cannot drop the work. LOAD: the TMA windows, the resident weights
// and the tile's store; DOT1: + z; DOT2: + the block's half of y; FULL: + the
// output conv's sums and their exchange between the two blocks, the block.
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using namespace uavdet;

constexpr int C0 = 64;                     // channels of x and y
constexpr int C1 = 32;                     // channels of z, and of y per block
constexpr int C2 = 128;                    // channels of out
constexpr int TO = 8;                      // output tile edge
constexpr int WY = 2 * TO + 1;             // edge of the y window: 17
constexpr int WX = WY + 2;                 // edge of the x and z windows: 19
constexpr int NX = WX * WX;                // x and z window pixels: 361
constexpr int NY = WY * WY;                // y window pixels: 289
constexpr int YH = TO + 1;                 // y pixels per row and column parity (9 and 8 used)
constexpr int CLUSTER = 2;
constexpr int THREADS = 256;               // two warpgroups
constexpr int WG_THREADS = 128;
constexpr int MT = 3;                      // 64-row tiles per warpgroup for z and y
constexpr int X_PITCH = 128;               // bytes per staged pixel of x (64 channels, swizzled)
constexpr int Z_PITCH = 80;                // ... of z and of the block's y (32 channels + 16 bytes)
constexpr int ATOM = 512;                  // 8 K rows x 32 channels of a weight, 64-byte swizzled
constexpr int W1_BYTES = (C0 / 8) * ATOM;            // w1: K = 64, N = 32
constexpr int K2_BYTES = (9 * C1 / 8) * ATOM;        // k2's half: K = 288, N = 32
constexpr int K3_SLICE = (9 * C1 / 8) * ATOM;        // k3's half: K = 288, N = 4 slices of 32
constexpr int K3_BYTES = (C2 / 32) * K3_SLICE;
constexpr int PART_BYTES = WG_THREADS * 2 * 16 * 4;  // a warpgroup's 64 x 64 f32 sums
// shared memory, from a 1024-byte aligned base
constexpr int OFF_X = 0;                                        // TMA box, 128-byte swizzle
constexpr int OFF_OUT = (NX * X_PITCH + 1023) / 1024 * 1024;    // 8 x 8 x 64 staging, swizzled
constexpr int OFF_W1 = OFF_OUT + TO * TO * 128;
constexpr int OFF_K2 = OFF_W1 + W1_BYTES;
constexpr int OFF_K3 = OFF_K2 + K2_BYTES;
constexpr int OFF_Y = OFF_K3 + K3_BYTES;
constexpr int OFF_Z = OFF_Y + WY * 2 * YH * Z_PITCH;
constexpr int OFF_PART = OFF_Z + NX * Z_PITCH;                  // the other block's sums
constexpr int OFF_B = OFF_PART + PART_BYTES;                    // b1 (32), b2 (32), b3 (64) f32
constexpr int OFF_BAR = OFF_B + 4 * (C1 + C1 + C0);      // x's window, the sums' full and empty
constexpr size_t SMEM_BYTES = OFF_BAR + 3 * 8 + 1024;

static_assert(MT * 2 * 64 >= NX && MT * 2 * 64 >= NY, "two warpgroups' 64-row tiles cover z and y");
static_assert(OFF_W1 % 1024 == 0 && OFF_K2 % 512 == 0 && OFF_K3 % 512 == 0, "aligned operands");
static_assert(OFF_Y % 16 == 0 && OFF_Z % 16 == 0 && OFF_PART % 16 == 0 && OFF_BAR % 8 == 0,
              "aligned windows");
static_assert(SMEM_BYTES <= 232448, "one block per SM");

enum Stage {
  LOAD = 0,   // x's window by TMA, the weights, and the tile's store
  DOT1 = 1,   // + the 1x1 conv: z
  DOT2 = 2,   // + the block's half of the 3x3 conv and the residual: y
  FULL = 3    // + the stride-2 conv over the block's half of y, the exchange of sums
};

__device__ __forceinline__ float leaky(float v) { return fmaxf(v, 0.1f * v); }

// byte offset of 16-byte group g of staged x pixel p (128-byte swizzle)
__device__ __forceinline__ int x_at(int p, int g) { return p * X_PITCH + ((g ^ (p & 7)) << 4); }

// byte offset of y window pixel (r, c), split by column parity
__device__ __forceinline__ int y_at(int r, int c) {
  return ((r * 2 + (c & 1)) * YH + (c >> 1)) * Z_PITCH;
}

// the 128 threads of warpgroup g wait for each other (named barrier 1 + g)
__device__ __forceinline__ void warpgroup_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(WG_THREADS) : "memory");
}

// One tap's A fragments: MTS 64-row tiles, KS k16 steps of 16 channels (32
// bytes) from byte `shift` on.
template <int MTS, int KS>
__device__ __forceinline__ void load_tap(uint32_t (&a)[KS][MTS][4], const uint32_t (&base)[MTS],
                                         uint32_t shift) {
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int i = 0; i < MTS; ++i) ldmatrix_x4(a[k][i], base[i] + shift + 32 * k);
}

// Their products with NG slices of 32 weight columns (`group` bytes apart),
// the K rows of k16 step k at w + 2 k atoms; one wgmma group. No product sits
// under a condition: ptxas serializes every wgmma of a kernel in which one
// does.
template <int MTS, int KS, int NG>
__device__ __forceinline__ void mma_tap(float (&acc)[MTS][NG][16], const uint32_t (&a)[KS][MTS][4],
                                        uint32_t w, uint32_t group) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int i = 0; i < MTS; ++i)
#pragma unroll
      for (int n = 0; n < NG; ++n)
        wgmma_m64n32k16(acc[i][n], a[k][i], wgmma_desc_sw64(w + n * group + k * 2 * ATOM, ATOM));
  wgmma_commit();
}

template <int MTS, int KS>
__device__ __forceinline__ void keep_set(const uint32_t (&a)[KS][MTS][4]) {
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int i = 0; i < MTS; ++i) keep_alive(a[k][i]);
}

constexpr int SETS = 3;  // A fragment sets in a conv: taps loaded ahead of the products + 1

// A conv over TAPS taps whose A rows start at base[i] + tap_shift(tap), KS
// k16 steps per tap, the weights' K rows of tap `tap` from w + tap * tap_bytes.
// SETS sets of fragments rotate: a tap's fragments are loaded SETS - 1 taps
// ahead of its products, into the set whose products are complete.
template <int TAPS, int MTS, int KS, int NG, typename Shift>
__device__ __forceinline__ void conv(float (&acc)[MTS][NG][16], const uint32_t (&base)[MTS],
                                     Shift tap_shift, uint32_t w, uint32_t tap_bytes,
                                     uint32_t group) {
  uint32_t a[SETS][KS][MTS][4];
#pragma unroll
  for (int s = 0; s + 1 < SETS; ++s) load_tap<MTS, KS>(a[s], base, tap_shift(s));
#pragma unroll
  for (int tap = 0; tap < TAPS; ++tap) {
    mma_tap<MTS, KS, NG>(acc, a[tap % SETS], w + tap * tap_bytes, group);
    wgmma_wait<1>();  // the tap before this one is done: its fragments are free
    keep_set<MTS, KS>(a[(tap + SETS - 1) % SETS]);
    if (tap + SETS - 1 < TAPS)
      load_tap<MTS, KS>(a[(tap + SETS - 1) % SETS], base, tap_shift(tap + SETS - 1));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int s = 0; s < SETS; ++s) keep_set<MTS, KS>(a[s]);
}

template <int STAGE>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
post_stem_block_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap out_map,
                       const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ k2,
                       const __nv_bfloat16* __restrict__ k3, const float* __restrict__ b1,
                       const float* __restrict__ b2, const float* __restrict__ b3, int H, int W,
                       int tiles_x, int tiles_per_image, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzles are functions of the address: the base is 1024-byte aligned
  unsigned char* const smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t s_x = s_base + OFF_X;
  const uint32_t s_y = s_base + OFF_Y;
  const uint32_t s_z = s_base + OFF_Z;
  const uint32_t bar = s_base + OFF_BAR;
  // the other block's sums have landed here / ours there have been read
  const uint32_t sums_full = bar + 8;
  const uint32_t sums_empty = bar + 16;
  float* const s_b1 = reinterpret_cast<float*>(smem + OFF_B);
  float* const s_b2 = s_b1 + C1;
  float* const s_b3 = s_b2 + C1;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wq = (tid / 32) % 4;  // the warp's 16 rows of its warpgroup's 64-row tiles
  const int g = tid / WG_THREADS; // warpgroup
  const int rank = static_cast<int>(cluster_ctarank());
  const uint32_t peer_part = cluster_map_shared(s_base + OFF_PART, rank ^ 1);
  const int cluster = blockIdx.x / CLUSTER;
  const int n_clusters = gridDim.x / CLUSTER;

  // the tile's image and its output and x window origins
  auto tile_of = [&](int t, int& b, int& oy0, int& ox0) {
    b = t / tiles_per_image;
    const int r = t % tiles_per_image;
    oy0 = (r / tiles_x) * TO;
    ox0 = (r % tiles_x) * TO;
  };
  auto load_x = [&](int t) {  // one thread
    int b, oy0, ox0;
    tile_of(t, b, oy0, ox0);
    mbar_arrive_expect_tx(bar, NX * X_PITCH);
    tma_load_4d(s_x, &x_map, bar, 0, 2 * ox0 - 2, 2 * oy0 - 2, b);
  };

  // the block's weights, once: images of shared memory made by the wrapper
  {
    const int4* src[3] = {reinterpret_cast<const int4*>(w1),
                          reinterpret_cast<const int4*>(k2) + rank * (K2_BYTES / 16),
                          reinterpret_cast<const int4*>(k3) + rank * (K3_BYTES / 16)};
    const int off[3] = {OFF_W1, OFF_K2, OFF_K3};
    const int n[3] = {W1_BYTES / 16, K2_BYTES / 16, K3_BYTES / 16};
#pragma unroll
    for (int m = 0; m < 3; ++m)
      for (int i = tid; i < n[m]; i += THREADS) cp_async16(s_base + off[m] + 16 * i, src[m] + i, true);
    cp_async_commit();
  }
  if (tid < C1) s_b1[tid] = b1[tid];
  if (tid < C1) s_b2[tid] = b2[rank * C1 + tid];
  if (tid < C0) s_b3[tid] = b3[rank * C0 + tid];
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(sums_full, WG_THREADS);
    mbar_init(sums_empty, WG_THREADS);
    fence_mbar_init();
    if (cluster < n_tiles) load_x(cluster);
  }
  cp_async_wait<0>();
  fence_proxy_async();  // the weights, written by cp.async, are read by wgmma
  __syncthreads();
  // both blocks run, their barriers initialised, before either writes into
  // the other's shared memory
  if (STAGE == FULL) cluster_sync();

  // A rows, per lane: row lane % 16 of the warp's 16, 8 channels further for
  // lanes 16..31
  const int row = 16 * wq + lane % 16;
  const int half = lane / 16;
  // accumulator rows of a lane: lane / 4 and lane / 4 + 8; columns 8 j + 2 (lane % 4)
  const int c_row = 16 * wq + lane / 4;
  const int c_col = 2 * (lane % 4);
  // the window pixels of a lane's accumulator rows, as 32 row + column, -1
  // past the window: z's (19 x 19) and y's (17 x 17), for tile i of the
  // warpgroup (64-row tile g + 2 i) and row half h
  int z_pix[MT][2], y_pix[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 64 * (g + 2 * i) + c_row + 8 * h;
      z_pix[i][h] = p < NX ? 32 * (p / WX) + p % WX : -1;
      y_pix[i][h] = p < NY ? 32 * (p / WY) + p % WY : -1;
    }
  // z's and y's 64-row tiles: three per warpgroup (y's sixth lies past its
  // 289 pixels: its rows repeat the last pixel and are not stored)
  // the output conv: the 8 x 8 pixels over this block's 32 channels of y,
  // warpgroup g for output channels [64 g, 64 g + 64). Block g of the cluster
  // finishes those: the other block's warpgroup g sends it its sums.
  const uint32_t out_base[1] = {s_y + y_at(2 * (row / 8), 2 * (row % 8)) + 16 * half};
  const bool finisher = g == rank;
  const int store_tid = WG_THREADS * rank;  // the thread that stores the block's tiles

  int it = 0;
  for (int t = cluster; t < n_tiles; t += n_clusters, ++it) {
    int b, oy0, ox0;
    tile_of(t, b, oy0, ox0);
    const int gy0 = 2 * oy0 - 2;  // image row and column of x and z window pixel 0
    const int gx0 = 2 * ox0 - 2;
    mbar_wait(bar, it & 1);  // x's window has landed

    // a cut-off stage copies the pixel of x, z or y under each output pixel
    // into the staging buffer (once the last tile's store has read it) and
    // stores it
    auto cut_off = [&](int kind) {  // 0: x, 1: z, 2: y
      if (tid == 0) bulk_wait_read();
      __syncthreads();
      for (int i = tid; i < TO * TO * 8; i += THREADS) {
        const int m = i / 8;
        const int q = i % 8;
        const int oi = m / TO, oj = m % TO;
        const int p = (2 * oi + 2) * WX + 2 * oj + 2;
        const uint32_t src = kind == 0   ? s_x + x_at(p, q)
                             : kind == 1 ? s_z + p * Z_PITCH + 16 * (q % 4)
                                         : s_y + y_at(2 * oi + 1, 2 * oj + 1) + 16 * (q % 4);
        const uint4 v = *reinterpret_cast<const uint4*>(smem + (src - s_base));
        *reinterpret_cast<uint4*>(smem + OFF_OUT + m * 128 + ((q ^ (m & 7)) << 4)) = v;
      }
      fence_proxy_async();  // the staging buffer, written here, is read by the copy engine
      __syncthreads();
      if (tid == 0) {
        tma_store_4d(&out_map, s_base + OFF_OUT, rank * C0, ox0, oy0, b);
        bulk_commit();
      }
    };
    // x's window is read for the last time: the next tile's may come
    auto next_x = [&]() {
      fence_proxy_async();
      __syncthreads();
      if (tid == 0 && t + n_clusters < n_tiles) load_x(t + n_clusters);
    };

    if (STAGE == LOAD) {
      cut_off(0);
      next_x();
      continue;
    }

    // ---- z = leaky(w1 x + b1) on the 19 x 19 window, zero outside the image ----
    {
      float acc[MT][1][16] = {};
      uint32_t a[C0 / 16][MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int p = min(64 * (g + 2 * i) + row, NX - 1);
#pragma unroll
        for (int k = 0; k < C0 / 16; ++k) ldmatrix_x4(a[k][i], s_x + x_at(p, 2 * k + half));
      }
      mma_tap<MT, C0 / 16, 1>(acc, a, s_base + OFF_W1, 0);
      wgmma_wait<0>();
      keep_set<MT, C0 / 16>(a);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = z_pix[i][h];
          if (at < 0) continue;
          const int gy = gy0 + at / 32;
          const int gx = gx0 + at % 32;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
          unsigned char* dst = smem + OFF_Z + ((at / 32) * WX + at % 32) * Z_PITCH;
#pragma unroll
          for (int j = 0; j < C1 / 8; ++j) {
            const int n = 8 * j + c_col;
            const uint32_t v = in ? pack_bf16x2(leaky(acc[i][0][4 * j + 2 * h] + s_b1[n]),
                                                leaky(acc[i][0][4 * j + 2 * h + 1] + s_b1[n + 1]))
                                  : 0u;
            *reinterpret_cast<uint32_t*>(dst + 2 * n) = v;
          }
        }
    }
    if (STAGE == DOT1) {
      __syncthreads();
      cut_off(1);
      next_x();
      continue;
    }

    // x under the lane's y pixels and channels, the residual, into registers:
    // then x's window is free for the next tile's, which lands under this
    // tile's y and output convs
    __nv_bfloat162 res[MT][2][C1 / 8];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = y_pix[i][h];
        if (at < 0) continue;
        const int xp = (at / 32 + 1) * WX + at % 32 + 1;
#pragma unroll
        for (int j = 0; j < C1 / 8; ++j) {
          const int nx = rank * C1 + 8 * j + c_col;
          res[i][h][j] = *reinterpret_cast<const __nv_bfloat162*>(smem + OFF_X + x_at(xp, nx / 8) +
                                                                  2 * (nx % 8));
        }
      }
    next_x();  // z is complete, and x has no reader left

    // ---- y = leaky(conv3x3(z, k2) + b2) + x, this block's 32 channels, on the
    // 17 x 17 window; y (r, c) is z pixel (r + 1, c + 1), its tap (dy, dx) z
    // pixel (r + dy, c + dx) ----
    {
      float acc[MT][1][16] = {};
      uint32_t base[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int q = min(64 * (g + 2 * i) + row, NY - 1);
        base[i] = s_z + ((q / WY) * WX + q % WY) * Z_PITCH + 16 * half;
      }
      conv<9, MT, C1 / 16, 1>(
          acc, base,
          [](int tap) { return static_cast<uint32_t>(((tap / 3) * WX + tap % 3) * Z_PITCH); },
          s_base + OFF_K2, (C1 / 16) * 2 * ATOM, 0);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = y_pix[i][h];
          if (at < 0) continue;
          const int r = at / 32, c = at % 32;
          const int gy = gy0 + 1 + r;
          const int gx = gx0 + 1 + c;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
          unsigned char* dst = smem + OFF_Y + y_at(r, c);
#pragma unroll
          for (int j = 0; j < C1 / 8; ++j) {
            const int n = 8 * j + c_col;  // of this block's 32
            uint32_t v = 0u;
            if (in) {
              const float2 x2 = __bfloat1622float2(res[i][h][j]);
              v = pack_bf16x2(leaky(acc[i][0][4 * j + 2 * h] + s_b2[n]) + x2.x,
                              leaky(acc[i][0][4 * j + 2 * h + 1] + s_b2[n + 1]) + x2.y);
            }
            *reinterpret_cast<uint32_t*>(dst + 2 * n) = v;
          }
        }
    }
    __syncthreads();  // y is complete

    if (STAGE == DOT2) {
      cut_off(2);
      continue;
    }

    // ---- out = leaky(conv3x3 s2(y, k3) + b3): this block's sums over its 32
    // channels of y, for all 128 output channels; the two blocks' sums meet
    // in the block that finishes the channels ----
    {
      float acc[1][2][16] = {};
      conv<9, 1, C1 / 16, 2>(
          acc, out_base,
          [](int tap) {
            const int dy = tap / 3, dx = tap % 3;
            return static_cast<uint32_t>(((dy * 2 + (dx & 1)) * YH + (dx >> 1)) * Z_PITCH);
          },
          s_base + OFF_K3 + 2 * g * K3_SLICE, (C1 / 16) * 2 * ATOM, K3_SLICE);
      // the sums of thread i of a warpgroup as 8 x 16 bytes, q-major
      const int i = tid % WG_THREADS;
      // each thread of the two warpgroups that meet arrives once per tile on
      // the other block's barrier: the sender after its stores, the finisher
      // after its reads
      if (!finisher) {
        if (it > 0) mbar_wait_cluster(sums_empty, (it - 1) & 1);  // the last tile's are read
#pragma unroll
        for (int q = 0; q < 8; ++q)
          st_cluster_v4(peer_part + (q * WG_THREADS + i) * 16, acc[0][q / 4][4 * (q % 4)],
                        acc[0][q / 4][4 * (q % 4) + 1], acc[0][q / 4][4 * (q % 4) + 2],
                        acc[0][q / 4][4 * (q % 4) + 3]);
        mbar_arrive_cluster(cluster_map_shared(sums_full, rank ^ 1));
      } else {
        mbar_wait_cluster(sums_full, it & 1);  // the other block's sums are here
        const float4* part = reinterpret_cast<const float4*>(smem + OFF_PART);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 v = part[q * WG_THREADS + i];
          acc[0][q / 4][4 * (q % 4)] += v.x;
          acc[0][q / 4][4 * (q % 4) + 1] += v.y;
          acc[0][q / 4][4 * (q % 4) + 2] += v.z;
          acc[0][q / 4][4 * (q % 4) + 3] += v.w;
        }
        mbar_arrive_cluster(cluster_map_shared(sums_empty, rank ^ 1));
        if (tid == store_tid) bulk_wait_read();  // the last tile's store has read the staging
        warpgroup_sync(g);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = c_row + 8 * h;
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int ch = 32 * n + 8 * j + c_col;  // of the block's 64
              const int e = 4 * j + 2 * h;
              *reinterpret_cast<uint32_t*>(smem + OFF_OUT + m * 128 +
                                           (((ch / 8) ^ (m & 7)) << 4) + 2 * (ch % 8)) =
                  pack_bf16x2(leaky(acc[0][n][e] + s_b3[ch]), leaky(acc[0][n][e + 1] + s_b3[ch + 1]));
            }
        }
        fence_proxy_async();  // the staging buffer, written here, is read by the copy engine
        warpgroup_sync(g);
        if (tid == store_tid) {
          tma_store_4d(&out_map, s_base + OFF_OUT, rank * C0, ox0, oy0, b);
          bulk_commit();
        }
      }
    }
  }
  // no block leaves while the other may still arrive on its barriers
  if (STAGE == FULL) cluster_sync();
  bulk_wait_read();  // this thread's last store has read the staging buffer
}

template <int STAGE>
cudaError_t launch(const void* x, const void* w1, const void* k2, const void* k3, const void* b1,
                   const void* b2, const void* b3, void* out, int B, int H, int W,
                   cudaStream_t stream) {
  const int Ho = (H + 1) / 2;
  const int Wo = (W + 1) / 2;
  const int tiles_x = (Wo + TO - 1) / TO;
  const int tiles_per_image = tiles_x * ((Ho + TO - 1) / TO);
  const long long n_tiles = static_cast<long long>(tiles_per_image) * B;
  if (n_tiles > (1ll << 30)) return cudaErrorInvalidValue;
  CUtensorMap x_map, out_map;
  {  // x as (64, W, H, B) and out as (128, Wo, Ho, B), innermost first
    const cuuint64_t dims[4] = {C0, static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {2ull * C0, 2ull * C0 * W, 2ull * C0 * W * H};
    const cuuint32_t box[4] = {C0, WX, WX, 1};
    cudaError_t err = encode_bf16_map_sw128(&x_map, x, 4, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  {
    const cuuint64_t dims[4] = {C2, static_cast<cuuint64_t>(Wo), static_cast<cuuint64_t>(Ho),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {2ull * C2, 2ull * C2 * Wo, 2ull * C2 * Wo * Ho};
    const cuuint32_t box[4] = {C0, TO, TO, 1};
    cudaError_t err = encode_bf16_map_sw128(&out_map, out, 4, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  // the shared-memory attribute and the number of clusters that can be
  // resident at once, per device, asked once
  static int clusters_of[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (clusters_of[dev] == 0) {
    err = cudaFuncSetAttribute(post_stem_block_kernel<STAGE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM_BYTES));
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(sms / CLUSTER * CLUSTER);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM_BYTES;  // the cluster's shape is the kernel's own
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, post_stem_block_kernel<STAGE>, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    clusters_of[dev] = clusters;
  }
  const int clusters = static_cast<int>(n_tiles < clusters_of[dev] ? n_tiles : clusters_of[dev]);
  post_stem_block_kernel<STAGE><<<clusters * CLUSTER, THREADS, SMEM_BYTES, stream>>>(
      x_map, out_map, static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(k2),
      static_cast<const __nv_bfloat16*>(k3), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<const float*>(b3), H, W, tiles_x,
      tiles_per_image, static_cast<int>(n_tiles));
  return cudaGetLastError();
}

}  // namespace

// x: (B, H, W, 64) bf16, 16-byte aligned. The weights as images of the
// kernel's shared memory (ops/block.py: pack_block_weights): w1 (2048,), k2
// (2, 9216), k3 (2, 36864) bf16, the first index the block of a cluster; b1
// (32,), b2 (2, 32), b3 (2, 64) f32. out: (B, ceil(H/2), ceil(W/2), 128) bf16.
// stage: where the ladder is cut off (see Stage); only the last stage's output
// is the block's.
UAVDET_EXPORT int uavdet_post_stem_block(const void* x, const void* w1, const void* k2,
                                         const void* k3, const void* b1, const void* b2,
                                         const void* b3, void* out, int B, int H, int W, int stage,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (stage) {
    case LOAD: return static_cast<int>(launch<LOAD>(x, w1, k2, k3, b1, b2, b3, out, B, H, W, s));
    case DOT1: return static_cast<int>(launch<DOT1>(x, w1, k2, k3, b1, b2, b3, out, B, H, W, s));
    case DOT2: return static_cast<int>(launch<DOT2>(x, w1, k2, k3, b1, b2, b3, out, B, H, W, s));
    case FULL: return static_cast<int>(launch<FULL>(x, w1, k2, k3, b1, b2, b3, out, B, H, W, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
