// Greedy-NMS survivor mask, for Hopper (sm_90a).
//
// Replaces the TPU kernel uavdet_tpu/ops/pallas_nms.py: _nms_kernel /
// pallas_nms_alive. Input: per image, N xyxy f32 boxes sorted by descending
// score (rank order is the suppression priority). Output: alive (B, N), 1 where
// no earlier surviving box overlaps the box with IoU strictly above the
// threshold. Zero-area padding has IoU 0 with everything and survives; the
// caller masks it by its score.
//
// What bounds it on this card: latency, not bytes or FLOPs. At B=16, N=512 the
// input is 131 KB and the IoU work 2.1 M pairs (0.0004 ms of the f32 pipe), but
// greedy suppression is a chain of N dependent steps, and one block per image
// leaves 116 of 132 SMs idle at batch 16 and 131 at batch 1. A first version
// (one block of 256 threads per image: every pair on 8 warps, then one warp
// walking the ranks with a shuffle and a dependent shared-memory load per rank)
// took 0.25 ms on an NVIDIA H100 80GB HBM3 at 700 W, 0.215 of them the pair
// mask and 0.042 the walk, at 16 images and at one alike. Design now (0.029 ms
// at 16 images, 0.024 at one: 0.011 to 0.016 the pair mask, 0.012 the walk):
//   The pair mask over the card. A cluster of 8 blocks works on one image:
//     block r computes rows r, r + 8, r + 16, .. of the N x ceil(N/64) bitmask
//     (bit j of row i: i suppresses j > i) into its own shared memory. Rows are
//     dealt round-robin because row i has N - 1 - i pairs: every block gets the
//     same share of the triangle. A warp takes a row, its lanes take 32 columns
//     at a time, and a ballot packs the 32 predicates: conflict-free float4
//     loads, no serial loop of 64 divisions per thread. 16 images x 8 blocks
//     fill 128 of 132 SMs; one image uses 8 SMs.
//   The walk without a load in its chain. After one cluster barrier, warp 0 of
//     block 0 walks the ranks 64 at a time, reading rows out of the other
//     blocks' shared memory (distributed shared memory, mapa +
//     ld.shared::cluster). Per 64 ranks: the 64 diagonal words arrive one per
//     lane (twice), fetched a step ahead; the survivors inside the word are
//     resolved by 64 steps of register arithmetic, each fed by a shuffle whose
//     source does not depend on the chain; then the surviving rows are OR-ed
//     into the lanes' `removed` words (lane l holds ranks [64 l, 64 l + 64)) by
//     loads that are independent of each other, 16 in flight at a time (32
//     made the walk 1.6 us shorter and the kernel 17 us longer at 16 images:
//     past 64 registers only one block fits an SM, and 16 clusters of 8 no
//     longer run side by side). A
//     final cluster barrier keeps every block's shared memory alive until the
//     walk is done.
//   36 KB of static shared memory per block: no attribute to set per launch.
// Above MAX_N boxes an image's mask no longer fits a cluster's shared memory
// (N = 4096 is 2 MB), and two kernels take its place, with the mask rows in
// device memory (B x N x ceil(N/64) words, scratch from the caller):
//   nms_mask_kernel fills them with the same row-per-warp ballot, rows dealt
//     round-robin over as many blocks per image as fill the card twice, the
//     boxes read through the L1 cache;
//   nms_walk_kernel, one warp per image, walks them with the same 64-rank
//     register walk, the diagonal words a step ahead and the surviving rows
//     OR-ed in by 16 independent loads at a time, now from the L2 cache; the
//     removed words live in shared memory, a lane per later word.
//
// The IoU follows uavdet_tpu/ops/boxes.py (_area, box_iou_pairwise) operation
// by operation, with explicitly rounded intrinsics so that nvcc cannot contract
// a multiply and an add into an FMA: the mask is bitwise equal to the plain
// PyTorch version's.
#include "mma.cuh"
#include "tma.cuh"

namespace {

using namespace uavdet;

constexpr int MAX_N = 1024;                      // ops/nms.py: MAX_BOXES
constexpr int CLUSTER = 8;                       // blocks per image
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_WORDS = MAX_N / 64;            // 64-bit words of a mask row (its pitch)
constexpr int MAX_ROWS = MAX_N / CLUSTER;        // mask rows a block holds
constexpr int WORD_ROWS = 64 / CLUSTER;          // of them, rows per 64 ranks (one mask word)
constexpr unsigned FULL = 0xffffffffu;

static_assert(32 % CLUSTER == 0, "ranks 64 w + lane and 64 w + 32 + lane lie in one block");

using u64 = unsigned long long;

enum Mode {
  RUN = 0,      // the kernel
  STAMPED = 1,  // + the global timer after each phase, for the measurement of the two phases
  EMPTY = 2     // the same grid and clusters, no work: what a launch alone costs
};

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f), fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

template <int MODE>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 2)
nms_kernel(const float4* __restrict__ boxes, uint8_t* __restrict__ alive, int N, float thr,
           long long* __restrict__ stamps) {
  if (MODE == EMPTY) return;
  __shared__ u64 s_mask[MAX_ROWS * MAX_WORDS];   // row i of the image at [i / CLUSTER] here
  __shared__ float4 s_box[MAX_N];
  __shared__ float s_area[MAX_N];

  const int b = blockIdx.y;
  const int rank = static_cast<int>(cluster_ctarank());
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int words = (N + 63) / 64;
  const bool stamping = MODE == STAMPED && rank == 0 && tid == 0;
  if (stamping) stamps[3 * b] = global_ns();

  const float4* bb = boxes + static_cast<size_t>(b) * N;
  for (int i = tid; i < N; i += THREADS) {
    const float4 v = bb[i];
    s_box[i] = v;
    s_area[i] = box_area(v);
  }
  __syncthreads();

  // this block's rows of the mask, a warp per row, a ballot per 32 columns
  for (int row = warp; CLUSTER * row + rank < N; row += WARPS) {
    const int i = CLUSTER * row + rank;
    const float4 a = s_box[i];
    const float area_i = s_area[i];
    for (int w = i / 64; w < words; ++w) {
      unsigned bits[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 64 * w + 32 * h + lane;
        bool over = false;
        if (j > i && j < N) {
          const float4 c = s_box[j];
          const float iw = fmaxf(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)), 0.0f);
          const float ih = fmaxf(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)), 0.0f);
          const float inter = __fmul_rn(iw, ih);
          const float uni = __fsub_rn(__fadd_rn(area_i, s_area[j]), inter);
          over = __fdiv_rn(inter, fmaxf(uni, 1e-7f)) > thr;
        }
        bits[h] = __ballot_sync(FULL, over);
      }
      if (lane == 0) s_mask[row * MAX_WORDS + w] = (static_cast<u64>(bits[1]) << 32) | bits[0];
    }
  }
  cluster_sync();  // every block's rows are written and visible to the cluster
  if (stamping) stamps[3 * b + 1] = global_ns();

  if (rank == 0 && warp == 0) {
    // rank 64 w + k lies in block k % CLUSTER, at its row WORD_ROWS w + k / CLUSTER
    const uint32_t local = smem_u32(s_mask);
    uint32_t base[CLUSTER];
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) base[r] = cluster_map_shared(local, r);
    const uint32_t lane_base =
        cluster_map_shared(local, lane % CLUSTER) + (lane / CLUSTER) * MAX_WORDS * 8;
    // the diagonal words of ranks 64 w + lane and 64 w + 32 + lane
    auto diagonal = [&](int w, int h) -> u64 {
      if (w >= words || 64 * w + 32 * h + lane >= N) return 0ull;
      return ld_cluster_u64(lane_base +
                            ((WORD_ROWS * w + WORD_ROWS / 2 * h) * MAX_WORDS + w) * 8);
    };
    uint8_t* out = alive + static_cast<size_t>(b) * N;
    u64 removed = 0ull;  // lane l: ranks [64 l, 64 l + 64)
    u64 next[2] = {diagonal(0, 0), diagonal(0, 1)};
    for (int w = 0; w < words; ++w) {
      const u64 diag[2] = {next[0], next[1]};
      next[0] = diagonal(w + 1, 0);
      next[1] = diagonal(w + 1, 1);
      u64 rem = __shfl_sync(FULL, removed, w);
#pragma unroll
      for (int k = 0; k < 64; ++k) {
        const u64 row = __shfl_sync(FULL, diag[k / 32], k % 32);
        if (((rem >> k) & 1ull) == 0ull) rem |= row;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 64 * w + 32 * h + lane;
        if (i < N) out[i] = static_cast<uint8_t>(((rem >> (32 * h + lane)) & 1ull) ^ 1ull);
      }
      if (w + 1 == words) break;  // no later word; ranks past N are never read as rows
      const bool takes = lane > w && lane < words;
      const uint32_t at = (WORD_ROWS * w * MAX_WORDS + lane) * 8;
      u64 acc = 0ull;
#pragma unroll
      for (int k0 = 0; k0 < 64; k0 += 16) {
        u64 v[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int k = k0 + q;
          v[q] = 0ull;
          if (takes && ((rem >> k) & 1ull) == 0ull)
            v[q] = ld_cluster_u64(base[k % CLUSTER] + at + (k / CLUSTER) * MAX_WORDS * 8);
        }
#pragma unroll
        for (int q = 0; q < 16; ++q) acc |= v[q];
      }
      removed |= acc;
    }
    if (stamping) stamps[3 * b + 2] = global_ns();
  }
  cluster_sync();  // no block leaves while its rows may still be read
}

// ---- above MAX_N: the mask in device memory ----

constexpr int BIG_THREADS = 512;
constexpr int BIG_WARPS = BIG_THREADS / 32;
constexpr int BIG_BLOCKS = 264;  // blocks over all images: two per SM of an H100

// Rows r, r + G, r + 2G, .. of image blockIdx.y's mask (G = gridDim.x), a
// warp per row, into mask[b][i][w] for the words w >= i / 64 (the walk reads
// no other word of row i).
__global__ void __launch_bounds__(BIG_THREADS)
nms_mask_kernel(const float4* __restrict__ boxes, u64* __restrict__ mask, int N, float thr) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int words = (N + 63) / 64;
  const float4* bb = boxes + static_cast<size_t>(b) * N;
  u64* mb = mask + static_cast<size_t>(b) * N * words;
  for (int i = blockIdx.x + gridDim.x * (threadIdx.x / 32); i < N; i += gridDim.x * BIG_WARPS) {
    const float4 a = bb[i];
    const float area_i = box_area(a);
    for (int w = i / 64; w < words; ++w) {
      unsigned bits[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 64 * w + 32 * h + lane;
        bool over = false;
        if (j > i && j < N) {
          const float4 c = bb[j];
          const float iw = fmaxf(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)), 0.0f);
          const float ih = fmaxf(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)), 0.0f);
          const float inter = __fmul_rn(iw, ih);
          const float uni = __fsub_rn(__fadd_rn(area_i, box_area(c)), inter);
          over = __fdiv_rn(inter, fmaxf(uni, 1e-7f)) > thr;
        }
        bits[h] = __ballot_sync(FULL, over);
      }
      if (lane == 0) mb[static_cast<size_t>(i) * words + w] = (static_cast<u64>(bits[1]) << 32) | bits[0];
    }
  }
}

// One warp per image: the walk of nms_kernel over rows in device memory.
// s_removed[w]: the ranks [64 w, 64 w + 64) removed by the survivors so far.
__global__ void __launch_bounds__(32)
nms_walk_kernel(const u64* __restrict__ mask, uint8_t* __restrict__ alive, int N) {
  extern __shared__ u64 s_removed[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int words = (N + 63) / 64;
  const u64* mb = mask + static_cast<size_t>(b) * N * words;
  for (int w = lane; w < words; w += 32) s_removed[w] = 0ull;
  __syncwarp();
  // the diagonal words of ranks 64 w + lane and 64 w + 32 + lane
  auto diagonal = [&](int w, int h) -> u64 {
    const int k = 64 * w + 32 * h + lane;
    if (w >= words || k >= N) return 0ull;
    return mb[static_cast<size_t>(k) * words + w];
  };
  uint8_t* out = alive + static_cast<size_t>(b) * N;
  u64 next[2] = {diagonal(0, 0), diagonal(0, 1)};
  for (int w = 0; w < words; ++w) {
    const u64 diag[2] = {next[0], next[1]};
    next[0] = diagonal(w + 1, 0);
    next[1] = diagonal(w + 1, 1);
    u64 rem = s_removed[w];
#pragma unroll
    for (int k = 0; k < 64; ++k) {
      const u64 row = __shfl_sync(FULL, diag[k / 32], k % 32);
      if (((rem >> k) & 1ull) == 0ull) rem |= row;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 64 * w + 32 * h + lane;
      if (i < N) out[i] = static_cast<uint8_t>(((rem >> (32 * h + lane)) & 1ull) ^ 1ull);
    }
    if (w + 1 == words) break;  // no later word; ranks past N are never read as rows
    const u64* rows = mb + static_cast<size_t>(64 * w) * words;
    for (int w2 = w + 1 + lane; w2 < words; w2 += 32) {
      u64 acc = 0ull;
#pragma unroll
      for (int k0 = 0; k0 < 64; k0 += 16) {
        u64 v[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int k = k0 + q;
          v[q] = ((rem >> k) & 1ull) == 0ull ? rows[static_cast<size_t>(k) * words + w2] : 0ull;
        }
#pragma unroll
        for (int q = 0; q < 16; ++q) acc |= v[q];
      }
      s_removed[w2] |= acc;
    }
    __syncwarp();
  }
}

template <int MODE>
int launch(const void* boxes, void* alive, void* stamps, int B, int N, float thr, void* stream) {
  if (N < 1 || N > MAX_N || B < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  nms_kernel<MODE><<<dim3(CLUSTER, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<uint8_t*>(alive), N, thr,
      static_cast<long long*>(stamps));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// boxes: (B, N, 4) f32, score-sorted per image; alive: (B, N) bytes (0/1).
UAVDET_EXPORT int uavdet_nms_alive(const void* boxes, void* alive, int B, int N, float thr,
                                   void* stream) {
  return launch<RUN>(boxes, alive, nullptr, B, N, thr, stream);
}

// N > MAX_N boxes per image (and any N >= 1): the same mask through the
// scratch `mask`, (B, N, ceil(N / 64)) 64-bit words, filled and walked by two
// kernels on `stream`.
UAVDET_EXPORT int uavdet_nms_alive_large(const void* boxes, void* alive, void* mask, int B, int N,
                                         float thr, void* stream) {
  if (N < 1 || B < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t removed_bytes = 8 * static_cast<size_t>((N + 63) / 64);
  if (removed_bytes > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_image = (BIG_BLOCKS + B - 1) / B;
  const int row_blocks = per_image < (N + BIG_WARPS - 1) / BIG_WARPS ? per_image
                                                                    : (N + BIG_WARPS - 1) / BIG_WARPS;
  nms_mask_kernel<<<dim3(row_blocks, B), BIG_THREADS, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<u64*>(mask), N, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_walk_kernel<<<B, 32, removed_bytes, s>>>(static_cast<const u64*>(mask),
                                                static_cast<uint8_t*>(alive), N);
  return static_cast<int>(cudaGetLastError());
}

// The same, and stamps (B, 3) int64: the global timer in ns at the image's
// start, after its pair mask (the cluster barrier) and after its walk.
UAVDET_EXPORT int uavdet_nms_alive_stamped(const void* boxes, void* alive, void* stamps, int B,
                                           int N, float thr, void* stream) {
  return launch<STAMPED>(boxes, alive, stamps, B, N, thr, stream);
}

// The kernel's grid, clusters and block size with no work in it.
UAVDET_EXPORT int uavdet_nms_empty_launch(int B, void* stream) {
  return launch<EMPTY>(nullptr, nullptr, nullptr, B, 1, 0.0f, stream);
}

UAVDET_EXPORT const char* uavdet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
