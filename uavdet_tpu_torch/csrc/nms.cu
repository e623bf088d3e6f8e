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
// input is 131 KB and the IoU work 2.1 M pairs, but greedy suppression is a
// sequential recurrence over the ranks; as plain tensor code it is hundreds of
// tiny launches. Design: one block per image. The block computes the IoU of
// every pair (i, j > i) once, in parallel, into an N x ceil(N/64) bitmask of
// 64-bit words in shared memory (32 KB at N = 512). Then one warp walks the
// ranks in order: lane l holds the "removed" bits of ranks [64 l, 64 l + 64),
// the rank's bit is read with one shuffle, and a surviving rank ORs its row
// into the lanes' words. The whole NMS is one launch.
//
// The IoU follows uavdet_tpu/ops/boxes.py (_area, box_iou_pairwise) operation
// by operation, with explicitly rounded intrinsics so that nvcc cannot contract
// a multiply and an add into an FMA: the mask is bitwise equal to the plain
// PyTorch version's.
#include "common.cuh"

namespace {

constexpr int MAX_N = 1024;
constexpr int THREADS = 256;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f), fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__global__ void __launch_bounds__(THREADS)
nms_kernel(const float4* __restrict__ boxes, uint8_t* __restrict__ alive, int N, float thr) {
  extern __shared__ unsigned long long s_mask[];  // [N][words]: bit j of row i: i suppresses j
  __shared__ float4 s_box[MAX_N];
  __shared__ float s_area[MAX_N];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int words = (N + 63) / 64;

  const float4* bb = boxes + static_cast<size_t>(b) * N;
  for (int i = tid; i < N; i += THREADS) {
    const float4 v = bb[i];
    s_box[i] = v;
    s_area[i] = box_area(v);
  }
  __syncthreads();

  for (int idx = tid; idx < N * words; idx += THREADS) {
    const int i = idx / words;
    const int w = idx % words;
    const float4 a = s_box[i];
    const float area_i = s_area[i];
    unsigned long long bits = 0ull;
    const int j1 = min(64 * w + 64, N);
    for (int j = max(64 * w, i + 1); j < j1; ++j) {
      const float4 c = s_box[j];
      const float iw = fmaxf(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)), 0.0f);
      const float ih = fmaxf(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(area_i, s_area[j]), inter);
      if (__fdiv_rn(inter, fmaxf(uni, 1e-7f)) > thr) bits |= 1ull << (j - 64 * w);
    }
    s_mask[idx] = bits;
  }
  __syncthreads();

  if (tid < 32) {
    unsigned long long removed = 0ull;  // lane l: ranks [64 l, 64 l + 64)
    uint8_t* out = alive + static_cast<size_t>(b) * N;
    for (int i = 0; i < N; ++i) {
      const unsigned long long word = __shfl_sync(0xffffffffu, removed, i / 64);
      const bool keep = ((word >> (i % 64)) & 1ull) == 0ull;
      if (keep && tid < words) removed |= s_mask[i * words + tid];
      if (tid == 0) out[i] = keep ? 1 : 0;
    }
  }
}

}  // namespace

UAVDET_EXPORT int uavdet_nms_max_boxes() { return MAX_N; }

// boxes: (B, N, 4) f32, score-sorted per image; alive: (B, N) bytes (0/1).
UAVDET_EXPORT int uavdet_nms_alive(const void* boxes, void* alive, int B, int N, float thr,
                                   void* stream) {
  if (N < 1 || N > MAX_N || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(unsigned long long) * N * ((N + 63) / 64);
  cudaError_t err = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<uint8_t*>(alive), N, thr);
  return static_cast<int>(cudaGetLastError());
}

UAVDET_EXPORT const char* uavdet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
