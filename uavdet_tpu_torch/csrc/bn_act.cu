// The epilogue of the port's conv blocks in inference, for Hopper (sm_90a):
// BatchNorm from its running statistics, then LeakyReLU(0.1) or SiLU, then
// an optional residual, in one pass over the conv's output:
//     y = act((x - mean[c]) * (w[c] / sqrt(var[c] + eps)) + b[c]) [+ r]
// x, r and y are bf16 maps (B, C, H, W) in one memory format, channels_last
// or contiguous NCHW; mean, var, w and b are the BatchNorm's own four
// vectors, all bf16 or all f32, read at each launch. Every step is one f32
// operation rounded to nearest (no contraction into an fma), in the order
// of the plain version (ops/bn_act.py: bn_act_plain), and the store rounds
// to bf16 once; PyTorch's chain of three passes rounds after each.
//
// Replaces no TPU kernel: on the TPU, XLA fused this epilogue into the conv.
// It was added because the port ran it as PyTorch's eval BatchNorm, its
// activation and its add, three passes that each read and write the whole
// map, the BatchNorm at 1.2 to 1.9 of the card's 3.35 TB/s.
//
// What bounds it on this card: bytes. Each value of x and r is read once
// and each value of y written once: 2N + R bytes for N bytes of x (R of r).
// Some 10 f32 operations a value are far below the f32 rate.
//
// Design: 16-byte loads and stores, eight neighbouring bf16 values a thread,
// four vectors in flight a thread (with a residual two of x and two of r),
// in a grid-stride loop over a grid of four resident blocks a SM (the
// wrapper sizes it: ops/bn_act.py: bn_act_grid; 64 registers a thread at
// most). Each block first turns the four vectors into f32 (mean, scale,
// bias) per channel in shared memory.
//   channels_last, C % 8 == 0 (every served map): the grid's threads are a
//     multiple of C / 8, so a thread's vectors all hold the same eight
//     channels; it keeps their 24 values in registers, and the loop has no
//     division.
//   NCHW, H W % 8 == 0: a vector lies in one channel, (i / (H W / 8)) % C.
//   anything else (or a pointer off 16 bytes): one value at a time.
// Loads are evict-first (__ldcs): the block's input and skip are dead after
// it. Stores are plain, so that the next conv may find y in the L2 cache.
#include <climits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;  // ops/bn_act.py's grid: 4 blocks a SM, all resident
constexpr int MAX_C = 4096;       // 3 C f32 values of shared memory, 48 KB

// 16-byte vectors of x in flight a thread, in the channels_last kernel:
// with a residual, two of x and two of r, so that 24 values of the
// channels' table, the vectors and their addresses fit the 64 registers a
// thread may take with four blocks of 256 threads on a SM
template <bool RES>
constexpr int UNROLL = RES ? 2 : 4;

enum Act { LEAKY_RELU = 0, SILU = 1 };

template <int ACT>
__device__ __forceinline__ float act(float v) {
  if constexpr (ACT == LEAKY_RELU) return v > 0.0f ? v : __fmul_rn(v, 0.1f);
  else return uavdet::silu_fast(v);
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// the block's per-channel (mean, scale, bias) in shared memory:
// sh[c], sh[C + c], sh[2 C + c]; scale = w / sqrt(var + eps), each step
// rounded as the plain version's
template <typename P>
__device__ __forceinline__ void load_params(float* sh, const P* __restrict__ mean,
                                            const P* __restrict__ var, const P* __restrict__ w,
                                            const P* __restrict__ b, float eps, int C) {
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(to_f32(var[c]), eps)));
    sh[c] = to_f32(mean[c]);
    sh[C + c] = __fmul_rn(inv, to_f32(w[c]));
    sh[2 * C + c] = to_f32(b[c]);
  }
  __syncthreads();
}

template <int ACT, bool RES>
__device__ __forceinline__ float epilogue(float x, float m, float s, float b, float r) {
  const float v = act<ACT>(__fadd_rn(__fmul_rn(__fsub_rn(x, m), s), b));
  return RES ? __fadd_rn(v, r) : v;
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(p[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(uavdet::pack_bf16x2(f[0], f[1]), uavdet::pack_bf16x2(f[2], f[3]),
                    uavdet::pack_bf16x2(f[4], f[5]), uavdet::pack_bf16x2(f[6], f[7]));
}

// channels_last, C % 8 == 0: nv vectors of 8 channels; the grid's threads
// are a multiple of C / 8, so thread t's channels are 8 (t % (C / 8)) on
template <int ACT, bool RES, typename P>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    bn_act_cl(const uint4* __restrict__ x, const uint4* __restrict__ r, uint4* __restrict__ y,
              const P* __restrict__ mean, const P* __restrict__ var, const P* __restrict__ w,
              const P* __restrict__ b, float eps, int C, int64_t nv) {
  extern __shared__ float sh[];
  load_params(sh, mean, var, w, b, eps, C);
  const int64_t step = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int c0 = static_cast<int>(t % (C / 8)) * 8;
  float pm[8], ps[8], pb[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    pm[e] = sh[c0 + e];
    ps[e] = sh[C + c0 + e];
    pb[e] = sh[2 * C + c0 + e];
  }
  constexpr int unroll = UNROLL<RES>;
  for (int64_t i0 = t; i0 < nv; i0 += step * unroll) {
    uint4 v[unroll], rv[unroll];
#pragma unroll
    for (int u = 0; u < unroll; ++u) {
      const int64_t i = i0 + u * step;
      if (i < nv) {
        v[u] = __ldcs(x + i);
        if constexpr (RES) rv[u] = __ldcs(r + i);
      }
    }
#pragma unroll
    for (int u = 0; u < unroll; ++u) {
      const int64_t i = i0 + u * step;
      if (i < nv) {
        float f[8], fr[8];
        unpack(v[u], f);
        if constexpr (RES) unpack(rv[u], fr);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          f[e] = epilogue<ACT, RES>(f[e], pm[e], ps[e], pb[e], RES ? fr[e] : 0.0f);
        y[i] = pack(f);
      }
    }
  }
}

// NCHW, H W % 8 == 0: vector i lies in channel (i / hwv) % C, hwv = H W / 8
template <int ACT, bool RES, typename P>
__global__ void __launch_bounds__(THREADS)
    bn_act_nchw(const uint4* __restrict__ x, const uint4* __restrict__ r, uint4* __restrict__ y,
                const P* __restrict__ mean, const P* __restrict__ var, const P* __restrict__ w,
                const P* __restrict__ b, float eps, int C, int64_t hwv, int64_t nv) {
  extern __shared__ float sh[];
  load_params(sh, mean, var, w, b, eps, C);
  const int64_t step = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; i < nv; i += step) {
    const int c = static_cast<int>((i / hwv) % C);
    const float m = sh[c], s = sh[C + c], bb = sh[2 * C + c];
    float f[8], fr[8];
    unpack(__ldcs(x + i), f);
    if constexpr (RES) unpack(__ldcs(r + i), fr);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = epilogue<ACT, RES>(f[e], m, s, bb, RES ? fr[e] : 0.0f);
    y[i] = pack(f);
  }
}

// one value at a time: channel j % C (channels_last) or (j / hw) % C
template <int ACT, bool RES, typename P>
__global__ void __launch_bounds__(THREADS)
    bn_act_scalar(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ r,
                  __nv_bfloat16* __restrict__ y, const P* __restrict__ mean,
                  const P* __restrict__ var, const P* __restrict__ w, const P* __restrict__ b,
                  float eps, int C, int64_t hw, int channels_last, int64_t n) {
  extern __shared__ float sh[];
  load_params(sh, mean, var, w, b, eps, C);
  const int64_t step = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; j < n; j += step) {
    const int c = static_cast<int>(channels_last ? j % C : (j / hw) % C);
    y[j] = __float2bfloat16_rn(epilogue<ACT, RES>(to_f32(x[j]), sh[c], sh[C + c], sh[2 * C + c],
                                                  RES ? to_f32(r[j]) : 0.0f));
  }
}

template <int ACT, bool RES, typename P>
int launch(const void* x, const void* r, void* y, const void* mean, const void* var,
           const void* w, const void* b, float eps, int B, int C, int HW, int channels_last,
           int grid, cudaStream_t s) {
  const P* pm = static_cast<const P*>(mean);
  const P* pv = static_cast<const P*>(var);
  const P* pw = static_cast<const P*>(w);
  const P* pb = static_cast<const P*>(b);
  const size_t smem = 3 * static_cast<size_t>(C) * sizeof(float);
  const int64_t n = static_cast<int64_t>(B) * C * HW;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                        reinterpret_cast<uintptr_t>(r)) % 16 == 0;
  const auto* xv = static_cast<const uint4*>(x);
  const auto* rv = static_cast<const uint4*>(r);
  auto* yv = static_cast<uint4*>(y);
  if (aligned && channels_last && C % 8 == 0)
    bn_act_cl<ACT, RES, P><<<grid, THREADS, smem, s>>>(xv, rv, yv, pm, pv, pw, pb, eps, C, n / 8);
  else if (aligned && !channels_last && HW % 8 == 0)
    bn_act_nchw<ACT, RES, P>
        <<<grid, THREADS, smem, s>>>(xv, rv, yv, pm, pv, pw, pb, eps, C, HW / 8, n / 8);
  else
    bn_act_scalar<ACT, RES, P><<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(r),
        static_cast<__nv_bfloat16*>(y), pm, pv, pw, pb, eps, C, HW, channels_last, n);
  return static_cast<int>(cudaGetLastError());
}

template <int ACT, bool RES>
int dispatch_params(int params_bf16, const void* x, const void* r, void* y, const void* mean,
                    const void* var, const void* w, const void* b, float eps, int B, int C,
                    int HW, int channels_last, int grid, cudaStream_t s) {
  return params_bf16 ? launch<ACT, RES, __nv_bfloat16>(x, r, y, mean, var, w, b, eps, B, C, HW,
                                                       channels_last, grid, s)
                     : launch<ACT, RES, float>(x, r, y, mean, var, w, b, eps, B, C, HW,
                                               channels_last, grid, s);
}

}  // namespace

// x, y and residual (NULL for none): bf16 (B, C, H, W), channels_last
// (channels_last 1) or contiguous NCHW, all three in the same layout; mean,
// var, weight, bias: (C,), all bf16 (params_bf16) or all f32; act 0 is
// LeakyReLU(0.1), 1 SiLU. grid: the blocks of the launch; on channels_last
// maps with C % 8 == 0, grid * 256 must be a multiple of C / 8.
UAVDET_EXPORT int uavdet_bn_act(const void* x, const void* residual, void* y, const void* mean,
                                const void* var, const void* weight, const void* bias,
                                int params_bf16, float eps, int act, int B, int C, int HW,
                                int channels_last, int grid, void* stream) {
  if (B < 1 || C < 1 || C > MAX_C || HW < 1 || grid < 1 || (act != LEAKY_RELU && act != SILU) ||
      (channels_last && C % 8 == 0 && (static_cast<int64_t>(grid) * THREADS) % (C / 8) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool res = residual != nullptr;
  if (act == LEAKY_RELU)
    return res ? dispatch_params<LEAKY_RELU, true>(params_bf16, x, residual, y, mean, var, weight,
                                                   bias, eps, B, C, HW, channels_last, grid, s)
               : dispatch_params<LEAKY_RELU, false>(params_bf16, x, residual, y, mean, var,
                                                    weight, bias, eps, B, C, HW, channels_last,
                                                    grid, s);
  return res ? dispatch_params<SILU, true>(params_bf16, x, residual, y, mean, var, weight, bias,
                                           eps, B, C, HW, channels_last, grid, s)
             : dispatch_params<SILU, false>(params_bf16, x, residual, y, mean, var, weight, bias,
                                            eps, B, C, HW, channels_last, grid, s);
}
