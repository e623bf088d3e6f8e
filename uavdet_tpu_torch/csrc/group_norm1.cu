// GroupNorm with one group (nn.GroupNorm(1, C)) in inference, for Hopper
// (sm_90a): RTMUAVDet's MDyEncoder normalises each sample of an NCHW map by
// the mean and the biased variance of all its C * H * W values, then applies
// the per-channel affine:
//     y[b, c, p] = (x[b, c, p] - mean[b]) * (rstd[b] * gamma[c]) + beta[c]
// with rstd = rsqrt(var + eps). x, gamma, beta and y are all bf16 or all f32;
// moments, normalisation and affine are f32, the store rounds once.
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA. It was
// added because PyTorch's CUDA GroupNorm computes a sample's moments in one
// block per (sample, group): at RTMUAVDet's served batch of 8 that is 8 blocks
// on 132 SMs, each walking 2.5 M or 4.9 M values alone, 11.7 of the 19.3 ms of
// a call.
//
// What bounds it on this card: bytes. A norm reads each value and writes it
// once at best: 157 MB at (8, 192, 160, 160) in bf16, 0.047 ms at 3.35 TB/s,
// and some 10 operations per value are far below the f32 rate.
//
// Design: two kernels on the caller's stream, one entry. A sample is cut into
// S chunks of a multiple of 8 values (S from the wrapper: enough blocks to
// fill every SM several times, each chunk some thousands of values at
// least); a block of 256 threads takes one (chunk, sample).
//   gn1_moments: 16-byte loads, four in flight per thread; a thread takes the
//     f32 mean and M2 of each group of up to 32 values it loaded (two passes
//     over registers) and merges it into its (n, mean, M2) by Chan's formula;
//     warps and then the block merge the same way in a fixed order, and the
//     block writes its triple to the workspace (B, S, 3). No atomics: the
//     result is the same in every run.
//   gn1_apply: warp 0 of every block merges its sample's S triples in the
//     same fixed order, so every block of a sample gets the same mean and
//     rstd, while the block's first loads are in flight; then it writes y in
//     16-byte stores. Where H * W is a multiple of 8, a vector of 8 values
//     lies in one channel and takes one gamma and beta; otherwise both
//     kernels take a scalar path. The apply walks each chunk from its end,
//     where the moments pass ended, so that what the L2 cache still holds of
//     the map is read first: 0.089 against 0.094 ms at (8, 192, 160, 160)
//     and 0.044 against 0.046 ms at (8, 384, 80, 80) walked forward, by the
//     profiler on an NVIDIA H100 80GB HBM3 at 700 W.
// The map is read twice where the floor reads it once: merging the moments
// into the producers of x (a cat, a residual add) would cross the model's
// sections.
#include <climits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;   // 16-byte loads in flight per thread
constexpr unsigned FULL = 0xffffffffu;

// count, mean and sum of squared deviations of a set of values
struct Moments {
  float n, mean, m2;
};

// Chan et al.'s pairwise merge; an empty side (n = 0) leaves the other as it
// is, and two empty sides give an empty one.
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  const float n = a.n + b.n;
  const float r = b.n / fmaxf(n, 1.0f);
  const float d = b.mean - a.mean;
  return {n, fmaf(d, r, a.mean), a.m2 + b.m2 + d * d * a.n * r};
}

// lane 0 ends with the merge of the warp's 32 states, in a fixed tree
__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Moments o{__shfl_down_sync(FULL, m.n, off),
                    __shfl_down_sync(FULL, m.mean, off),
                    __shfl_down_sync(FULL, m.m2, off)};
    m = merge(m, o);
  }
  return m;
}

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& v, float (&f)[N]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(p[j]);
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  }
  __device__ static uint4 pack(const float (&f)[N]) {
    return make_uint4(uavdet::pack_bf16x2(f[0], f[1]), uavdet::pack_bf16x2(f[2], f[3]),
                      uavdet::pack_bf16x2(f[4], f[5]), uavdet::pack_bf16x2(f[6], f[7]));
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& v, float (&f)[N]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// the block's (chunk, sample): values [start, end) of sample b
struct Chunk {
  int start, end;
};

__device__ __forceinline__ Chunk chunk_of(int n, int chunk) {
  const int64_t start = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t end = start + chunk;
  return {static_cast<int>(start < n ? start : n), static_cast<int>(end < n ? end : n)};
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
    gn1_moments(const T* __restrict__ x, float* __restrict__ ws, int n, int chunk) {
  const Chunk ck = chunk_of(n, chunk);
  const T* xs = x + static_cast<int64_t>(blockIdx.y) * n;
  Moments acc{0.0f, 0.0f, 0.0f};
  if constexpr (VECTOR) {
    using V = Vec<T>;
    const int nv = (ck.end - ck.start) / V::N;
    const uint4* xv = reinterpret_cast<const uint4*>(xs + ck.start);
    for (int i0 = threadIdx.x; i0 < nv; i0 += THREADS * UNROLL) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * THREADS;
        v[u] = i < nv ? __ldg(xv + i) : make_uint4(0, 0, 0, 0);
      }
      // the valid vectors are a prefix of the group; the others read zero
      const int k = min(UNROLL, (nv - i0 + THREADS - 1) / THREADS);
      float f[UNROLL][V::N];
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        V::unpack(v[u], f[u]);
#pragma unroll
        for (int e = 0; e < V::N; ++e) sum += f[u][e];
      }
      const float cnt = static_cast<float>(k * V::N);
      const float mean = sum / cnt;
      float m2 = 0.0f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (u < k) {
#pragma unroll
          for (int e = 0; e < V::N; ++e) {
            const float d = f[u][e] - mean;
            m2 = fmaf(d, d, m2);
          }
        }
      }
      acc = merge(acc, {cnt, mean, m2});
    }
  } else {
    for (int i = ck.start + threadIdx.x; i < ck.end; i += THREADS)
      acc = merge(acc, {1.0f, to_f32(xs[i]), 0.0f});
  }
  __shared__ float sh[3][WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  acc = warp_merge(acc);
  if (lane == 0) {
    sh[0][warp] = acc.n;
    sh[1][warp] = acc.mean;
    sh[2][warp] = acc.m2;
  }
  __syncthreads();
  if (warp == 0) {
    Moments m{0.0f, 0.0f, 0.0f};
    if (lane < WARPS) m = {sh[0][lane], sh[1][lane], sh[2][lane]};
    m = warp_merge(m);
    if (lane == 0) {
      float* w = ws + (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * 3;
      w[0] = m.n;
      w[1] = m.mean;
      w[2] = m.m2;
    }
  }
}

// The apply's loads of one group: vector i0 + u * THREADS for each u,
// counted from the chunk's end, zero past the chunk.
__device__ __forceinline__ void load_group(const uint4* xv, int nv, int i0, uint4 (&v)[UNROLL]) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = i0 + u * THREADS;
    v[u] = i < nv ? __ldcs(xv + nv - 1 - i) : make_uint4(0, 0, 0, 0);
  }
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
    gn1_apply(const T* __restrict__ x, const T* __restrict__ gamma,
              const T* __restrict__ beta, T* __restrict__ y, const float* __restrict__ ws, int n,
              int hw, int chunk, float eps) {
  using V = Vec<T>;
  const Chunk ck = chunk_of(n, chunk);
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n;
  const int nv = (ck.end - ck.start) / V::N;
  const uint4* xv = reinterpret_cast<const uint4*>(x + base + ck.start);
  uint4 v[UNROLL];
  if constexpr (VECTOR) load_group(xv, nv, threadIdx.x, v);

  __shared__ float stats[2];
  if (threadIdx.x < 32) {
    const float* w = ws + static_cast<int64_t>(blockIdx.y) * gridDim.x * 3;
    Moments m{0.0f, 0.0f, 0.0f};
    for (int j = threadIdx.x; j < gridDim.x; j += 32)
      m = merge(m, {w[3 * j], w[3 * j + 1], w[3 * j + 2]});
    m = warp_merge(m);
    if (threadIdx.x == 0) {
      stats[0] = m.mean;
      stats[1] = rsqrtf(m.m2 / m.n + eps);   // the biased variance, as nn.GroupNorm's
    }
  }
  __syncthreads();
  const float mean = stats[0], rstd = stats[1];

  if constexpr (VECTOR) {
    uint4* yv = reinterpret_cast<uint4*>(y + base + ck.start);
    for (int i0 = threadIdx.x; i0 < nv; i0 += THREADS * UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * THREADS;
        if (i < nv) {
          const int j = nv - 1 - i;
          const int c = (ck.start + j * V::N) / hw;   // hw % 8 == 0: one channel
          const float g = rstd * to_f32(gamma[c]), bb = to_f32(beta[c]);
          float f[V::N];
          V::unpack(v[u], f);
#pragma unroll
          for (int e = 0; e < V::N; ++e) f[e] = fmaf(f[e] - mean, g, bb);
          yv[j] = V::pack(f);
        }
      }
      load_group(xv, nv, i0 + THREADS * UNROLL, v);
    }
  } else {
    for (int i = ck.start + threadIdx.x; i < ck.end; i += THREADS) {
      const int c = i / hw;
      store(y + base + i,
            fmaf(to_f32(x[base + i]) - mean, rstd * to_f32(gamma[c]), to_f32(beta[c])));
    }
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y, void* ws, int B, int C,
           int HW, int S, float eps, void* stream) {
  const int64_t n64 = static_cast<int64_t>(C) * HW;
  const int64_t chunk64 = S < 1 ? 0 : ((n64 + S - 1) / S + 7) / 8 * 8;
  if (B < 1 || B > 65535 || C < 1 || HW < 1 || S < 1 || n64 > INT_MAX - 7)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(n64), chunk = static_cast<int>(chunk64);
  const bool vector = HW % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(S, B);
  const T* xt = static_cast<const T*>(x);
  float* wsf = static_cast<float*>(ws);
  if (vector)
    gn1_moments<T, true><<<grid, THREADS, 0, s>>>(xt, wsf, n, chunk);
  else
    gn1_moments<T, false><<<grid, THREADS, 0, s>>>(xt, wsf, n, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* g = static_cast<const T*>(gamma);
  const T* b = static_cast<const T*>(beta);
  T* yt = static_cast<T*>(y);
  if (vector)
    gn1_apply<T, true><<<grid, THREADS, 0, s>>>(xt, g, b, yt, wsf, n, HW, chunk, eps);
  else
    gn1_apply<T, false><<<grid, THREADS, 0, s>>>(xt, g, b, yt, wsf, n, HW, chunk, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (B, C, HW) contiguous, bf16 (x_is_bf16) or f32; gamma, beta: (C,) of
// the same type; workspace: (B, S, 3) f32, written by the first kernel and read
// by the second. The chunks of a sample are ceil(C HW / S) values rounded up to
// a multiple of 8; C HW must fit an int.
UAVDET_EXPORT int uavdet_group_norm1(const void* x, int x_is_bf16, const void* gamma,
                                     const void* beta, void* y, void* workspace, int B, int C,
                                     int HW, int S, float eps, void* stream) {
  return x_is_bf16
             ? launch<__nv_bfloat16>(x, gamma, beta, y, workspace, B, C, HW, S, eps, stream)
             : launch<float>(x, gamma, beta, y, workspace, B, C, HW, S, eps, stream);
}
