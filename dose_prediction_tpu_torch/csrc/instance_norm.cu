// K2: InstanceNorm3d over each (n, c) plane of an NCDHW tensor, then the
// affine and an activation: y = act(((x - mean) * rsqrt(var + eps)) * scale
// + bias), float32 arithmetic, output in the input dtype.
//
// Replaces dose_prediction_tpu/kernels/instance_norm.py::instance_norm_act
// (the Pallas kernel at :32, launched at :83), whose sequential grid carries
// one-pass sum and sum of squares in VMEM scratch from one chunk to the next.
//
// What bounds it on the H100: about 2 operations per element against 4
// (bfloat16) or 8 (float32) bytes read and written, so memory bandwidth
// bounds it. The least traffic is one read and one write of the volume; this
// two-pass design reads it twice (the statistics must be complete before any
// element is normalized, and a 128^3 plane does not fit on chip).
//
// Design: blocks run in no order on the card, so nothing carries between
// them. Each plane of D*H*W contiguous elements is cut into chunks, so a
// (1, 16, 128^3) tensor gives 4096 blocks rather than 16.
// Pass 1: one block per (chunk, plane) sums (x - shift) and its square in
// float32, the shift being the chunk's first element, turns them into a
// per-thread (count, mean, M2) and merges those across the block with Chan's
// formula; it writes the chunk's (mean, M2). This is a two-pass-accurate
// variance, not the Pallas kernel's one-pass E[x^2] - mean^2.
// Pass 2: one block per (chunk, plane) merges its plane's chunk partials
// (the combine step, one warp), then normalizes, applies the affine and the
// activation and stores.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// activation codes passed from Python (kernels/instance_norm.py ACT_CODES)
enum Act : int { kIdentity = 0, kRelu = 1, kLeakyRelu = 2, kMish = 3, kGelu = 4 };

struct Moments {
  float n, mean, m2;
};

__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  return {n, a.mean + d * (b.n / n), a.m2 + b.m2 + d * d * (a.n * b.n / n)};
}

__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Moments o{__shfl_down_sync(0xffffffffu, m.n, off),
              __shfl_down_sync(0xffffffffu, m.mean, off),
              __shfl_down_sync(0xffffffffu, m.m2, off)};
    m = merge(m, o);
  }
  return m;  // lane 0 holds the warp's total
}

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case kRelu: return fmaxf(y, 0.f);
    case kLeakyRelu: return y >= 0.f ? y : 0.01f * y;
    case kMish: {
      const float sp = fmaxf(y, 0.f) + log1pf(expf(-fabsf(y)));  // stable softplus
      return y * tanhf(sp);
    }
    case kGelu: return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
    default: return y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ x, float2* __restrict__ part, int S, int chunk) {
  const int plane = blockIdx.y;
  const int start = blockIdx.x * chunk;
  const int end = min(start + chunk, S);
  const T* xp = x + (size_t)plane * S;
  const float shift = dpt::to_f32(xp[start]);
  float s1 = 0.f, s2 = 0.f, n = 0.f;
  for (int i = start + threadIdx.x; i < end; i += kThreads) {
    const float d = dpt::to_f32(xp[i]) - shift;
    s1 += d;
    s2 = fmaf(d, d, s2);
    n += 1.f;
  }
  Moments m{n, 0.f, 0.f};
  if (n > 0.f) {
    const float md = s1 / n;
    m.mean = shift + md;
    m.m2 = fmaxf(s2 - s1 * md, 0.f);
  }
  m = warp_merge(m);
  __shared__ Moments warp_total[kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_total[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_total[lane] : Moments{0.f, 0.f, 0.f};
    m = warp_merge(m);
    if (lane == 0) part[(size_t)plane * gridDim.x + blockIdx.x] = make_float2(m.mean, m.m2);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const float2* __restrict__ part,
             const float* __restrict__ scale, const float* __restrict__ bias,
             T* __restrict__ y, int channels, int S, int chunk, float eps, int act) {
  const int plane = blockIdx.y;
  const int nchunks = gridDim.x;
  __shared__ float s_mean, s_rstd;
  if (threadIdx.x < 32) {
    Moments m{0.f, 0.f, 0.f};
    for (int j = threadIdx.x; j < nchunks; j += 32) {
      const float2 p = part[(size_t)plane * nchunks + j];
      const float n = (float)min(chunk, S - j * chunk);
      m = merge(m, Moments{n, p.x, p.y});
    }
    m = warp_merge(m);
    if (threadIdx.x == 0) {
      s_mean = m.mean;
      s_rstd = rsqrtf(m.m2 / m.n + eps);
    }
  }
  __syncthreads();
  const float mean = s_mean, rstd = s_rstd;
  const int c = plane % channels;
  const float a = scale ? scale[c] : 1.f;
  const float b = bias ? bias[c] : 0.f;
  const int start = blockIdx.x * chunk;
  const int end = min(start + chunk, S);
  const size_t off = (size_t)plane * S;
  for (int i = start + threadIdx.x; i < end; i += kThreads) {
    const float v = (dpt::to_f32(x[off + i]) - mean) * rstd;
    y[off + i] = dpt::from_f32<T>(activate(v * a + b, act));
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, void* partials, const float* scale,
                   const float* bias, int planes, int channels, int S, int chunk, float eps,
                   int act, cudaStream_t stream) {
  dim3 grid((S + chunk - 1) / chunk, planes);
  stats_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                 static_cast<float2*>(partials), S, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  apply_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                 static_cast<const float2*>(partials), scale,
                                                 bias, static_cast<T*>(y), channels, S, chunk,
                                                 eps, act);
  return cudaGetLastError();
}

}  // namespace

// x, y: contiguous (planes / channels, channels, S) tensors of one dtype;
// partials: float32 scratch of 2 * planes * ceil(S / chunk) values; scale and
// bias: float32 (channels,) or null. Returns the cudaError_t of the launches.
extern "C" int dpt_instance_norm_fwd(const void* x, void* y, void* partials, const float* scale,
                                     const float* bias, int planes, int channels, int S,
                                     int chunk, float eps, int act, int dtype, void* stream) {
  if (planes <= 0 || planes > 65535 || channels <= 0 || S <= 0 || chunk <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dpt::kFloat32:
      return launch<float>(x, y, partials, scale, bias, planes, channels, S, chunk, eps, act, s);
    case dpt::kBFloat16:
      return launch<__nv_bfloat16>(x, y, partials, scale, bias, planes, channels, S, chunk, eps,
                                   act, s);
    default: return cudaErrorInvalidValue;
  }
}
