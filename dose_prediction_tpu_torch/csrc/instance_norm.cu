// K2: InstanceNorm3d over each (n, c) plane of an NCDHW tensor, then the
// affine and an activation: y = act(((x - mean) * rsqrt(var + eps)) * scale
// + bias), float32 arithmetic, output in the input dtype.
//
// Replaces dose_prediction_tpu/kernels/instance_norm.py::instance_norm_act
// (the Pallas kernel at :32, launched at :83), whose sequential grid carries
// one-pass sum and sum of squares in VMEM scratch from one chunk to the next
// and reads the volume twice.
//
// What bounds it on the H100: about 2 operations per element against 4
// (bfloat16) or 8 (float32) bytes read and written, so memory bandwidth
// bounds it, and the least traffic is one read and one write of the volume.
// The statistics must be complete before any element is normalized, and a
// plane is larger than one SM's storage (2^21 elements at 128^3), so the
// plane is cut into chunks, one per block, and the blocks of a plane meet.
//
// The single-read kernel (instance_norm_kernel), one launch per call:
// 1. Each block takes its task, a (plane, chunk), from a global ticket
//    counter (one atomicAdd, broadcast through shared memory), not from
//    blockIdx: tickets go out in order to blocks that are already running.
// 2. It loads its chunk into registers with 16-byte loads (8 bf16 or 4
//    float32; neighbouring threads on neighbouring words; the plane's last
//    chunk is ragged and masked), computes the chunk's (count, mean, M2)
//    (each thread two passes over its registers, then Chan's merge across
//    the block: a two-pass-accurate variance, not the Pallas kernel's
//    one-pass E[x^2] - mean^2), writes it to the partials, fences, and adds
//    one to its plane's arrival counter.
// 3. One thread polls the arrival counter (acquire loads, __nanosleep
//    between polls) until the plane's every chunk has arrived; the block
//    then merges the plane's partials (one per thread, read through L2 with
//    __ldcg) in a fixed order, so every block of a plane gets the same mean
//    and rstd.
// 4. It normalizes the values still in its registers, applies the affine
//    and the activation, and stores with 16-byte stores. HBM sees one read
//    and one write of the volume.
// A plane of one chunk skips 1 and 3: the block takes its plane from
// blockIdx and normalizes with its own moments.
//
// The chunk: each thread holds 8 sixteen-byte words (64 bf16 or 32 float32
// values; 32 values of either in the scalar-load instantiation), so a block
// has 32 KB of a bf16 or float32 plane in flight. A block's fixed latency
// (ticket, reduction, arrival, wait, merge) is paid once per chunk, and a
// larger chunk than the register file allows at 4 blocks per SM would
// cost the resident blocks the no-deadlock condition below needs.
//
// Why it cannot deadlock. A block waits only after it has arrived. Tickets
// are issued in order, and only to running blocks. Every plane whose last
// ticket has been issued completes: each of its blocks is running and
// arrives without waiting on anything. So the only plane that can hold
// blocks waiting is the one whose tickets are still being issued, and it
// holds at most (its chunk count - 1) of them; every other resident block
// finishes and frees its slot for the next ticket. The kernel is therefore
// safe whenever the card can hold as many resident blocks of it as one
// plane has chunks. The wrapper reads that number
// (dpt_instance_norm_capacity: the occupancy calculator's blocks per SM x
// the SM count) and takes this kernel only when a plane needs at most half
// of it, the other half being margin for other work on the card.
//
// The counters: one int ticket and one arrival int per plane, zeroed by a
// cudaMemsetAsync on the call's stream before the launch (a call is one
// memset and one kernel, or the kernel alone where planes are one chunk;
// both can be captured in a CUDA graph).
//
// The two-kernel path (stats_kernel, then apply_kernel), for a plane with
// more chunks than half the resident blocks: the wrapper picks it by shape,
// before any launch. The same chunk loads and moments; apply_kernel merges
// its plane's partials and reads its chunk a second time.
//
// A tensor whose data or plane size is not a multiple of 16 bytes goes
// through the scalar-load instantiation of the same kernels (kVector =
// false), chosen by the wrapper.
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// __launch_bounds__' minimum blocks per SM: at most 64 registers a thread,
// so that 4 x 132 resident blocks hold a 128^3 plane's 128 bf16 chunks of
// 16384 (256 float32 chunks of 8192) twice over
constexpr int kMinBlocks = 4;
// 16-byte words a thread holds in the vector instantiations, values in the
// scalar ones
constexpr int kWords = 8;
constexpr int kScalarItems = 32;
// polls of a plane's arrival counter, at least 256 ns apart, before a block
// gives up: over 4 s, where a plane's chunks arrive within microseconds
constexpr long long kMaxPolls = 1ll << 24;

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

// Merges every thread's moments; thread 0 returns the block's total.
__device__ __forceinline__ Moments block_merge(Moments m, Moments* warp_total) {
  m = warp_merge(m);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_total[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? warp_total[lane] : Moments{0.f, 0.f, 0.f};
    m = warp_merge(m);
  }
  return m;
}

__device__ __forceinline__ void set_stats(Moments m, float eps, float* mean, float* rstd) {
  *mean = m.mean;
  *rstd = rsqrtf(m.m2 / m.n + eps);
}

// The block merges a plane's chunk partials, each thread its share read
// through L2 (other blocks wrote them during this kernel), in an order fixed
// by the chunk count alone; thread 0 stores the plane's mean and rstd.
__device__ __forceinline__ void plane_stats(const float2* part, int nchunks, int chunk, int S,
                                            float eps, Moments* warp_total, float* mean,
                                            float* rstd) {
  Moments m{0.f, 0.f, 0.f};
  for (int j = threadIdx.x; j < nchunks; j += kThreads) {
    const float2 p = __ldcg(part + j);
    m = merge(m, Moments{(float)min(chunk, S - j * chunk), p.x, p.y});
  }
  m = block_merge(m, warp_total);
  if (threadIdx.x == 0) set_stats(m, eps, mean, rstd);
}

template <int kAct>
__device__ __forceinline__ float activate(float y) {
  if constexpr (kAct == kRelu) return fmaxf(y, 0.f);
  if constexpr (kAct == kLeakyRelu) return y >= 0.f ? y : 0.01f * y;
  if constexpr (kAct == kMish) {
    const float sp = fmaxf(y, 0.f) + log1pf(expf(-fabsf(y)));  // stable softplus
    return y * tanhf(sp);
  }
  if constexpr (kAct == kGelu) return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
  return y;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// adds v with release semantics: this thread's earlier writes are visible
// to whoever acquires the new value
__device__ __forceinline__ void add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// 16 bytes of T as floats and back (round to nearest even, as torch's cast).
template <typename T>
struct Pack16;

template <>
struct Pack16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Pack16<__nv_bfloat16> {
  static constexpr int kN = 8;
  // element 2k is the low half of word k (little-endian)
  __device__ __forceinline__ static void unpack(const uint4& r, float (&f)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint32_t two(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // one cvt for the pair
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[8]) {
    return make_uint4(two(f[0], f[1]), two(f[2], f[3]), two(f[4], f[5]), two(f[6], f[7]));
  }
};

// One block's chunk of a plane in registers: slot j of thread t holds the
// kVec elements from (j * kThreads + t) * kVec, so neighbouring threads
// touch neighbouring words. A chunk is kThreads * kSlots * kVec elements;
// the plane's last one may be shorter (len), and slots past it stay unused.
template <typename T, bool kVector>
struct Tile {
  static constexpr int kVec = kVector ? Pack16<T>::kN : 1;
  static constexpr int kSlots = kVector ? kWords : kScalarItems;
  static constexpr int kChunk = kThreads * kSlots * kVec;
  using Raw = typename std::conditional<kVector, uint4, T>::type;
  Raw raw[kSlots];

  __device__ __forceinline__ static int index(int j) { return j * kThreads + threadIdx.x; }

  __device__ __forceinline__ void load(const T* __restrict__ p, int len) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (index(j) * kVec < len) raw[j] = reinterpret_cast<const Raw*>(p)[index(j)];
  }

  __device__ __forceinline__ void values(int j, float (&f)[kVec]) const {
    if constexpr (kVector) Pack16<T>::unpack(raw[j], f);
    else f[0] = dpt::to_f32(raw[j]);
  }

  // this thread's (count, mean, M2): the mean, then the squared deviations
  __device__ __forceinline__ Moments moments(int len) const {
    float n = 0.f, s = 0.f, f[kVec];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (index(j) * kVec < len) {
        values(j, f);
#pragma unroll
        for (int k = 0; k < kVec; ++k) s += f[k];
        n += kVec;
      }
    }
    if (n == 0.f) return {0.f, 0.f, 0.f};
    const float mean = s / n;
    float m2 = 0.f;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (index(j) * kVec < len) {
        values(j, f);
#pragma unroll
        for (int k = 0; k < kVec; ++k) m2 = fmaf(f[k] - mean, f[k] - mean, m2);
      }
    }
    return {n, mean, m2};
  }

  // y = act((x - mean) * (rstd * scale) + bias), one switch on the
  // activation per block rather than per element
  __device__ __forceinline__ void store(T* __restrict__ p, int len, float mean, float rstd,
                                        float a, float b, int act) const {
    switch (act) {
      case kRelu: return store_act<kRelu>(p, len, mean, rstd * a, b);
      case kLeakyRelu: return store_act<kLeakyRelu>(p, len, mean, rstd * a, b);
      case kMish: return store_act<kMish>(p, len, mean, rstd * a, b);
      case kGelu: return store_act<kGelu>(p, len, mean, rstd * a, b);
      default: return store_act<kIdentity>(p, len, mean, rstd * a, b);
    }
  }

  template <int kAct>
  __device__ __forceinline__ void store_act(T* __restrict__ p, int len, float mean, float a,
                                            float b) const {
    float f[kVec];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (index(j) * kVec < len) {
        values(j, f);
#pragma unroll
        for (int k = 0; k < kVec; ++k) f[k] = activate<kAct>(fmaf(f[k] - mean, a, b));
        if constexpr (kVector) reinterpret_cast<uint4*>(p)[index(j)] = Pack16<T>::pack(f);
        else p[index(j)] = dpt::from_f32<T>(f[0]);
      }
    }
  }
};

template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
instance_norm_kernel(const T* __restrict__ x, T* __restrict__ y, float2* part, int* counters,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     int channels, int S, int nchunks, float eps, int act) {
  constexpr int kChunk = Tile<T, kVector>::kChunk;
  __shared__ int s_task;
  __shared__ Moments warp_total[kWarps];
  __shared__ float s_mean, s_rstd;
  if (nchunks > 1) {
    if (threadIdx.x == 0) s_task = atomicAdd(counters, 1);
    __syncthreads();
  }
  const int task = nchunks > 1 ? s_task : blockIdx.x;
  const int plane = task / nchunks, c = task - plane * nchunks;
  const int start = c * kChunk, len = min(kChunk, S - start);
  const size_t off = (size_t)plane * S + start;
  Tile<T, kVector> tile;
  tile.load(x + off, len);
  const Moments m = block_merge(tile.moments(len), warp_total);
  if (nchunks == 1) {
    if (threadIdx.x == 0) set_stats(m, eps, &s_mean, &s_rstd);
  } else {
    if (threadIdx.x == 0) {
      part[(size_t)plane * nchunks + c] = make_float2(m.mean, m.m2);
      int* arrived = counters + 1 + plane;
      add_release(arrived, 1);  // the partial is visible before the arrival
      unsigned ns = 32;
      for (long long polls = 0; load_acquire(arrived) < nchunks; ++polls) {
        if (polls == kMaxPolls) __trap();  // a broken invariant: fail, do not hang
        __nanosleep(ns);
        ns = min(2 * ns, 256u);
      }
    }
    __syncthreads();
    plane_stats(part + (size_t)plane * nchunks, nchunks, kChunk, S, eps, warp_total, &s_mean,
                &s_rstd);
  }
  __syncthreads();
  const int ch = plane % channels;
  tile.store(y + off, len, s_mean, s_rstd, scale ? scale[ch] : 1.f, bias ? bias[ch] : 0.f, act);
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stats_kernel(const T* __restrict__ x, float2* __restrict__ part, int S, int nchunks) {
  constexpr int kChunk = Tile<T, kVector>::kChunk;
  __shared__ Moments warp_total[kWarps];
  const int plane = blockIdx.x / nchunks, c = blockIdx.x - plane * nchunks;
  const int start = c * kChunk, len = min(kChunk, S - start);
  Tile<T, kVector> tile;
  tile.load(x + (size_t)plane * S + start, len);
  const Moments m = block_merge(tile.moments(len), warp_total);
  if (threadIdx.x == 0) part[blockIdx.x] = make_float2(m.mean, m.m2);
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
apply_kernel(const T* __restrict__ x, const float2* __restrict__ part,
             const float* __restrict__ scale, const float* __restrict__ bias,
             T* __restrict__ y, int channels, int S, int nchunks, float eps, int act) {
  constexpr int kChunk = Tile<T, kVector>::kChunk;
  __shared__ Moments warp_total[kWarps];
  __shared__ float s_mean, s_rstd;
  const int plane = blockIdx.x / nchunks, c = blockIdx.x - plane * nchunks;
  const int start = c * kChunk, len = min(kChunk, S - start);
  const size_t off = (size_t)plane * S + start;
  Tile<T, kVector> tile;
  tile.load(x + off, len);
  plane_stats(part + (size_t)plane * nchunks, nchunks, kChunk, S, eps, warp_total, &s_mean,
              &s_rstd);
  __syncthreads();
  const int ch = plane % channels;
  tile.store(y + off, len, s_mean, s_rstd, scale ? scale[ch] : 1.f, bias ? bias[ch] : 0.f, act);
}

template <typename T, bool V>
struct Config {
  using type = T;
  static constexpr bool kVector = V;
};

// Calls f(Config<T, vector>{}) for the call's dtype.
template <typename F>
cudaError_t dispatch(int dtype, int vector, F& f) {
  switch (dtype) {
    case dpt::kFloat32:
      return vector ? f(Config<float, true>{}) : f(Config<float, false>{});
    case dpt::kBFloat16:
      return vector ? f(Config<__nv_bfloat16, true>{}) : f(Config<__nv_bfloat16, false>{});
    default: return cudaErrorInvalidValue;
  }
}

struct Capacity {
  int* chunk;
  int* blocks;
  template <typename C>
  cudaError_t operator()(C) const {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, instance_norm_kernel<typename C::type, C::kVector>, kThreads, 0);
    *chunk = Tile<typename C::type, C::kVector>::kChunk;
    *blocks = per_sm * sms;
    return err;
  }
};

struct Launch {
  const void* x;
  void* y;
  void* partials;
  void* counters;
  const float *scale, *bias;
  int planes, channels, S, chunk;
  float eps;
  int act, single_read;
  cudaStream_t stream;

  template <typename C>
  cudaError_t operator()(C) const {
    using T = typename C::type;
    constexpr bool V = C::kVector;
    if (chunk != Tile<T, V>::kChunk) return cudaErrorInvalidValue;
    const long long nchunks = (S + (long long)chunk - 1) / chunk;
    if (nchunks * planes > 0x7fffffffLL) return cudaErrorInvalidValue;
    const int n = (int)nchunks, grid = planes * n;
    const T* xt = static_cast<const T*>(x);
    T* yt = static_cast<T*>(y);
    float2* part = static_cast<float2*>(partials);
    if (single_read) {
      int* cnt = static_cast<int*>(counters);
      if (n > 1) {
        cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int) * (1 + (size_t)planes), stream);
        if (err != cudaSuccess) return err;
      }
      instance_norm_kernel<T, V><<<grid, kThreads, 0, stream>>>(xt, yt, part, cnt, scale, bias,
                                                                channels, S, n, eps, act);
      return cudaGetLastError();
    }
    stats_kernel<T, V><<<grid, kThreads, 0, stream>>>(xt, part, S, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    apply_kernel<T, V><<<grid, kThreads, 0, stream>>>(xt, part, scale, bias, yt, channels, S, n,
                                                      eps, act);
    return cudaGetLastError();
  }
};

}  // namespace

// The chunk (elements of a plane per block) of the instantiation for
// (dtype, vector) and how many of its single-read blocks the current device
// holds resident at once. Returns a cudaError_t.
extern "C" int dpt_instance_norm_capacity(int dtype, int vector, int* chunk, int* blocks) {
  if (chunk == nullptr || blocks == nullptr) return cudaErrorInvalidValue;
  Capacity f{chunk, blocks};
  return dispatch(dtype, vector, f);
}

// x, y: contiguous (planes / channels, channels, S) tensors of one dtype;
// with vector != 0 both 16-byte aligned and S * sizeof(dtype) a multiple of
// 16. chunk: the instantiation's (dpt_instance_norm_capacity). partials:
// float32 scratch of 2 * planes * ceil(S / chunk) values; counters: 1 +
// planes ints for the single-read path (zeroed here), unused by the
// two-kernel path. scale and bias: float32 (channels,) or null. Returns the
// cudaError_t of the memset and launches.
extern "C" int dpt_instance_norm_fwd(const void* x, void* y, void* partials, void* counters,
                                     const float* scale, const float* bias, int planes,
                                     int channels, int S, int chunk, float eps, int act,
                                     int dtype, int vector, int single_read, void* stream) {
  if (planes <= 0 || channels <= 0 || S <= 0 || (single_read && !counters))
    return cudaErrorInvalidValue;
  Launch f{x,      y,        partials, counters, scale, bias,        planes,
           channels, S, chunk, eps, act, single_read, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, vector, f);
}
