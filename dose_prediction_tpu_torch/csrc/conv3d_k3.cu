// K3: direct 3x3x3 convolution, stride 1, dilation 1, zero padding 1, with
// C_in == C_out = C in {16, 32, 64}, on NCDHW tensors: float32 accumulation,
// then the JAX kernel's rounding (conv3d.py:137-141): in bfloat16 the sum is
// rounded to bf16, the float32 bias is added in float32 and the result is
// rounded again; in float32 the bias is added to the sum.
//
// Replaces dose_prediction_tpu/kernels/conv3d.py::conv3d_k3 (the Pallas
// kernel `_kernel` at :60, launched by `pl.pallas_call` at :119). That kernel
// packs W*C into 128 lanes and multiplies against a banded weight matrix
// (`_expand_weights` :38) so that the TPU's 128x128 matrix unit runs dense;
// it needs W % (128 / C) == 0 and loops over samples in Python. None of that
// is carried over: this kernel takes any N, D, H and W and masks the edges.
//
// What bounds it on the H100: 2 * 27 * C^2 operations per voxel against 2 * C
// elements moved (x read once, y written once). In bfloat16 that is 27 * C
// operations per byte: 432 at C = 16 (bytes and operations about even at the
// card's 295), 864 and 1728 at C = 32 and 64 (operations bound). In float32
// the non-tensor 67 TFLOP/s bound it at every C.
//
// Design (an implicit GEMM, simple first): M is a tile of 8 x 16 output
// voxels of one (n, d) row, N is the C output channels, K is 27 * C. A block
// stages one input depth plane of the tile with its halo, (8+2) x (16+2)
// positions x C channels, channels innermost, in shared memory, then the
// weights of the three kw taps of one (kd, kh) at a time: all 27 taps do not
// fit at C = 64 (221 KB in bfloat16, twice that in float32), three take at
// most 27 KB (bf16) or 49 KB (f32). Depth planes outside the volume are
// skipped (they add zeros).
// - bfloat16: the products run on the tensor cores with mma.sync m16n8k16
//   (bf16 in, float32 accumulate). Warp i owns output row i of the tile, one
//   16-voxel m-tile, and all C / 8 n-tiles. Rows of both tiles are padded by
//   8 elements so that the fragment loads hit distinct banks.
// - float32: plain FMAs in full float32 (no TF32), so the result matches the
//   plain version up to summation order. Thread t owns voxel t % 128 and half
//   of the output channels; weight rows are read as float4 broadcasts.
// No wgmma, TMA or pipelining yet: staging and compute alternate.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTH = 8;   // output rows (h) per block
constexpr int kTW = 16;  // output columns (w) per block
constexpr int kHW = kTW + 2;
constexpr int kPos = (kTH + 2) * kHW;  // halo tile positions
constexpr int kThreads = 256;

struct Geometry {
  int D, H, W, tiles_w;
};

// One input depth plane of the block's halo tile, channels innermost:
// xs[pos * LDX + c]. Positions outside the volume are zero.
template <typename S, int C, int LDX>
__device__ __forceinline__ void stage_plane(const S* __restrict__ x, S* xs, int n, int din,
                                            int h0, int w0, const Geometry& g, S zero) {
  const size_t plane = (size_t)g.H * g.W;
  for (int i = threadIdx.x; i < C * kPos; i += kThreads) {
    const int c = i / kPos, r = i - c * kPos;
    const int hh = r / kHW, ww = r - hh * kHW;
    const int h = h0 + hh - 1, w = w0 + ww - 1;
    S v = zero;
    if (h >= 0 && h < g.H && w >= 0 && w < g.W)
      v = x[(((size_t)n * C + c) * g.D + din) * plane + (size_t)h * g.W + w];
    xs[r * LDX + c] = v;
  }
}

// The three kw taps of one (kd, kh): ws[(kw * C + ci) * LDW + co] from the
// (27, C_in, C_out) weights, tap = (kd * 3 + kh) * 3 + kw.
template <typename S, int C, int LDW>
__device__ __forceinline__ void stage_weights(const S* __restrict__ wt, S* ws, int tap0) {
  const S* src = wt + (size_t)tap0 * C * C;
  for (int i = threadIdx.x; i < 3 * C * C; i += kThreads) {
    const int row = i / C, co = i - row * C;  // row = kw * C + ci
    ws[row * LDW + co] = src[i];
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
conv3d_k3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                     const float* __restrict__ bias, float* __restrict__ y, Geometry g) {
  constexpr int LDX = C + 1;  // odd stride: lanes on consecutive voxels, distinct banks
  constexpr int LDW = C;
  constexpr int CPT = C / 2;  // output channels per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* ws = xs + kPos * LDX;  // kPos * LDX * 4 bytes is a multiple of 16

  const int n = blockIdx.z, d = blockIdx.y;
  const int h0 = (blockIdx.x / g.tiles_w) * kTH, w0 = (blockIdx.x % g.tiles_w) * kTW;
  const int m = threadIdx.x % (kTH * kTW), co0 = (threadIdx.x / (kTH * kTW)) * CPT;
  const int mh = m / kTW, mw = m % kTW;

  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;

  for (int kd = 0; kd < 3; ++kd) {
    const int din = d + kd - 1;
    if (din < 0 || din >= g.D) continue;  // the same for the whole block
    __syncthreads();                      // the previous plane and weights are consumed
    stage_plane<float, C, LDX>(x, xs, n, din, h0, w0, g, 0.f);
    for (int kh = 0; kh < 3; ++kh) {
      if (kh) __syncthreads();
      stage_weights<float, C, LDW>(wt, ws, (kd * 3 + kh) * 3);
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const float* xp = xs + ((mh + kh) * kHW + mw + kw) * LDX;
        const float* wp = ws + kw * C * LDW + co0;
#pragma unroll 4
        for (int ci = 0; ci < C; ++ci) {
          const float xv = xp[ci];
          const float4* w4 = reinterpret_cast<const float4*>(wp + ci * LDW);
#pragma unroll
          for (int j = 0; j < CPT / 4; ++j) {
            const float4 wv = w4[j];
            acc[4 * j + 0] = fmaf(xv, wv.x, acc[4 * j + 0]);
            acc[4 * j + 1] = fmaf(xv, wv.y, acc[4 * j + 1]);
            acc[4 * j + 2] = fmaf(xv, wv.z, acc[4 * j + 2]);
            acc[4 * j + 3] = fmaf(xv, wv.w, acc[4 * j + 3]);
          }
        }
      }
    }
  }

  const int h = h0 + mh, w = w0 + mw;
  if (h < g.H && w < g.W) {
    const size_t plane = (size_t)g.H * g.W;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int co = co0 + j;
      const float b = bias ? bias[co] : 0.f;
      y[(((size_t)n * C + co) * g.D + d) * plane + (size_t)h * g.W + w] = acc[j] + b;
    }
  }
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// D = A (16x16 bf16, row) * B (16x8 bf16, col) + D, float32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(d[0]), "f"(d[1]),
        "f"(d[2]), "f"(d[3]));
}

// bfloat16 values are moved as their 16-bit patterns (uint16_t); only the
// tensor cores and the final cast interpret them.
template <int C>
__global__ void __launch_bounds__(kThreads)
conv3d_k3_bf16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ wt,
                      const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                      Geometry g) {
  constexpr int LDX = C + 8;  // (C + 8) / 2 words per position: conflict-free A loads
  constexpr int LDW = C + 8;  // and B loads
  constexpr int NT = C / 8;   // n-tiles of 8 output channels
  constexpr int KS = C / 16;  // k-steps of 16 input channels per tap
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* ws = xs + kPos * LDX;  // kPos * LDX * 2 bytes is a multiple of 16

  const int n = blockIdx.z, d = blockIdx.y;
  const int h0 = (blockIdx.x / g.tiles_w) * kTH, w0 = (blockIdx.x % g.tiles_w) * kTW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[t][j] = 0.f;

  for (int kd = 0; kd < 3; ++kd) {
    const int din = d + kd - 1;
    if (din < 0 || din >= g.D) continue;  // the same for the whole block
    __syncthreads();
    stage_plane<uint16_t, C, LDX>(x, xs, n, din, h0, w0, g, 0);
    for (int kh = 0; kh < 3; ++kh) {
      if (kh) __syncthreads();
      stage_weights<uint16_t, C, LDW>(wt, ws, (kd * 3 + kh) * 3);
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        // A rows: voxels (warp, gid) and (warp, gid + 8) of the tile, shifted by the tap
        const uint16_t* xa = xs + ((warp + kh) * kHW + gid + kw) * LDX + tig * 2;
        const uint16_t* xb = xa + 8 * LDX;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int k0 = ks * 16;
          const uint32_t a0 = *reinterpret_cast<const uint32_t*>(xa + k0);
          const uint32_t a1 = *reinterpret_cast<const uint32_t*>(xb + k0);
          const uint32_t a2 = *reinterpret_cast<const uint32_t*>(xa + k0 + 8);
          const uint32_t a3 = *reinterpret_cast<const uint32_t*>(xb + k0 + 8);
          // B: rows ci = k0 + 2 tig (+1, +8, +9), column co = 8 t + gid
          const uint16_t* wb = ws + (kw * C + k0 + tig * 2) * LDW + gid;
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const uint16_t* wc = wb + t * 8;
            const uint32_t b0 = pack2(wc[0], wc[LDW]);
            const uint32_t b1 = pack2(wc[8 * LDW], wc[9 * LDW]);
            mma_bf16_16816(acc[t], a0, a1, a2, a3, b0, b1);
          }
        }
      }
    }
  }

  // accumulator (t, j): voxel gid (j < 2) or gid + 8 (j >= 2), channel 8 t + 2 tig + (j & 1)
  const int h = h0 + warp;
  if (h >= g.H) return;
  const size_t plane = (size_t)g.H * g.W;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = w0 + gid + (j >= 2 ? 8 : 0);
      const int co = t * 8 + tig * 2 + (j & 1);
      if (w < g.W) {
        // round the sum, add the float32 bias, round again (a no-op without bias)
        const float sum = __bfloat162float(__float2bfloat16(acc[t][j]));
        const float b = bias ? bias[co] : 0.f;
        y[(((size_t)n * C + co) * g.D + d) * plane + (size_t)h * g.W + w] =
            dpt::from_f32<__nv_bfloat16>(sum + b);
      }
    }
}

template <int C>
cudaError_t launch_c(const void* x, const void* wt, const float* bias, void* y, int N,
                     const Geometry& g, int tiles, int dtype, cudaStream_t stream) {
  const dim3 grid(tiles, g.D, N);
  if (dtype == dpt::kFloat32) {
    constexpr size_t smem = sizeof(float) * (kPos * (C + 1) + 3 * C * C);
    auto kernel = conv3d_k3_f32_kernel<C>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(x),
                                             static_cast<const float*>(wt), bias,
                                             static_cast<float*>(y), g);
    return cudaGetLastError();
  }
  if (dtype == dpt::kBFloat16) {
    constexpr size_t smem = sizeof(uint16_t) * (kPos * (C + 8) + 3 * C * (C + 8));
    auto kernel = conv3d_k3_bf16_kernel<C>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(static_cast<const uint16_t*>(x),
                                             static_cast<const uint16_t*>(wt), bias,
                                             static_cast<__nv_bfloat16*>(y), g);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y: contiguous (N, C, D, H, W) tensors of one dtype; w: contiguous
// (27, C_in, C_out) weights in that dtype, tap = kd * 9 + kh * 3 + kw; bias:
// float32 (C,) or null. Returns the cudaError_t of the launch (0 on success).
extern "C" int dpt_conv3d_k3_fwd(const void* x, const void* w, const float* bias, void* y,
                                 int N, int C, int D, int H, int W, int dtype, void* stream) {
  if (N <= 0 || N > 65535 || D <= 0 || D > 65535 || H <= 0 || W <= 0)
    return cudaErrorInvalidValue;
  const int tiles_w = (W + kTW - 1) / kTW;
  const long long tiles = (long long)((H + kTH - 1) / kTH) * tiles_w;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Geometry g{D, H, W, tiles_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch_c<16>(x, w, bias, y, N, g, (int)tiles, dtype, s);
    case 32: return launch_c<32>(x, w, bias, y, N, g, (int)tiles, dtype, s);
    case 64: return launch_c<64>(x, w, bias, y, N, g, (int)tiles, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}
