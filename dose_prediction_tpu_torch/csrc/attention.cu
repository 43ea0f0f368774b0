// K1: multi-head self-attention forward, softmax(Q K^T * Dh^-1/2) V on
// (N*H, L, Dh) tensors, float32 or bfloat16 in, float32 arithmetic, output in
// the input dtype.
//
// Replaces dose_prediction_tpu/kernels/attention.py::fused_attention (the
// Pallas kernel at :26, launched at :59), which holds a whole (L, L) score
// matrix of one (batch, head) in VMEM.
//
// What bounds it on the H100: the work is 4*L^2*Dh operations per
// (batch, head) against 4*L*Dh elements moved. In bfloat16 that is L/2
// operations per byte (108 at L = 216, 256 at L = 512), under the card's
// 295, so the least time is set by the bytes; in float32 (L/4 per byte
// against 67 TFLOP/s of plain FMA, 20 per byte) by the operations. This
// first version does the arithmetic in float32 FMAs from shared memory, not
// on the tensor cores (wgmma), so those FMAs are what limit it in both
// dtypes: it runs far from the bfloat16 bound.
//
// Design: one block of 256 threads per (batch*head, 64-query tile). K and V
// stream through shared memory in tiles of 64 keys; an online softmax keeps a
// running max and sum per query row in float32, so no (L, L) matrix ever
// exists. Each thread owns a 4x4 tile of scores (rows ty+16i, keys tx+16j)
// and 4 x Dh/16 outputs. Tile rows are padded by one float so that the
// strided reads hit distinct banks. Keys past L score -inf (L = 216 is not
// a multiple of 64); query rows past L are computed on zeros and not stored.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBM = 64;        // queries per block
constexpr int kBN = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * 64 * (DH + 1) + 64 * (kBN + 1) + 3 * 64);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int L, float scale) {
  constexpr int LD = DH + 1;
  constexpr int LDS = kBN + 1;
  constexpr int CPT = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // kBM x LD
  float* sK = sQ + kBM * LD;     // kBN x LD
  float* sV = sK + kBN * LD;     // kBN x LD
  float* sS = sV + kBN * LD;     // kBM x LDS: scores, then probabilities
  float* sM = sS + kBM * LDS;    // running max per row
  float* sL = sM + kBM;          // running sum per row
  float* sA = sL + kBM;          // rescale factor of the current tile per row

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBM;
  const size_t base = (size_t)blockIdx.y * L * DH;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  for (int i = tid; i < kBM * DH; i += kThreads) {
    const int r = i / DH, c = i % DH, gr = q0 + r;
    sQ[r * LD + c] = gr < L ? dpt::to_f32(qb[(size_t)gr * DH + c]) : 0.f;
  }
  if (tid < kBM) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  const int ntiles = (L + kBN - 1) / kBN;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBN;
    __syncthreads();  // the previous tile's K, V and probabilities are consumed
    for (int i = tid; i < kBN * DH; i += kThreads) {
      const int r = i / DH, c = i % DH, gr = k0 + r;
      const bool ok = gr < L;
      sK[r * LD + c] = ok ? dpt::to_f32(kb[(size_t)gr * DH + c]) : 0.f;
      sV[r * LD + c] = ok ? dpt::to_f32(vb[(size_t)gr * DH + c]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty+16i against keys tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        sS[(ty + 16 * i) * LDS + c] = (k0 + c < L) ? s[i][j] * scale : -INFINITY;
      }
    __syncthreads();

    // online softmax: four consecutive lanes share one row
    {
      const int r = tid / 4, part = tid % 4;
      float* row = sS + r * LDS;
      float mx = -INFINITY;
      for (int c = part; c < kBN; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);  // finite: key 0 is always valid
      float sum = 0.f;
      for (int c = part; c < kBN; c += 4) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float a = expf(m_old - m_new);
        sA[r] = a;
        sL[r] = sL[r] * a + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // O = O * a + P V for rows ty+16i, columns tx+16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < kBN; ++c) {
      float p[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = sV[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, gr = q0 + r;
    if (gr < L) {
      const float inv = 1.f / sL[r];
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        o[base + (size_t)gr * DH + tx + 16 * j] = dpt::from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int L,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  auto kernel = attention_fwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kBM - 1) / kBM, bh);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), L,
                                           scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* o, int bh, int L,
                        int dh, float scale, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, o, bh, L, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, L, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, L, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous (bh, L, dh) tensors of one dtype; returns the
// cudaError_t of the launch (0 on success).
extern "C" int dpt_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh,
                                 int L, int dh, int dtype, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || L <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dpt::kFloat32: return dispatch_dh<float>(q, k, v, o, bh, L, dh, scale, s);
    case dpt::kBFloat16: return dispatch_dh<__nv_bfloat16>(q, k, v, o, bh, L, dh, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
