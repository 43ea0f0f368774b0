// K1: multi-head self-attention forward, softmax(Q K^T * Dh^-1/2) V on
// (N*H, L, Dh) tensors, Dh in {32, 64, 128}, any L >= 1, output in the input
// dtype.
//
// Replaces dose_prediction_tpu/kernels/attention.py::fused_attention (the
// Pallas kernel at :26, launched at :59), which holds a whole (L, L) score
// matrix of one (batch, head) in VMEM. Neither kernel here forms that
// matrix: K and V stream through shared memory in tiles of 64 keys under an
// online softmax (running max and sum per query row, in float32).
//
// What bounds it on the H100: the work is 4*L^2*Dh operations per
// (batch, head) against 4*L*Dh elements moved. In bfloat16 that is L/2
// operations per byte (108 at L = 216, 256 at L = 512), under the card's
// 295, so the least time is set by the bytes (1-3 us at the main path's
// shapes): what decides the time is filling the card and hiding latency, not
// the tensor cores' peak. In float32 (L/4 per byte against 67 TFLOP/s of
// plain FMA, 20 per byte) the operations bound it.
//
// bfloat16, in the flash-attention-2 pattern on mma.sync (no wgmma or TMA):
// - A block has WM x WN warps. Each warp owns 16 query rows; the WM warps of
//   a key slice own 16*WM rows, and the WN warps that share those rows split
//   every key tile between them (64/WN keys each), keep their own running
//   max, sum and output, and are combined through shared memory at the end.
//   A key split shortens each warp's sequential run of key tiles, but a
//   block of fewer query rows reads all of K and V again from L2. The
//   wrapper takes the fewest key splits whose grid has at least one block
//   per two SMs: (4, 1) at (8*12 heads, L = 216), 384 blocks; (2, 2) at
//   (6 heads, L = 512), 96 blocks of 32 rows, where 64-row blocks would
//   give 48 and 16-row blocks 192 that read K and V twice as often.
// - Q is staged once and held in registers as mma A fragments (ldmatrix).
//   K and V tiles stream through a 2-stage shared-memory ring with 16-byte
//   cp.async copies (rows past L zero-filled), the next tile in flight while
//   the current one is used. Rows are padded by 8 elements so that ldmatrix
//   (and ldmatrix.trans for V) reads 8 rows from 8 distinct bank groups.
// - S = Q K^T runs on mma.sync m16n8k16 (bf16 in, float32 accumulate) in
//   registers, is scaled by Dh^-1/2 * log2(e), and keys >= L are set to
//   -inf. The row max and the rescale happen in registers; the four lanes
//   that share a row meet through shuffles.
// - P = exp2(S - m) is rounded to bf16 in registers and reused directly as
//   the A operand of the P V mma.sync (the m16n8 accumulator layout packs
//   into the m16n8k16 A layout); the row sum l adds the unrounded float32 P.
// - O accumulates in float32, is multiplied by 1/l, rounded to bf16, staged
//   in shared memory and stored with 16-byte stores.
// Numerics: P is rounded to bf16 before P V, as plain_attention and the JAX
// reference xla_attention (attention.py:41-48) round their probabilities;
// here P is relative to the running max and normalised after the product,
// there normalised before it, so the two round different values.
//
// float32: one block of 256 threads per (batch*head, 64-query tile), FMAs
// from shared memory in full float32 (no TF32), so that the result matches
// the plain version up to summation order; each thread owns a 4x4 tile of
// scores (rows ty+16i, keys tx+16j) and 4 x Dh/16 outputs. Tile rows are
// padded by one float so that the strided reads hit distinct banks. Keys
// past L score -inf; query rows past L are computed on zeros and not stored.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBN = 64;  // keys per tile, both kernels

// ---- float32: plain FMAs in full float32, the exact-order path ----

constexpr int kBM = 64;        // queries per block
constexpr int kThreads = 256;  // 16 x 16

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * 64 * (DH + 1) + 64 * (kBN + 1) + 3 * 64);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int L, float scale) {
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
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;

  for (int i = tid; i < kBM * DH; i += kThreads) {
    const int r = i / DH, c = i % DH, gr = q0 + r;
    sQ[r * LD + c] = gr < L ? qb[(size_t)gr * DH + c] : 0.f;
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
      sK[r * LD + c] = ok ? kb[(size_t)gr * DH + c] : 0.f;
      sV[r * LD + c] = ok ? vb[(size_t)gr * DH + c] : 0.f;
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
        o[base + (size_t)gr * DH + tx + 16 * j] = acc[i][j] * inv;
    }
  }
}


// ---- bfloat16: tensor cores (mma.sync), flash-attention-2 ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the destination when !ok (src is
// then not read but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// D = A (16x16 bf16, row) * B (16x8 bf16, col) + D, float32 accumulators.
// Fragments (g = lane / 4, c = 2 * (lane % 4)): a0 (g, c..c+1), a1 (g+8, c),
// a2 (g, c+8), a3 (g+8, c+8); b0 (k = c..c+1, n = g), b1 (k = c+8, n = g);
// d0, d1 (g, c..c+1), d2, d3 (g+8, c..c+1).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(d[0]), "f"(d[1]),
        "f"(d[2]), "f"(d[3]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH, int WM, int WN>
struct Bf16Tiling {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kRows = 16 * WM;   // query rows per block
  static constexpr int kKeys = kBN / WN;  // keys of a tile per warp
  static constexpr int LD = DH + 8;       // padded row, bf16 elements
  static constexpr int kTile = kBN * LD;  // one K or V tile, elements
  static constexpr size_t kQBytes = 2 * kRows * LD;
  static constexpr size_t kRingBytes = 2 * 2 * 2 * kTile;  // 2 stages of K and V
  // after the loop the ring holds the combine buffers: the outputs of the
  // WN - 1 key-split warps beside each row group's first, then m and l
  static constexpr size_t kCombineBytes =
      4 * ((WN - 1) * kRows * (DH + 8) + 2 * WN * kRows);
  static constexpr size_t kSmem =
      kQBytes + (kRingBytes > kCombineBytes ? kRingBytes : kCombineBytes);
};

// bfloat16 values move as their 16-bit patterns (uint16_t); only the tensor
// cores and the final cast interpret them.
template <int DH, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN)
attention_fwd_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v, uint16_t* __restrict__ o, int L,
                          float scale_log2) {
  using T = Bf16Tiling<DH, WM, WN>;
  constexpr int LD = T::LD;
  constexpr int CH = DH / 8;        // 16-byte chunks per row
  constexpr int KS = DH / 16;       // k-steps of Q K^T
  constexpr int NT = T::kKeys / 8;  // score n-tiles per warp and tile
  constexpr int PK = T::kKeys / 16; // k-steps of P V
  constexpr int OT = DH / 8;        // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem_raw);  // kRows x LD
  uint16_t* ring = sQ + T::kRows * LD;  // stage s: K at 2 s kTile, V after it

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % WM, wn = warp / WM;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * T::kRows;
  const size_t base = (size_t)blockIdx.y * L * DH;
  const uint16_t* qb = q + base;
  const uint16_t* kb = k + base;
  const uint16_t* vb = v + base;

  for (int i = tid; i < T::kRows * CH; i += T::kThreads) {
    const int r = i / CH, c = i % CH, gr = q0 + r;
    cp_async16(sQ + r * LD + c * 8, qb + (size_t)(gr < L ? gr : 0) * DH + c * 8, gr < L);
  }
  auto load_tile = [&](int t) {
    uint16_t* sK = ring + (t & 1) * 2 * T::kTile;
    uint16_t* sV = sK + T::kTile;
    for (int i = tid; i < kBN * CH; i += T::kThreads) {
      const int r = i / CH, c = i % CH, gr = t * kBN + r;
      const size_t off = (size_t)(gr < L ? gr : 0) * DH + c * 8;
      cp_async16(sK + r * LD + c * 8, kb + off, gr < L);
      cp_async16(sV + r * LD + c * 8, vb + off, gr < L);
    }
  };
  load_tile(0);
  cp_async_commit();  // group 0: Q and tile 0

  uint32_t qf[KS][4];
  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // rows gid and gid + 8 of the warp's 16: running max (log2 units) and the
  // lane's part of the running sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int ntiles = (L + kBN - 1) / kBN;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile(t + 1);  // its stage was last read before the previous barrier
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      const uint16_t* qa = sQ + (wm * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(qf[ks], qa + ks * 16);
    }
    const int key0 = t * kBN + wn * T::kKeys;  // the warp's first key in this tile
    if (key0 < L) {  // key0 is valid, so every row max below is finite
      const uint16_t* sK = ring + (t & 1) * 2 * T::kTile + wn * T::kKeys * LD;
      const uint16_t* sV = sK + T::kTile;
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // B fragments of n-tiles j, j+1: matrices (keys 8j.., dh 16ks), (8j.., 16ks+8),
      // (8j+8.., 16ks), (8j+8.., 16ks+8)
      const uint16_t* ka = sK + ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, ka + j * 8 * LD + ks * 16);
          mma_16816(s[j], qf[ks], b[0], b[1]);
          mma_16816(s[j + 1], qf[ks], b[2], b[3]);
        }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * j + 2 * tig + (e & 1);
          s[j][e] = key < L ? s[j][e] * scale_log2 : -INFINITY;
        }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);  // 0 on the first tile
      m0 = n0;
      m1 = n1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        acc[j][0] *= a0;
        acc[j][1] *= a0;
        acc[j][2] *= a1;
        acc[j][3] *= a1;
      }
      // P in bf16 as A fragments: n-tile 2kk gives a0, a1; n-tile 2kk+1 gives a2, a3
      uint32_t pf[PK][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float p0 = exp2f(s[j][0] - m0), p1 = exp2f(s[j][1] - m0);
        const float p2 = exp2f(s[j][2] - m1), p3 = exp2f(s[j][3] - m1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
        pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      // B fragments of n-tiles j, j+1 from V^T: matrices (keys 16kk.., dh 8j),
      // (16kk+8.., 8j), (16kk.., 8j+8), (16kk+8.., 8j+8)
      const uint16_t* va = sV + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
#pragma unroll
      for (int kk = 0; kk < PK; ++kk)
#pragma unroll
        for (int j = 0; j < OT; j += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, va + kk * 16 * LD + j * 8);
          mma_16816(acc[j], pf[kk], b[0], b[1]);
          mma_16816(acc[j + 1], pf[kk], b[2], b[3]);
        }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = wm * 16 + gid, r1 = r0 + 8;  // the lane's rows in the block
  if constexpr (WN > 1) {
    // combine the key-split warps of each row group (the ring is free: the
    // loop ended on a barrier)
    float* sO = reinterpret_cast<float*>(ring);  // (WN - 1) x kRows x (DH + 8)
    float* sM = sO + (WN - 1) * T::kRows * (DH + 8);  // WN x kRows
    float* sL = sM + WN * T::kRows;
    if (tig == 0) {
      sM[wn * T::kRows + r0] = m0;
      sM[wn * T::kRows + r1] = m1;
      sL[wn * T::kRows + r0] = l0;
      sL[wn * T::kRows + r1] = l1;
    }
    __syncthreads();
    float g0 = -INFINITY, g1 = -INFINITY;  // finite: warp 0 saw key 0
#pragma unroll
    for (int w = 0; w < WN; ++w) {
      g0 = fmaxf(g0, sM[w * T::kRows + r0]);
      g1 = fmaxf(g1, sM[w * T::kRows + r1]);
    }
    const float f0 = exp2f(m0 - g0), f1 = exp2f(m1 - g1);  // 0 for a warp that saw no key
    if (wn > 0) {
      float* dst = sO + (wn - 1) * T::kRows * (DH + 8);
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        const int c = 8 * j + 2 * tig;
        *reinterpret_cast<float2*>(dst + r0 * (DH + 8) + c) =
            make_float2(acc[j][0] * f0, acc[j][1] * f0);
        *reinterpret_cast<float2*>(dst + r1 * (DH + 8) + c) =
            make_float2(acc[j][2] * f1, acc[j][3] * f1);
      }
    }
    __syncthreads();
    if (wn > 0) return;  // no barrier follows
    l0 = 0.f;
    l1 = 0.f;
#pragma unroll
    for (int w = 0; w < WN; ++w) {
      l0 += sL[w * T::kRows + r0] * exp2f(sM[w * T::kRows + r0] - g0);
      l1 += sL[w * T::kRows + r1] * exp2f(sM[w * T::kRows + r1] - g1);
    }
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int c = 8 * j + 2 * tig;
      acc[j][0] *= f0;
      acc[j][1] *= f0;
      acc[j][2] *= f1;
      acc[j][3] *= f1;
#pragma unroll
      for (int w = 1; w < WN; ++w) {
        const float* src = sO + (w - 1) * T::kRows * (DH + 8);
        const float2 u = *reinterpret_cast<const float2*>(src + r0 * (DH + 8) + c);
        const float2 x = *reinterpret_cast<const float2*>(src + r1 * (DH + 8) + c);
        acc[j][0] += u.x;
        acc[j][1] += u.y;
        acc[j][2] += x.x;
        acc[j][3] += x.y;
      }
    }
  }

  // O / l in bf16, staged in the warp's own 16 rows of sQ, then 16-byte stores
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  uint16_t* so = sQ + wm * 16 * LD;
#pragma unroll
  for (int j = 0; j < OT; ++j) {
    const int c = 8 * j + 2 * tig;
    *reinterpret_cast<uint32_t*>(so + gid * LD + c) = pack_bf16(acc[j][0] * i0, acc[j][1] * i0);
    *reinterpret_cast<uint32_t*>(so + (gid + 8) * LD + c) =
        pack_bf16(acc[j][2] * i1, acc[j][3] * i1);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH, gr = q0 + wm * 16 + r;
    if (gr < L)
      *reinterpret_cast<uint4*>(o + base + (size_t)gr * DH + c * 8) =
          *reinterpret_cast<const uint4*>(so + r * LD + c * 8);
  }
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int bh, int L,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  auto kernel = attention_fwd_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kBM - 1) / kBM, bh);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(q),
                                           static_cast<const float*>(k),
                                           static_cast<const float*>(v), static_cast<float*>(o),
                                           L, scale);
  return cudaGetLastError();
}

template <int DH, int WM, int WN>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int L,
                        float scale, cudaStream_t stream) {
  using T = Bf16Tiling<DH, WM, WN>;
  auto kernel = attention_fwd_bf16_kernel<DH, WM, WN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)T::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + T::kRows - 1) / T::kRows, bh);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), L,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int DH>
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int L,
                          int wm, int wn, float scale, cudaStream_t s) {
  if (wm == 4 && wn == 1) return launch_bf16<DH, 4, 1>(q, k, v, o, bh, L, scale, s);
  if (wm == 2 && wn == 2) return launch_bf16<DH, 2, 2>(q, k, v, o, bh, L, scale, s);
  if (wm == 1 && wn == 4) return launch_bf16<DH, 1, 4>(q, k, v, o, bh, L, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: contiguous (bh, L, dh) tensors of one dtype, 16-byte aligned in
// bfloat16; (warps_m, warps_n), the bfloat16 tiling, is (4, 1), (2, 2) or
// (1, 4) and is not read in float32. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int dpt_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh,
                                 int L, int dh, int dtype, int warps_m, int warps_n,
                                 float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || L <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dpt::kFloat32) {
    switch (dh) {
      case 32: return launch_f32<32>(q, k, v, o, bh, L, scale, s);
      case 64: return launch_f32<64>(q, k, v, o, bh, L, scale, s);
      case 128: return launch_f32<128>(q, k, v, o, bh, L, scale, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == dpt::kBFloat16) {
    switch (dh) {
      case 32: return dispatch_bf16<32>(q, k, v, o, bh, L, warps_m, warps_n, scale, s);
      case 64: return dispatch_bf16<64>(q, k, v, o, bh, L, warps_m, warps_n, scale, s);
      case 128: return dispatch_bf16<128>(q, k, v, o, bh, L, warps_m, warps_n, scale, s);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
