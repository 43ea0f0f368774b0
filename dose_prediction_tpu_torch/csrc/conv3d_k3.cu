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
// Design: an implicit GEMM. M is the output voxels, N the C output channels,
// K is 27 * C (27 taps of C input channels).
// - float32 (simple first): a block computes 8 x 16
//   voxels of one (n, d) row. It stages one input depth plane with its halo,
//   10 x 18 positions x C, channels innermost, then the three kw taps of one
//   (kd, kh) at a time (49 KB at most), and alternates staging and compute.
//   Plain FMAs in full float32 (no TF32), so the result matches the plain
//   version up to summation order: thread t owns voxel t % 128 and half of
//   the output channels; weight rows are read as float4 broadcasts.
// - bfloat16, on the tensor cores (mma.sync m16n8k16, bf16 in, float32
//   accumulate):
//   * Tile. A block takes th x tw output positions of one sample at td
//     consecutive depths; kernels/conv3d.py::plan chooses (th, tw, td, g) by
//     shape from a short list (tw a multiple of 8; 8 x 24 at W = 24, so
//     nothing is masked off there). Warp w owns g groups of 16 consecutive
//     positions of the tile at each of the td depths: MT = td * g m-tiles
//     (8, 4, 2 at C = 16, 32, 64) and all C / 8 n-tiles, 64 float32
//     accumulators a thread. The m-tiles' rows are shared-memory positions,
//     so an m-tile may span two rows of the tile.
//   * Fragments. Both come from ldmatrix.x4: A (16 positions x 16 channels)
//     from the halo planes, each lane giving one position's row shifted by
//     the tap; B (16 input channels x two n-tiles) from the weights, packed
//     (27, C_out, C_in) by the wrapper so that input channels are
//     contiguous. Each B fragment feeds MT mma; per k-step a warp issues
//     C / 16 + MT ldmatrix for MT * C / 8 mma.
//   * Staging. The td + 2 input planes of the halo, (th + 2) x (tw + 2)
//     positions x (C + 8) channels each, are staged once a block with
//     16-byte loads along w (four items in flight a thread, word stores on
//     32 banks), or with 2-byte loads where x is not 16-byte aligned or W
//     is not a multiple of 8 (a second instantiation, chosen before the
//     launch). The weights move in groups of the three kw taps of one (kd,
//     kh), by 16-byte cp.async into a ring of slots ([kw][co][ci + 8]): all
//     nine groups at C = 16, three slots at C = 32, two at C = 64 (21, 23 and
//     55 KB); a group is in flight while the halo is staged and while the
//     previous group computes. Each group and plane is staged once a block.
//     Rows padded to C + 8 are an odd number of 16-byte units, so
//     ldmatrix's rows fall on distinct banks. Shared memory a block, at the
//     serve shapes' tiles: 114 KB at C = 16 (16 x 16 x 4), 106-109 KB at
//     C = 32, 159-205 KB at C = 64.
//   * What bounds it: at C >= 32 the shared-memory reads that feed the mma
//     (A loads grow with MT, B with C) and the halo staging, which is not
//     overlapped with the block's own compute; at C = 16, which is about
//     even between bytes and operations, the halo staging, which reads 1.9
//     times the input from L2.
//   Not done: wgmma, TMA, warp specialisation, and overlapping the halo of
//   the next depths with compute.
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
template <int C, int LDX>
__device__ __forceinline__ void stage_plane(const float* __restrict__ x, float* xs, int n,
                                            int din, int h0, int w0, const Geometry& g) {
  const size_t plane = (size_t)g.H * g.W;
  for (int i = threadIdx.x; i < C * kPos; i += kThreads) {
    const int c = i / kPos, r = i - c * kPos;
    const int hh = r / kHW, ww = r - hh * kHW;
    const int h = h0 + hh - 1, w = w0 + ww - 1;
    float v = 0.f;
    if (h >= 0 && h < g.H && w >= 0 && w < g.W)
      v = x[(((size_t)n * C + c) * g.D + din) * plane + (size_t)h * g.W + w];
    xs[r * LDX + c] = v;
  }
}

// The three kw taps of one (kd, kh): ws[(kw * C + ci) * LDW + co] from the
// (27, C_in, C_out) weights, tap = (kd * 3 + kh) * 3 + kw.
template <int C, int LDW>
__device__ __forceinline__ void stage_weights(const float* __restrict__ wt, float* ws, int tap0) {
  const float* src = wt + (size_t)tap0 * C * C;
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
    stage_plane<C, LDX>(x, xs, n, din, h0, w0, g);
    for (int kh = 0; kh < 3; ++kh) {
      if (kh) __syncthreads();
      stage_weights<C, LDW>(wt, ws, (kd * 3 + kh) * 3);
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

// ---- bfloat16 ----

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can use (H100)

// m-tiles of 16 voxels per warp: each B fragment feeds MT mma. 64 float32
// accumulators per thread at every C.
__host__ __device__ constexpr int bf16_mtiles(int C) { return C == 16 ? 8 : C == 32 ? 4 : 2; }
// Warps a block may have: at most 8 at C = 16 and 32, so that two blocks'
// registers (at most 128 a thread) fit on one SM beside their shared memory;
// 12 at C = 64, whose tiles leave room for one block an SM.
__host__ __device__ constexpr int bf16_max_warps(int C) { return C == 64 ? 12 : 8; }
// Weight groups (3 taps, 3 C (C + 8) bf16 each) held at once: all 9 at C =
// 16 (21 KB), a ring of 3 at C = 32 (23 KB) and of 2 at C = 64 (55 KB).
__host__ __device__ constexpr int bf16_ring(int C) { return C == 16 ? 9 : C == 32 ? 3 : 2; }

// The block's tile: th x tw output positions (tw a multiple of 8) at td
// consecutive output depths; each warp owns g groups of 16 consecutive
// positions (row-major over the tile) at each of the td depths, so
// td * g = MT m-tiles, and th * tw / (16 g) warps.
struct Tile {
  int D, H, W;
  int th, tw, td, g, tiles_w;
};

// Shared memory: a ring of weight groups (the 3 kw taps of one (kd, kh),
// [kw][co][ci + 8]) and the td + 2 input depth planes of the halo tile ([plane][pos][c +
// 8], pos = row * (tw + 2) + column). A row of C + 8 values is an odd number
// of 16-byte units (3, 5 or 9), so the 8 rows of one ldmatrix matrix
// (consecutive positions, or consecutive output channels) fall on distinct
// banks.
__host__ __device__ inline long long bf16_smem_bytes(int C, int th, int tw, int td) {
  return 2LL * (C + 8) *
         (3LL * C * bf16_ring(C) + (long long)(td + 2) * (th + 2) * (tw + 2));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); r[j] is matrix j's
// fragment (row lane / 4, columns 2 (lane % 4) and + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// D = A (16x16 bf16, row) * B (16x8 bf16, col) + D, float32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(d[0]), "f"(d[1]),
        "f"(d[2]), "f"(d[3]));
}

// 16 bytes from global to shared memory without the registers (L2 only);
// completion is waited for by commit group.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying weight group q (taps 3q .. 3q + 2 of the (27, C_out, C_in)
// weights) into ws[(kw * C + co) * (C + 8) + ci], 16 bytes a copy.
template <int C>
__device__ __forceinline__ void stage_weight_group(const uint16_t* __restrict__ wt,
                                                   uint16_t* ws, int q) {
  constexpr int kChunks = C / 8;  // 16-byte chunks per row
  const uint16_t* src = wt + (size_t)q * 3 * C * C;
  for (int i = threadIdx.x; i < 3 * C * kChunks; i += blockDim.x) {
    const int row = i / kChunks, k = i - row * kChunks;
    cp_async16(smem_u32(ws + row * (C + 8) + k * 8), src + i * 8);
  }
}

// The td + 2 input planes d0 - 1 .. d0 + td of the halo tile with 16-byte
// loads: x 16-byte aligned, W a multiple of 8 (so every 8-column chunk of a
// row is aligned and lies wholly inside or outside the volume). Each item is
// one row and one channel pair at one of tw / 8 + 2 column slots: the left
// halo column (2-byte loads), the tw / 8 chunks (two 16-byte loads, 8
// positions), the right halo column. Lane l takes channel pair l % (C / 2)
// of row 4 b + s + S (l / (C / 2)) of a block of 4 rows (S = C / 16, s < S):
// 8 positions apart is no bank offset at all, 2 (C = 16) or 4 (C = 32) rows
// apart is the other half or quarter of the banks, so the 32 lanes' word
// stores fall on 32 banks. Each thread keeps kBatch items' loads in flight
// before it stores them. Zero outside the volume.
template <int C>
__device__ __forceinline__ void stage_planes_vec(const uint16_t* __restrict__ x, uint16_t* xs,
                                                 int n, int d0, int h0, int w0, const Tile& t) {
  constexpr int kBatch = 4, S = C / 16, LDX = C + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const int cp = lane % (C / 2), row_off = S * (lane / (C / 2));
  const int pw = t.tw + 2, pos = (t.th + 2) * pw;
  const int slots = t.tw / 8 + 2, row_blocks = (t.th + 5) / 4;
  const int items = (t.td + 2) * row_blocks * slots * S;  // per lane
  const size_t hw = (size_t)t.H * t.W, cstride = (size_t)t.D * hw;
  const uint16_t* xc = x + ((size_t)n * C + 2 * cp) * cstride;
  for (int r0 = warp; r0 < items; r0 += kBatch * warps) {
    uint4 v0[kBatch], v1[kBatch];
    int dst[kBatch], slot[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int r = r0 + b * warps;
      const int sub = r % S, r2 = r / S;
      const int k = r2 % slots, r3 = r2 / slots;
      const int p = r3 % (t.td + 2), hh = (r3 / (t.td + 2)) * 4 + sub + row_off;
      const int ww = k == 0 ? 0 : k == slots - 1 ? t.tw + 1 : 8 * k - 7;
      const int din = d0 - 1 + p, h = h0 - 1 + hh, w = w0 - 1 + ww;
      slot[b] = k == 0 || k == slots - 1 ? 0 : 1;
      dst[b] = r < items && hh < t.th + 2 ? (p * pos + hh * pw + ww) * LDX + 2 * cp : -1;
      v0[b] = v1[b] = make_uint4(0, 0, 0, 0);
      if (dst[b] >= 0 && din >= 0 && din < t.D && h >= 0 && h < t.H && w >= 0 && w < t.W) {
        const uint16_t* src = xc + (size_t)din * hw + (size_t)h * t.W + w;
        if (slot[b]) {
          v0[b] = __ldg(reinterpret_cast<const uint4*>(src));
          v1[b] = __ldg(reinterpret_cast<const uint4*>(src + cstride));
        } else {
          v0[b].x = __ldg(src);
          v1[b].x = __ldg(src + cstride);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (dst[b] < 0) continue;
      uint32_t* out = reinterpret_cast<uint32_t*>(xs + dst[b]);
      const uint32_t lo[4] = {v0[b].x, v0[b].y, v0[b].z, v0[b].w};
      const uint32_t hi[4] = {v1[b].x, v1[b].y, v1[b].z, v1[b].w};
      // word j: channel 2 cp of position j in the low half, 2 cp + 1 in the high
      out[0] = __byte_perm(lo[0], hi[0], 0x5410);
      if (slot[b]) {
        out[LDX / 2] = __byte_perm(lo[0], hi[0], 0x7632);
#pragma unroll
        for (int j = 1; j < 4; ++j) {
          out[LDX * j] = __byte_perm(lo[j], hi[j], 0x5410);
          out[LDX * j + LDX / 2] = __byte_perm(lo[j], hi[j], 0x7632);
        }
      }
    }
  }
}

// The same planes with 2-byte loads, for tensors that are not 16-byte
// aligned or whose rows are not: two channels (one 32-bit word) per item,
// positions fastest.
template <int C>
__device__ __forceinline__ void stage_planes(const uint16_t* __restrict__ x, uint16_t* xs,
                                             int n, int d0, int h0, int w0, const Tile& t) {
  const int pw = t.tw + 2, pos = (t.th + 2) * pw, items = (t.td + 2) * pos;
  const size_t hw = (size_t)t.H * t.W, cstride = (size_t)t.D * hw;
  for (int i = threadIdx.x; i < items * (C / 2); i += blockDim.x) {
    const int cp = i / items, r = i - cp * items;
    const int p = r / pos, rr = r - p * pos;
    const int hh = rr / pw, ww = rr - hh * pw;
    const int din = d0 - 1 + p, h = h0 - 1 + hh, w = w0 - 1 + ww;
    uint32_t v = 0;
    if (din >= 0 && din < t.D && h >= 0 && h < t.H && w >= 0 && w < t.W) {
      const uint16_t* src =
          x + ((size_t)n * C + 2 * cp) * cstride + (size_t)din * hw + (size_t)h * t.W + w;
      v = (uint32_t)src[0] | ((uint32_t)src[cstride] << 16);
    }
    *reinterpret_cast<uint32_t*>(xs + r * (C + 8) + 2 * cp) = v;
  }
}

// bfloat16 values are moved as their 16-bit patterns (uint16_t); only the
// tensor cores and the final cast interpret them.
template <int C, bool VEC>
__global__ void __launch_bounds__(bf16_max_warps(C) * 32, C == 64 ? 1 : 2)
conv3d_k3_bf16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ wt,
                      const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, Tile t) {
  constexpr int LDX = C + 8;
  constexpr int NT = C / 8;   // n-tiles of 8 output channels
  constexpr int KS = C / 16;  // k-steps of 16 input channels per tap
  constexpr int MT = bf16_mtiles(C), RING = bf16_ring(C), GROUP = 3 * C * LDX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* ws = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* xs = ws + RING * GROUP;  // GROUP * 2 bytes: a multiple of 16

  const int pw = t.tw + 2, pos = (t.th + 2) * pw;
  const int n = blockIdx.z, d0 = blockIdx.y * t.td;
  const int h0 = (blockIdx.x / t.tiles_w) * t.th, w0 = (blockIdx.x % t.tiles_w) * t.tw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // A of m-tile i (depth d0 + i / g, positions 16 (warp g + i % g) onward):
  // lane l gives position l % 16 at tap (0, 0, 0), channels 8 (l / 16) on
  uint32_t a_addr[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int q = (warp * t.g + i % t.g) * 16 + (lane & 15);
    const int qh = q / t.tw, qw = q - qh * t.tw;
    a_addr[i] = smem_u32(xs + ((i / t.g) * pos + qh * pw + qw) * LDX + (lane >> 4) * 8);
  }
  // B of an n-tile pair: lane l gives output channel 8 (l / 16) + l % 8 of
  // the pair, input channels 8 ((l / 8) % 2) on
  const uint32_t b_addr =
      smem_u32(ws + (((lane >> 4) << 3) + (lane & 7)) * LDX + ((lane >> 3) & 1) * 8);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // weight groups 0 .. RING - 2 in flight (one commit group each) while the
  // planes are staged
#pragma unroll
  for (int q = 0; q < RING - 1; ++q) {
    stage_weight_group<C>(wt, ws + q * GROUP, q);
    cp_async_commit();
  }
  if (VEC)
    stage_planes_vec<C>(x, xs, n, d0, h0, w0, t);
  else
    stage_planes<C>(x, xs, n, d0, h0, w0, t);
  for (int q = 0; q < 9; ++q) {  // weight group q = (kd, kh), in ring slot q % RING
    const int kd = q / 3, kh = q - kd * 3;
    // RING - 1 + q groups are committed: group q has landed when at most
    // RING - 2 are in flight; the barrier makes every thread's copies and
    // plane stores visible, and slot (q - 1) % RING free (group q - 1 consumed)
    cp_async_wait<RING - 2>();
    __syncthreads();
    const int next = q + RING - 1;
    if (next < 9) stage_weight_group<C>(wt, ws + next % RING * GROUP, next);
    cp_async_commit();  // possibly empty: one commit per iteration keeps the count
    const uint32_t tap = (kd * pos + kh * pw) * LDX * 2;
    const uint32_t b_slot = b_addr + (q % RING) * GROUP * 2;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[MT][4], b[NT / 2][4];
#pragma unroll
        for (int p = 0; p < NT / 2; ++p)
          ldsm_x4(b[p], b_slot + ((kw * C + 16 * p) * LDX + 16 * ks) * 2);
#pragma unroll
        for (int i = 0; i < MT; ++i) ldsm_x4(a[i], a_addr[i] + tap + (kw * LDX + 16 * ks) * 2);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int p = 0; p < NT / 2; ++p) {
            mma_bf16_16816(acc[i][2 * p], a[i], b[p][0], b[p][1]);
            mma_bf16_16816(acc[i][2 * p + 1], a[i], b[p][2], b[p][3]);
          }
      }
  }

  // accumulator (i, j, e): position gid (e < 2) or gid + 8 (e >= 2) of the
  // m-tile, channel 8 j + 2 tig + (e & 1)
  const int gid = lane >> 2, tig = lane & 3;
  const size_t hw = (size_t)t.H * t.W;
  float bv[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[j][e] = bias ? bias[8 * j + 2 * tig + e] : 0.f;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int d = d0 + i / t.g;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = (warp * t.g + i % t.g) * 16 + gid + 8 * half;
      const int qh = q / t.tw, h = h0 + qh, w = w0 + q - qh * t.tw;
      if (d >= t.D || h >= t.H || w >= t.W) continue;
      __nv_bfloat16* out = y + ((size_t)n * C * t.D + d) * hw + (size_t)h * t.W + w;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // round the sum, add the float32 bias, round again (a no-op without bias)
          const float sum = __bfloat162float(__float2bfloat16(acc[i][j][2 * half + e]));
          out[(size_t)(8 * j + 2 * tig + e) * t.D * hw] =
              dpt::from_f32<__nv_bfloat16>(sum + bv[j][e]);
        }
    }
  }
}

template <int C>
cudaError_t launch_f32(const void* x, const void* wt, const float* bias, void* y, int N, int D,
                       int H, int W, cudaStream_t stream) {
  const int tiles_w = (W + kTW - 1) / kTW;
  const long long tiles = (long long)((H + kTH - 1) / kTH) * tiles_w;
  if (D > 65535 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Geometry g{D, H, W, tiles_w};
  constexpr size_t smem = sizeof(float) * (kPos * (C + 1) + 3 * C * C);
  auto kernel = conv3d_k3_f32_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)tiles, D, N), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt), bias, static_cast<float*>(y),
      g);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_bf16(const void* x, const void* wt, const float* bias, void* y, int N,
                        Tile t, bool vec, cudaStream_t stream) {
  if (t.th <= 0 || t.tw <= 0 || t.tw % 8 || t.td <= 0 || t.g <= 0 ||
      t.td * t.g != bf16_mtiles(C) || (t.th * t.tw) % (16 * t.g))
    return cudaErrorInvalidValue;
  const int warps = t.th * t.tw / (16 * t.g);
  const long long smem = bf16_smem_bytes(C, t.th, t.tw, t.td);
  t.tiles_w = (t.W + t.tw - 1) / t.tw;
  const long long tiles = (long long)((t.H + t.th - 1) / t.th) * t.tiles_w;
  const int depth_blocks = (t.D + t.td - 1) / t.td;
  if (warps > bf16_max_warps(C) || smem > kMaxSmem || tiles > 0x7fffffffLL || depth_blocks > 65535)
    return cudaErrorInvalidValue;
  auto kernel = vec ? conv3d_k3_bf16_kernel<C, true> : conv3d_k3_bf16_kernel<C, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)tiles, depth_blocks, N), warps * 32, (size_t)smem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(wt), bias,
      static_cast<__nv_bfloat16*>(y), t);
  return cudaGetLastError();
}

}  // namespace

// x, y: contiguous (N, C, D, H, W) tensors of one dtype; w: contiguous
// weights in that dtype, (27, C_in, C_out) for float32 and (27, C_out, C_in)
// for bfloat16, tap = kd * 9 + kh * 3 + kw; bias: float32 (C,) or null.
// bfloat16 takes the tile (th, tw, td, g) that kernels/conv3d.py::plan
// chooses, and vec = 1 where x is 16-byte aligned and W % 8 == 0 (16-byte
// loads of the halo); float32 ignores them. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int dpt_conv3d_k3_fwd(const void* x, const void* w, const float* bias, void* y,
                                 int N, int C, int D, int H, int W, int dtype, int th, int tw,
                                 int td, int g, int vec, void* stream) {
  if (N <= 0 || N > 65535 || D <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dpt::kFloat32) {
    switch (C) {
      case 16: return launch_f32<16>(x, w, bias, y, N, D, H, W, s);
      case 32: return launch_f32<32>(x, w, bias, y, N, D, H, W, s);
      case 64: return launch_f32<64>(x, w, bias, y, N, D, H, W, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype != dpt::kBFloat16) return cudaErrorInvalidValue;
  const Tile t{D, H, W, th, tw, td, g, 0};
  switch (C) {
    case 16: return launch_bf16<16>(x, w, bias, y, N, t, vec != 0, s);
    case 32: return launch_bf16<32>(x, w, bias, y, N, t, vec != 0, s);
    case 64: return launch_bf16<64>(x, w, bias, y, N, t, vec != 0, s);
    default: return cudaErrorInvalidValue;
  }
}
