"""K3: direct 3×3×3 convolution for narrow, same-width channels (counterpart
of dose_prediction_tpu/kernels/conv3d.py::conv3d_k3).

The kernel (csrc/conv3d_k3.cu) replaces the Pallas kernel
dose_prediction_tpu/kernels/conv3d.py:60 (``_kernel``, launched by
``pl.pallas_call`` at :119): stride 1, dilation 1, zero padding 1,
C_in == C_out = C ∈ {16, 32, 64}, float32 accumulation, then the JAX
kernel's rounding (:137-141): the sum is cast to the input dtype, the
float32 bias is added to it in float32, and the result is cast again (in
float32 both casts are exact). On the H100 the operations bound
it (27·C per byte in bfloat16, over the card's 295 at C ≥ 32, about even at
C = 16); bfloat16 runs on the tensor cores, float32 in full-precision FMAs.
The TPU kernel's banded weights, 128-lane packing, ``W % (128 // C)``
restriction and per-sample loop are not carried over: any N, D, H and W.

The bfloat16 kernel is an implicit GEMM on ``mma.sync`` whose fragments
come from ``ldmatrix``: ``pack_weights`` lays the weights out
``(27, C_out, C_in)`` so that B's input channels are contiguous, and
``plan`` chooses each call's tile (``Tile``: rows, columns, output depths,
16-position groups a warp) by shape from ``TILES``. A block stages its
``td + 2`` halo planes once, with 16-byte loads where the tensor is 16-byte
aligned and W is a multiple of 8 (else a 2-byte-load instantiation), and
its weights once, by ``cp.async`` into a ring of 3-tap groups. Shared
memory: ``smem_bytes`` (106-205 KB at the serve shapes). At C ≥ 32 the
shared-memory reads that feed the tensor cores and the unoverlapped halo
staging bound it, at C = 16 the halo staging; ``wgmma``, TMA and warp
specialisation are not used. csrc/conv3d_k3.cu gives the design.

``plain_conv3d_k3`` is the same function in PyTorch: a float32 convolution
rounded to the input dtype, plus the float32 bias, rounded again. On a card path only the
backward recomputes it (kernels/autograd.py), as the JAX custom VJP
differentiates its XLA reference (:156-182).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from dose_prediction_tpu_torch.kernels import cuda_lib
from dose_prediction_tpu_torch.kernels.autograd import PlainBackward, needs_grad

CHANNELS = (16, 32, 64)
SMS = 132                  # the H100's streaming multiprocessors: the grid rule's card
MAX_SMEM = 232_448         # dynamic shared memory one block can use
MAX_WARPS = {16: 8, 32: 8, 64: 12}   # csrc/conv3d_k3.cu bf16_max_warps
MTILES = {16: 8, 32: 4, 64: 2}   # 16-voxel m-tiles per warp (bf16_mtiles)
RING = {16: 9, 32: 3, 64: 2}     # weight groups of 3 taps held at once (bf16_ring)


class Tile(NamedTuple):
    """A bf16 block's tile: ``th`` x ``tw`` output positions at ``td``
    consecutive depths; each warp owns ``g`` groups of 16 positions at each
    depth (``td * g`` m-tiles)."""
    th: int
    tw: int
    td: int
    g: int


# bf16 tiles by C, in order of preference: larger blocks first, then the
# 24-column tiles that cover W = 24 without waste, then smaller blocks (the
# order of the times bench_k3.py --tiles measured at the serve_k3 shapes)
TILES = {c: [Tile(*t) for t in tiles] for c, tiles in {
    16: [(16, 16, 4, 2), (16, 16, 2, 4), (8, 16, 4, 2), (8, 8, 4, 2), (16, 32, 1, 8),
         (32, 32, 1, 8), (16, 16, 1, 8), (8, 16, 1, 8)],
    32: [(8, 16, 4, 1), (8, 24, 2, 2), (8, 16, 2, 2), (16, 16, 1, 4), (8, 8, 2, 2),
         (8, 24, 1, 4), (4, 8, 2, 2), (8, 16, 1, 4), (8, 8, 1, 4)],
    64: [(8, 16, 2, 1), (8, 24, 2, 1), (16, 16, 1, 2), (8, 24, 1, 2), (8, 8, 2, 1),
         (8, 16, 1, 2), (4, 8, 2, 1), (8, 8, 1, 2), (4, 8, 1, 2)]}.items()}


def smem_bytes(c: int, t: Tile) -> int:
    """Shared memory of the bf16 kernel (bf16_smem_bytes): a ring of
    ``RING[c]`` weight groups of 3 taps and the ``td + 2`` halo planes, rows
    padded to C + 8."""
    return 2 * (c + 8) * (3 * c * RING[c] + (t.td + 2) * (t.th + 2) * (t.tw + 2))


def warps(t: Tile) -> int:
    return t.th * t.tw // (16 * t.g)


def grid(shape: tuple, t: Tile) -> tuple[int, int, int]:
    """The launch grid: (h, w) tiles, depth blocks, samples."""
    n, _, d, h, w = shape
    return -(-h // t.th) * -(-w // t.tw), -(-d // t.td), n


@functools.lru_cache(maxsize=None)
def plan(shape: tuple) -> Tile:
    """The bf16 tile for an ``(N, C, D, H, W)`` input: the first of
    ``TILES[C]`` that fits in shared memory, pads the volume by at most 1/8
    (W = 24 takes a 24-column tile) and gives at least half as many blocks
    as the card has SMs; where none does, the one that pads least. Every
    block stages all 27 taps (27·C·C weights), so a larger block that
    leaves SMs idle beats smaller ones that fill them: at (1,64,32³) 128
    blocks of 8×16×2 voxels take 0.034 ms, 512 of 4×8×2 take 0.061 ms on an
    H100 (``bench_k3.py --tiles``)."""
    n, c, d, h, w = shape
    fits = [t for t in TILES[c] if smem_bytes(c, t) <= MAX_SMEM]

    def padded(t):
        return -(-d // t.td) * t.td * -(-h // t.th) * t.th * -(-w // t.tw) * t.tw

    for t in fits:
        if 2 * math.prod(grid(shape, t)) >= SMS and padded(t) * 8 <= d * h * w * 9:
            return t
    return min(fits, key=lambda t: (padded(t), -math.prod(grid(shape, t))))


def plain_conv3d_k3(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor | None = None) -> torch.Tensor:
    """Same-size 3×3×3 conv of ``(N, C, D, H, W)`` with ``w (C, C, 3, 3, 3)``
    and ``b (C,)``: the float32 sum cast to ``x.dtype``, then the float32
    bias added in float32 and the result cast to ``x.dtype`` again."""
    y = F.conv3d(x.float(), w.float(), padding=1).to(x.dtype)
    if b is not None:
        y = (y.float() + b.float().reshape(1, -1, 1, 1, 1)).to(x.dtype)
    return y


def pack_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The kernel's weight layout: ``(C_out, C_in, 3, 3, 3)`` →
    ``(27, C_out, C_in)`` in bfloat16 (input channels contiguous, the rows
    ``ldmatrix`` reads) and ``(27, C_in, C_out)`` in float32, tap
    ``kd·9 + kh·3 + kw``, in ``dtype``."""
    order = (2, 3, 4, 0, 1) if dtype == torch.bfloat16 else (2, 3, 4, 1, 0)
    c = w.shape[0]
    return w.to(dtype).permute(*order).reshape(27, c, c).contiguous()


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    cuda_lib.require_cuda(x, "conv3d_k3")
    if x.ndim != 5 or x.shape[1] not in CHANNELS:
        raise ValueError(f"conv3d_k3: expected (N, C, D, H, W) with C in {CHANNELS}, "
                         f"got {tuple(x.shape)}")
    n, c, d, h, wd = x.shape
    if tuple(w.shape) != (c, c, 3, 3, 3) or w.device != x.device:
        raise ValueError(f"conv3d_k3: weight must be ({c}, {c}, 3, 3, 3) on {x.device}, "
                         f"got {tuple(w.shape)} on {w.device}")
    if b is not None and (b.numel() != c or b.device != x.device):
        raise ValueError(f"conv3d_k3: bias must be ({c},) on {x.device}")
    if x.numel() == 0:
        raise ValueError(f"conv3d_k3: empty input {tuple(x.shape)}")
    x = x.contiguous()
    wt = pack_weights(w, x.dtype)
    bias = None if b is None else b.float().contiguous()
    tile = plan(tuple(x.shape)) if x.dtype == torch.bfloat16 else Tile(0, 0, 0, 0)
    # 16-byte halo loads need an aligned tensor and rows of whole 16-byte chunks
    vector = x.data_ptr() % 16 == 0 and wd % 8 == 0
    out = torch.empty_like(x)
    status = cuda_lib.library().dpt_conv3d_k3_fwd(
        x.data_ptr(), wt.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), n, c, d, h, wd, cuda_lib.DTYPE_CODES[x.dtype], *tile, int(vector),
        cuda_lib.stream_of(x))
    cuda_lib.check(status, "conv3d_k3")
    conv3d_k3.launches += 1
    return out


def _direct(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    if x.device.type == "cpu":
        return plain_conv3d_k3(x, w, b)
    return _launch(x, w, b)


def conv3d_k3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Same-size 3×3×3 conv on ``(N, C, D, H, W)``, C ∈ {16, 32, 64}: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. Differentiable
    (the backward recomputes the plain version)."""
    if needs_grad(x, w, b):
        return PlainBackward.apply(_direct, plain_conv3d_k3, conv3d_k3, {}, x, w, b)
    return _direct(x, w, b)


conv3d_k3.launches = 0
conv3d_k3.recomputes = 0
