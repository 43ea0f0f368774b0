"""K1: multi-head self-attention (counterpart of
dose_prediction_tpu/kernels/attention.py::fused_attention).

The kernel (csrc/attention.cu) replaces the Pallas kernel
dose_prediction_tpu/kernels/attention.py:26 (``_kernel``, launched by
``pl.pallas_call`` at :59). On the H100 the bytes bound it in bfloat16
(L/2 operations per byte, under the card's 295) and the operations in
float32. bfloat16 runs in the flash-attention-2 pattern on the tensor
cores (mma.sync m16n8k16): Q held in registers, K and V streamed in
64-key tiles through a 2-stage cp.async ring, scores, online softmax and
probabilities in registers, probabilities rounded to bf16 before P·V as
the JAX reference rounds them, the row sum in float32. ``bf16_tiling``
chooses a block's warps by shape: query-row warps where the grid already
fills the card, key-split warps (combined at the end) where it would
not. float32 keeps FMAs in full float32, the exact-order path the float32
parity checks rely on. The source describes both.
``plain_attention`` is
the same function in PyTorch, step for step the JAX package's
``xla_attention`` (:41-48): float32 scores and softmax, probabilities cast
to the input dtype, float32 accumulation. The backward recomputes it
(kernels/autograd.py), as the JAX custom VJP (:74-89) differentiates
``xla_attention``.
"""

from __future__ import annotations

import torch

from dose_prediction_tpu_torch.kernels import cuda_lib
from dose_prediction_tpu_torch.kernels.autograd import PlainBackward, needs_grad

HEAD_DIMS = (32, 64, 128)
# bfloat16 block shapes (query-row warps, key-split warps), fewest key splits
# first; every one has four warps and 16 · query-row warps rows
TILINGS = ((4, 1), (2, 2), (1, 4))


def bf16_tiling(bh: int, length: int, sms: int) -> tuple[int, int]:
    """The bfloat16 kernel's (query-row warps, key-split warps) for ``bh``
    (batch · heads) sequences of ``length`` on a card with ``sms`` SMs: the
    fewest key splits whose grid has at least one block per two SMs, else
    the most. A key split shortens each warp's sequential run of key tiles,
    but a block of fewer query rows reads all of K and V again from L2; on
    the H100 the trade turns at about half a block per SM (chip_smoke.py
    times every block shape at the main path's shapes)."""
    for wm, wn in TILINGS:
        if 2 * bh * -(-length // (16 * wm)) >= sms:
            return wm, wn
    return TILINGS[-1]


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(Q Kᵀ · Dh^-½) V on ``(N, heads, L, Dh)`` tensors."""
    hd = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(scores * hd ** -0.5, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """MHSA on ``(N, heads, L, Dh)``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Differentiable (the backward recomputes
    the plain version)."""
    if needs_grad(q, k, v):
        return PlainBackward.apply(_direct, plain_attention, fused_attention, {}, q, k, v)
    return _direct(q, k, v)


def _direct(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return plain_attention(q, k, v)
    cuda_lib.require_cuda(q, "fused_attention")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused_attention: q, k, v must share one (N, H, L, Dh) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device or v.device != q.device:
        raise ValueError("fused_attention: q, k, v must share dtype and device")
    n, h, l, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"fused_attention: head dim {dh} not in {HEAD_DIMS}")
    # contiguous and 16-byte aligned (the bf16 kernel copies 16 bytes at a time)
    q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty_like(q)
    wm, wn = bf16_tiling(n * h, l, torch.cuda.get_device_properties(q.device)
                         .multi_processor_count)
    status = cuda_lib.library().dpt_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n * h, l, dh,
        cuda_lib.DTYPE_CODES[q.dtype], wm, wn, dh ** -0.5, cuda_lib.stream_of(q))
    cuda_lib.check(status, "fused_attention")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
fused_attention.recomputes = 0
