"""K1: multi-head self-attention (counterpart of
dose_prediction_tpu/kernels/attention.py::fused_attention).

The kernel (csrc/attention.cu) replaces the Pallas kernel
dose_prediction_tpu/kernels/attention.py:26 (``_kernel``, launched by
``pl.pallas_call`` at :59). On the H100 the bytes bound it in bfloat16
(L/2 operations per byte, under the card's 295) and the operations in
float32; as written, its float32 FMAs limit it in both. Its design, one
block per (batch·head, 64-query tile) with K/V streamed through shared
memory under an online float32 softmax, is described in the source.
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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    status = cuda_lib.library().dpt_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n * h, l, dh,
        cuda_lib.DTYPE_CODES[q.dtype], dh ** -0.5, cuda_lib.stream_of(q))
    cuda_lib.check(status, "fused_attention")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
fused_attention.recomputes = 0
