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

``plain_conv3d_k3`` is the same function in PyTorch: a float32 convolution
rounded to the input dtype, plus the float32 bias, rounded again. On a card path only the
backward recomputes it (kernels/autograd.py), as the JAX custom VJP
differentiates its XLA reference (:156-182).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dose_prediction_tpu_torch.kernels import cuda_lib
from dose_prediction_tpu_torch.kernels.autograd import PlainBackward, needs_grad

CHANNELS = (16, 32, 64)


def plain_conv3d_k3(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor | None = None) -> torch.Tensor:
    """Same-size 3×3×3 conv of ``(N, C, D, H, W)`` with ``w (C, C, 3, 3, 3)``
    and ``b (C,)``: the float32 sum cast to ``x.dtype``, then the float32
    bias added in float32 and the result cast to ``x.dtype`` again."""
    y = F.conv3d(x.float(), w.float(), padding=1).to(x.dtype)
    if b is not None:
        y = (y.float() + b.float().reshape(1, -1, 1, 1, 1)).to(x.dtype)
    return y


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
    # (C_out, C_in, kd, kh, kw) -> (27, C_in, C_out) in the working dtype
    wt = w.to(x.dtype).permute(2, 3, 4, 1, 0).reshape(27, c, c).contiguous()
    bias = None if b is None else b.float().contiguous()
    out = torch.empty_like(x)
    status = cuda_lib.library().dpt_conv3d_k3_fwd(
        x.data_ptr(), wt.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), n, c, d, h, wd, cuda_lib.DTYPE_CODES[x.dtype], cuda_lib.stream_of(x))
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
