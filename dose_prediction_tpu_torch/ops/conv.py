"""3D convolutions and pooling on NCDHW tensors (counterpart of the conv3d /
conv_transpose3d / max_pool3d / avg_pool3d semantics of
dose_prediction_tpu/ops/conv.py).

Both go to cuDNN through torch, as the JAX package leaves these convolutions
to XLA; its TPU-only rewrites (decomposed, lanefold, depth-phase, matmul)
have no counterpart here. The one exception is its ``method="pallas"``
routing (ops/conv.py:217-234): with ``method="k3"``, or ``method="auto"``
and ``DPT_PALLAS_CONV`` set to '1' or 'tight' (core/config.py), a same-size
3×3×3 conv with C_in == C_out ∈ {16, 32, 64} goes to kernel K3. Weights
use torch layouts: (O, I, kD, kH, kW) for conv3d and (I, O, kD, kH, kW)
for conv_transpose3d. The weight is cast to the input's dtype, as the JAX
layers cast their float32 params to the compute dtype. The bias is added as
the JAX package adds it (ops/conv.py:45-59, :307-309, :327-329): in float32
cuDNN takes it; in bfloat16 the convolution runs without it, rounding its sum
to bf16, and the float32 bias is then added in place, in float32 with one
rounding (one extra pass over each biased bf16 output). Its gradient is the
cotangent summed in float32, as JAX differentiates its float32 add.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dose_prediction_tpu_torch.core.config import FLAGS, K3_ON
from dose_prediction_tpu_torch.kernels import conv3d as k3
from dose_prediction_tpu_torch.kernels.autograd import needs_grad

METHODS = ("auto", "k3")


class _AddBiasF32(torch.autograd.Function):
    """``y.add_(b)`` in place: a low-precision ``y`` plus a float32 ``b``,
    computed in float32 and rounded once. The backward sums the bias
    gradient in float32 (the in-place add's own backward would sum it in
    ``y``'s dtype)."""

    @staticmethod
    def forward(ctx, y, b):
        ctx.mark_dirty(y)
        return y.add_(b.view(1, -1, 1, 1, 1))

    @staticmethod
    def backward(ctx, g):
        return g, g.sum((0, 2, 3, 4), dtype=torch.float32) if ctx.needs_input_grad[1] else None


def _biased(conv, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
            **kwargs) -> torch.Tensor:
    """``conv(x, w, b)`` in float32; in other dtypes the sum rounded to
    ``x.dtype`` plus the float32 bias, rounded again."""
    if b is None or x.dtype == torch.float32:
        return conv(x, w, b, **kwargs)
    return add_bias(conv(x, w, None, **kwargs), b.float())


def add_bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A low-precision ``y`` plus the float32 bias ``b`` (per channel),
    computed in float32 and rounded once, in place."""
    if needs_grad(y, b):
        return _AddBiasF32.apply(y, b)
    return y.add_(b.view(1, -1, 1, 1, 1))    # no autograd: without the Function's host cost


def _triple(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


def k3_eligible(x: torch.Tensor, w: torch.Tensor, *, stride=1, padding=0, dilation=1,
                groups: int = 1) -> bool:
    """The JAX package's predicate for its Pallas k3 kernel
    (dose_prediction_tpu/ops/conv.py:224-231), in torch layouts."""
    return (groups == 1 and tuple(w.shape[2:]) == (3, 3, 3)
            and _triple(stride) == (1, 1, 1) and _triple(dilation) == (1, 1, 1)
            and _triple(padding) == (1, 1, 1)
            and x.shape[1] == w.shape[0] and x.shape[1] in k3.CHANNELS)


def conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride=1, padding=0, dilation=1, groups: int = 1,
           method: str = "auto") -> torch.Tensor:
    """Conv3d with symmetric zero padding (PyTorch semantics).

    ``method``: 'auto' (K3 where ``FLAGS.use_k3_conv3d`` routes it, else
    cuDNN) or 'k3' (K3 where eligible, else cuDNN). K3 gets the
    weight in the input's dtype and the bias as it is (added in float32),
    as the JAX layer hands its kernel."""
    if method not in METHODS:
        raise ValueError(f"conv3d: method {method!r} not in {METHODS}")
    use_k3 = method == "k3" or (method == "auto" and FLAGS.use_k3_conv3d in K3_ON)
    if use_k3 and k3_eligible(x, w, stride=stride, padding=padding, dilation=dilation,
                              groups=groups):
        return k3.conv3d_k3(x, w.to(x.dtype), b)
    return _biased(F.conv3d, x, w.to(x.dtype), b, stride=stride, padding=padding,
                   dilation=dilation, groups=groups)


def conv_transpose3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                     stride=1, padding=0, output_padding=0) -> torch.Tensor:
    """ConvTranspose3d; ``w`` is (Cin, Cout, kD, kH, kW)."""
    return _biased(F.conv_transpose3d, x, w.to(x.dtype), b, stride=stride, padding=padding,
                   output_padding=output_padding)


def max_pool3d(x: torch.Tensor, window=2, stride=None) -> torch.Tensor:
    """3D max pooling without padding (JAX ops/conv.py:353; the reference's
    MaxPool3d(2) in hdunet.py:44)."""
    return F.max_pool3d(x, _triple(window), _triple(window if stride is None else stride))


def avg_pool3d(x: torch.Tensor, window=2, stride=None) -> torch.Tensor:
    """3D average pooling without padding, summed in float32 and rounded
    once to ``x.dtype`` (JAX ops/conv.py:368)."""
    return F.avg_pool3d(x.float(), _triple(window),
                        _triple(window if stride is None else stride)).to(x.dtype)
