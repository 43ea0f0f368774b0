"""Leaf layers (counterpart of dose_prediction_tpu/nn/layers.py).

Subclasses of torch's own modules, so parameters keep torch layouts and names
(``weight``, ``bias``, ``running_mean``...), with forwards that run the port's
ops: weights are cast to the input's dtype at use (parameters stay float32,
as in the JAX layers), norms compute in float32, and InstanceNorm goes
through kernel K2's wrapper where ``DPT_PALLAS_IN`` routes it (core/config.py).
"""

from __future__ import annotations

import torch
from torch import nn

from dose_prediction_tpu_torch import ops
from dose_prediction_tpu_torch.core.config import FLAGS
from dose_prediction_tpu_torch.kernels import instance_norm as k2
from dose_prediction_tpu_torch.nn import remat


class Conv3d(nn.Conv3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.conv3d(x, self.weight, self.bias, stride=self.stride,
                          padding=self.padding, dilation=self.dilation, groups=self.groups)


class ConvTranspose3d(nn.ConvTranspose3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.conv_transpose3d(x, self.weight, self.bias, stride=self.stride,
                                    padding=self.padding, output_padding=self.output_padding)


# torch.addmm takes out_dtype (a float32 result from bfloat16 operands) on
# CUDA from PyTorch 2.8 on (aten::addmm.dtype); the CPU build has no kernel
# for it.
ADDMM_OUT_DTYPE = tuple(int(v) for v in torch.__version__.split(".")[:2]) >= (2, 8)


def linear_f32_sum(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x·wᵀ + b in float32 from low-precision ``x`` and ``w`` (exact products,
    float32 sums) and a float32 ``b``."""
    if x.device.type == "cuda" and ADDMM_OUT_DTYPE:
        y = torch.addmm(b, x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])
    # a float32 product of the same values (on a card, without TF32)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return nn.functional.linear(x.float(), w.float(), b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class _LinearF32Sum(torch.autograd.Function):
    """``linear_f32_sum`` (whose CUDA route, addmm with out_dtype, has no
    derivative in PyTorch). The backward takes the products a bf16
    ``F.linear`` takes, and sums the bias gradient in float32."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return linear_f32_sum(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        need_x, need_w, need_b = ctx.needs_input_grad
        gx = g.to(x.dtype) @ w if need_x else None
        gw = g2.to(x.dtype).t() @ x.reshape(-1, x.shape[-1]) if need_w else None
        return gx, gw, g2.sum(0) if need_b else None


class Linear(nn.Linear):
    """In a low-precision dtype with a bias, as the JAX ``Dense``
    (dose_prediction_tpu/nn/layers.py:180-184): the product with a float32
    result, plus the float32 bias, rounded once to the input dtype. In
    float32, or without a bias, one ``F.linear`` (cuBLAS rounds its float32
    sum once)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if self.bias is None:
            return nn.functional.linear(x, w)
        if x.dtype == torch.float32:
            return nn.functional.linear(x, w, self.bias)
        return _LinearF32Sum.apply(x, w, self.bias.float()).to(x.dtype)


class InstanceNorm3d(nn.InstanceNorm3d):
    """InstanceNorm3d (``affine`` as at each reference usage site): through
    kernel K2 with no activation, as nn/layers.py:113-121 calls it, or, with
    ``DPT_PALLAS_IN=0``, through ops.instance_norm."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if FLAGS.k2_instance_norm():
            return k2.instance_norm_act(x, self.weight, self.bias, eps=self.eps)
        return ops.instance_norm(x, self.weight, self.bias, eps=self.eps)


class BatchNorm3d(nn.BatchNorm3d):
    """BatchNorm3d: running statistics in eval, batch statistics (and a
    running-statistics update) in training. A checkpoint's recompute
    (nn/remat.py) leaves the running statistics as the forward left them."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, new_mean, new_var = ops.batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            training=self.training, momentum=self.momentum, eps=self.eps)
        if self.training and remat.updates_batch_stats():
            with torch.no_grad():
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
                self.num_batches_tracked.add_(1)
        return y


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.layer_norm(x, self.weight, self.bias, eps=self.eps)


class Activation(nn.Module):
    """A parameter-free activation by name (ops.get_act), in the slot the
    reference's nn.ReLU / nn.Mish / nn.LeakyReLU modules hold."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        self.fn = ops.get_act(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def extra_repr(self) -> str:
        return self.name
