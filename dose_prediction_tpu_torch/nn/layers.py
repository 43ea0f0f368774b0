"""Leaf layers (counterpart of dose_prediction_tpu/nn/layers.py).

Subclasses of torch's own modules, so parameters keep torch layouts and names
(``weight``, ``bias``, ``running_mean``...), with forwards that run the port's
ops: weights are cast to the input's dtype at use (parameters stay float32,
as in the JAX layers), norms compute in float32, and every InstanceNorm goes
through kernel K2's wrapper.
"""

from __future__ import annotations

import torch
from torch import nn

from dose_prediction_tpu_torch import ops
from dose_prediction_tpu_torch.kernels import instance_norm as k2


class Conv3d(nn.Conv3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.conv3d(x, self.weight, self.bias, stride=self.stride,
                          padding=self.padding, dilation=self.dilation, groups=self.groups)


class ConvTranspose3d(nn.ConvTranspose3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.conv_transpose3d(x, self.weight, self.bias, stride=self.stride,
                                    padding=self.padding, output_padding=self.output_padding)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return nn.functional.linear(x, self.weight.to(x.dtype), b)


class InstanceNorm3d(nn.InstanceNorm3d):
    """InstanceNorm3d (``affine`` as at each reference usage site), through
    kernel K2 with no activation, as nn/layers.py:116-120 calls it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return k2.instance_norm_act(x, self.weight, self.bias, eps=self.eps)


class BatchNorm3d(nn.BatchNorm3d):
    """BatchNorm3d: running statistics in eval, batch statistics (and a
    running-statistics update) in training."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, new_mean, new_var = ops.batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            training=self.training, momentum=self.momentum, eps=self.eps)
        if self.training:
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
