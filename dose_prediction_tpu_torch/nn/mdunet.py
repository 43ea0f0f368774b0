"""Seg-family multi-scale conv block (counterpart of the family='seg' path of
dose_prediction_tpu/nn/mdunet.py; reference
OARSegmentation/Models/Nets/blocks_MDUNet.py conv_3_1 :132-157).

Conv31 = k3 branch ‖ k7 branch → concat → 1×1 fuse, each with an outer
InstanceNorm + act. Reference quirks kept: the k3 branch's inner
activations are always ReLU (conv_block_3 is built without the act
argument), and the k7 branch uses BatchNorm3d + ReLU inside.
"""

from __future__ import annotations

import torch
from torch import nn

from dose_prediction_tpu_torch.nn.layers import Activation, BatchNorm3d, Conv3d, InstanceNorm3d


class ConvBlockK(nn.Module):
    """Two k×k×k convs (bias), each followed by a norm and ReLU:
    InstanceNorm (no affine) for conv_block_3, BatchNorm for conv_block_7."""

    def __init__(self, cin: int, cout: int, kernel_size: int, norm: str):
        super().__init__()
        pad = (kernel_size - 1) // 2
        make_norm = {"instance": InstanceNorm3d, "batch": BatchNorm3d}[norm]
        self.conv = nn.Sequential(
            Conv3d(cin, cout, kernel_size, padding=pad, bias=True), make_norm(cout),
            Activation("relu"),
            Conv3d(cout, cout, kernel_size, padding=pad, bias=True), make_norm(cout),
            Activation("relu"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Conv31(nn.Module):
    def __init__(self, cin: int, cout: int, act: str = "relu"):
        super().__init__()
        self.conv_3 = nn.Sequential(ConvBlockK(cin, cout, 3, "instance"),
                                    InstanceNorm3d(cout), Activation(act))
        self.conv_7 = nn.Sequential(ConvBlockK(cin, cout, 7, "batch"),
                                    InstanceNorm3d(cout), Activation(act))
        self.conv = nn.Sequential(Conv3d(2 * cout, cout, 1, bias=True),
                                  InstanceNorm3d(cout), Activation(act))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat([self.conv_3(x), self.conv_7(x)], dim=1))


class MultiUnetBasicBlock(nn.Module):
    """The reference's wrapper holding conv_3_1 as ``cov_``."""

    def __init__(self, cin: int, cout: int, act: str = "relu"):
        super().__init__()
        self.cov_ = Conv31(cin, cout, act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cov_(x)
