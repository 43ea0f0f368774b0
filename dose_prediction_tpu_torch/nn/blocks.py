"""C3D U-Net blocks (counterpart of dose_prediction_tpu/nn/blocks.py;
reference DosePrediction/Models/Networks/c3d.py:11-38).

SingleConv = Conv3d(bias) + InstanceNorm(affine) + ReLU;
UpConv = trilinear ×2 (align_corners=True) + the same conv stage.
"""

from __future__ import annotations

import torch
from torch import nn

from dose_prediction_tpu_torch import ops
from dose_prediction_tpu_torch.nn.layers import Activation, Conv3d, InstanceNorm3d


def _conv_norm_relu(cin: int, cout: int, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(Conv3d(cin, cout, 3, stride=stride, padding=1, bias=True),
                         InstanceNorm3d(cout, affine=True), Activation("relu"))


class SingleConv(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.single_conv = _conv_norm_relu(cin, cout, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.single_conv(x)


class UpConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = _conv_norm_relu(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(ops.upsample3d(x, 2, mode="trilinear", align_corners=True))
