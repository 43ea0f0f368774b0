"""UNETR block family (counterpart of dose_prediction_tpu/nn/unetr.py:29-189;
MONAI 0.7 semantics).

- Convolution: MONAI's conv-only Convolution, a Sequential holding ``conv``
  (bias-free by default; transposed convs are k = s = 2).
- UnetResBlock: conv/IN(affine)/LeakyReLU(0.01) ×2 with a 1×1 conv + IN
  residual projection when the channel count changes.
- UnetBasicBlock: conv/IN(affine)/LeakyReLU(0.01) ×2, no residual.
- UnetrBasicBlock: one UnetResBlock named ``layer``.
- UnetrPrUpBlock: a transposed conv, then ``num_layer`` × (transposed conv +
  UnetResBlock).
- UnetrUpBlock (plain UNETR decoder stage, :119-145): bias-free transposed
  conv, concat the skip, then UnetResBlock (``res_block``) or
  UnetBasicBlock, named ``conv_block``.
- ModifiedUnetrUpBlock: transposed conv, concat the skip, then Conv31
  (``multiS_conv``) or DualDilatedBlock of the block ``family``, with
  ``k7_mode`` (nn/mdunet.py; :146-178).
- ModifiedUnetOutBlock: 1×1 conv with bias.
"""

from __future__ import annotations

import torch
from torch import nn

from dose_prediction_tpu_torch import ops
from dose_prediction_tpu_torch.nn.layers import Conv3d, ConvTranspose3d, InstanceNorm3d
from dose_prediction_tpu_torch.nn.mdunet import MultiUnetBasicBlock


class Convolution(nn.Sequential):
    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1, *,
                 bias: bool = False, transposed: bool = False):
        super().__init__()
        if transposed:
            conv = ConvTranspose3d(cin, cout, kernel_size, stride=stride, bias=bias)
        else:
            conv = Conv3d(cin, cout, kernel_size, stride=stride,
                          padding=(kernel_size - 1) // 2, bias=bias)
        self.add_module("conv", conv)


class UnetResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1):
        super().__init__()
        self.conv1 = Convolution(cin, cout, kernel_size, stride)
        self.conv2 = Convolution(cout, cout, kernel_size)
        self.norm1 = InstanceNorm3d(cout, affine=True)
        self.norm2 = InstanceNorm3d(cout, affine=True)
        self.downsample = cin != cout or stride != 1
        if self.downsample:
            self.conv3 = Convolution(cin, cout, 1, stride)
            self.norm3 = InstanceNorm3d(cout, affine=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = ops.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        h = self.norm2(self.conv2(h))
        residual = self.norm3(self.conv3(x)) if self.downsample else x
        return ops.leaky_relu(h + residual, 0.01)


class UnetBasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1):
        super().__init__()
        self.conv1 = Convolution(cin, cout, kernel_size, stride)
        self.conv2 = Convolution(cout, cout, kernel_size)
        self.norm1 = InstanceNorm3d(cout, affine=True)
        self.norm2 = InstanceNorm3d(cout, affine=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = ops.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        return ops.leaky_relu(self.norm2(self.conv2(h)), 0.01)


class UnetrBasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.layer = UnetResBlock(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class UnetrPrUpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, num_layer: int):
        super().__init__()
        self.transp_conv_init = Convolution(cin, cout, 2, 2, transposed=True)
        self.blocks = nn.ModuleList([
            nn.Sequential(Convolution(cout, cout, 2, 2, transposed=True),
                          UnetResBlock(cout, cout))
            for _ in range(num_layer)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.transp_conv_init(x)
        for blk in self.blocks:
            x = blk(x)
        return x


class UnetrUpBlock(nn.Module):
    """``skip_ch``: the skip's channels where they differ from ``cout``."""

    def __init__(self, cin: int, cout: int, res_block: bool = False, skip_ch=None):
        super().__init__()
        self.transp_conv = Convolution(cin, cout, 2, 2, transposed=True)
        block = UnetResBlock if res_block else UnetBasicBlock
        self.conv_block = block(cout + (cout if skip_ch is None else skip_ch), cout)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=1))


class ModifiedUnetrUpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, act: str = "relu", family: str = "seg",
                 k7_mode: str = "dense", multiS_conv: bool = True):
        super().__init__()
        self.transp_conv = Convolution(cin, cout, 2, 2, transposed=True)
        self.conv_block = MultiUnetBasicBlock(2 * cout, cout, act, family, k7_mode, multiS_conv)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=1))


class ModifiedUnetOutBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Convolution(cin, cout, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)
