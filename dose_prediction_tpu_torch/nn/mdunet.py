"""Multi-scale / multi-kernel conv blocks (counterpart of
dose_prediction_tpu/nn/mdunet.py, all three families).

The reference keeps three divergent copies of these blocks; ``family``
selects between them, with the reference's torch module names:

- 'seg' (OARSegmentation/Models/Nets/blocks_MDUNet.py): Conv31 is k3 ‖ k7,
  each branch wrapped as Sequential(conv block, InstanceNorm, act) and the
  1×1 fuse as Sequential(conv, InstanceNorm, act). Quirks kept: the k3
  branch's inner activations are always ReLU, and the k7 branch uses
  BatchNorm3d + ReLU inside. DualDilatedBlock: k3 ‖ dil-2 k3 ‖ dil-3 k3
  (InstanceNorm + act inside), IN + act on the fuse.
- 'dose' (DosePrediction/Models/Nets/blocks_MDUNet.py, and the identical
  OldModels copy that TranSeg's 'old' family imports): BatchNorm3d + ReLU
  inside every branch, bare branches, a bare 1×1 fuse, ``act`` ignored;
  DualDilatedBlock has two branches (k3 ‖ dil-2 k3, the latter ``conv_5``).
- 'ablation' (blocks_MDUNet_ablation.py): BatchNorm3d + Mish inside the
  k3/k7 branches, BatchNorm3d + ReLU inside the dilated ones; Conv31 keeps
  the IN outer stages, with the k3 branch's outer activation always Mish;
  DualDilatedBlock has three branches and a BatchNorm + ReLU fuse.

``separable`` (``k7_mode='separable'``) replaces each k7 conv of the k7
branch with a linear chain of three 1-D convs, (k,1,1) C_in→C_out, then
(1,k,1) and (1,1,k) C_out→C_out, the bias on the last only (JAX
mdunet.py:74-86); nn/separable.py warm-starts it from dense weights.
MultiScaleConv (OARSegmentation/Models/Nets/convs.py:41-61): bias-free
k3 ‖ k5 ‖ k7 convs with ReLU, then a bias-free 1×1 conv and ReLU.
"""

from __future__ import annotations

import torch
from torch import nn

from dose_prediction_tpu_torch import ops
from dose_prediction_tpu_torch.nn.layers import Activation, BatchNorm3d, Conv3d, InstanceNorm3d

FAMILIES = ("seg", "dose", "ablation")
K7_MODES = ("dense", "separable")


class SeparableConv3d(nn.Module):
    """A k×k×k conv's separable stand-in: ``d`` (k,1,1) C_in→C_out, ``h``
    (1,k,1) and ``w`` (1,1,k) C_out→C_out, bias on ``w`` only."""

    def __init__(self, cin: int, cout: int, kernel_size: int, dilation: int = 1):
        super().__init__()
        k, pad = kernel_size, dilation * (kernel_size - 1) // 2
        self.d = Conv3d(cin, cout, (k, 1, 1), padding=(pad, 0, 0), dilation=dilation, bias=False)
        self.h = Conv3d(cout, cout, (1, k, 1), padding=(0, pad, 0), dilation=dilation,
                        bias=False)
        self.w = Conv3d(cout, cout, (1, 1, k), padding=(0, 0, pad), dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w(self.h(self.d(x)))


class ConvBlockK(nn.Module):
    """Two k×k×k convs (bias), each followed by a norm ('instance', without
    affine, or 'batch') and ``act``: ``conv`` = Sequential(conv, norm, act,
    conv, norm, act), the reference's conv_block_3 / _7 /
    dilated_conv_block_5 / _7."""

    def __init__(self, cin: int, cout: int, kernel_size: int, norm: str = "instance",
                 act: str = "relu", dilation: int = 1, separable: bool = False):
        super().__init__()
        pad = dilation * (kernel_size - 1) // 2
        make_norm = {"instance": InstanceNorm3d, "batch": BatchNorm3d}[norm]

        def conv(i: int) -> nn.Module:
            if separable and kernel_size > 1:
                return SeparableConv3d(i, cout, kernel_size, dilation)
            return Conv3d(i, cout, kernel_size, padding=pad, dilation=dilation, bias=True)

        self.conv = nn.Sequential(conv(cin), make_norm(cout), Activation(act),
                                  conv(cout), make_norm(cout), Activation(act))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def _outer(block: nn.Module, cout: int, act: str) -> nn.Sequential:
    """Sequential(block, InstanceNorm (no affine), act): a branch's or the
    fuse's outer stage."""
    return nn.Sequential(block, InstanceNorm3d(cout), Activation(act))


def _check_family(family: str) -> None:
    if family not in FAMILIES:
        raise ValueError(f"unknown block family {family!r}; options: {FAMILIES}")


class Conv31(nn.Module):
    """conv_3_1: k3 branch ``conv_3`` ‖ k7 branch ``conv_7`` → concat → 1×1
    fuse ``conv``, by family (module docstring)."""

    def __init__(self, cin: int, cout: int, act: str = "relu", family: str = "seg",
                 k7_mode: str = "dense"):
        super().__init__()
        _check_family(family)
        if k7_mode not in K7_MODES:
            raise ValueError(f"unknown k7_mode {k7_mode!r}; options: {K7_MODES}")
        sep = k7_mode == "separable"
        if family == "dose":
            self.conv_3 = ConvBlockK(cin, cout, 3, "batch")
            self.conv_7 = ConvBlockK(cin, cout, 7, "batch", separable=sep)
            self.conv = Conv3d(2 * cout, cout, 1, bias=True)
            return
        if family == "seg":      # k3 inner acts fixed to ReLU; k7 BatchNorm + ReLU inside
            k3, k7, k3_act = (ConvBlockK(cin, cout, 3),
                              ConvBlockK(cin, cout, 7, "batch", separable=sep), act)
        else:                    # ablation: BatchNorm + Mish inside, k3's outer act Mish
            k3, k7, k3_act = (ConvBlockK(cin, cout, 3, "batch", "mish"),
                              ConvBlockK(cin, cout, 7, "batch", "mish", separable=sep), "mish")
        self.conv_3 = _outer(k3, cout, k3_act)
        self.conv_7 = _outer(k7, cout, act)
        self.conv = _outer(Conv3d(2 * cout, cout, 1, bias=True), cout, act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat([self.conv_3(x), self.conv_7(x)], dim=1))


class DualDilatedBlock(nn.Module):
    """Multi-dilation block: ``conv_3`` (k3) ‖ ``conv_5`` (dil-2 k3) ‖
    ``conv_7`` (dil-3 k3; not in the 'dose' family) → concat → 1×1 fuse
    ``conv``, by family (module docstring)."""

    def __init__(self, cin: int, cout: int, act: str = "relu", family: str = "seg"):
        super().__init__()
        _check_family(family)
        if family == "dose":
            self.conv_3 = ConvBlockK(cin, cout, 3, "batch")
            self.conv_5 = ConvBlockK(cin, cout, 3, "batch", dilation=2)
            self.conv = Conv3d(2 * cout, cout, 1, bias=True)
            return
        if family == "ablation":
            self.conv_3 = ConvBlockK(cin, cout, 3, "batch", "mish")
            self.conv_5 = ConvBlockK(cin, cout, 3, "batch", dilation=2)
            self.conv_7 = ConvBlockK(cin, cout, 3, "batch", dilation=3)
            self.conv = nn.Sequential(Conv3d(3 * cout, cout, 1, bias=True), BatchNorm3d(cout),
                                      Activation("relu"))
            return
        self.conv_3 = ConvBlockK(cin, cout, 3, "instance", act)
        self.conv_5 = ConvBlockK(cin, cout, 3, "instance", act, dilation=2)
        self.conv_7 = ConvBlockK(cin, cout, 3, "instance", act, dilation=3)
        self.conv = _outer(Conv3d(3 * cout, cout, 1, bias=True), cout, act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self.conv_3(x), self.conv_5(x)]
        if hasattr(self, "conv_7"):
            branches.append(self.conv_7(x))
        return self.conv(torch.cat(branches, dim=1))


def AblationConv31(cin: int, cout: int, act: str = "relu") -> Conv31:
    """The ablation conv_3_1 (blocks_MDUNet_ablation.py:41-71)."""
    return Conv31(cin, cout, act, family="ablation")


def AblationDualDilatedBlock(cin: int, cout: int) -> DualDilatedBlock:
    """The ablation DualDilatedBlock (blocks_MDUNet_ablation.py:118-140)."""
    return DualDilatedBlock(cin, cout, family="ablation")


class MultiScaleConv(nn.Module):
    """k3 ‖ k5 ‖ k7 (bias-free conv + ReLU, no norm) → concat → bias-free
    1×1 conv ``conv1`` + ReLU (convs.py:41-61)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv3 = Conv3d(cin, cout, 3, padding=1, bias=False)
        self.conv5 = Conv3d(cin, cout, 5, padding=2, bias=False)
        self.conv7 = Conv3d(cin, cout, 7, padding=3, bias=False)
        self.conv1 = Conv3d(3 * cout, cout, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([ops.relu(c(x)) for c in (self.conv3, self.conv5, self.conv7)], dim=1)
        return ops.relu(self.conv1(y))


class MultiUnetBasicBlock(nn.Module):
    """The reference's wrapper holding conv_3_1 (``multiS_conv``) or the
    DualDilatedBlock as ``cov_``."""

    def __init__(self, cin: int, cout: int, act: str = "relu", family: str = "seg",
                 k7_mode: str = "dense", multiS_conv: bool = True):
        super().__init__()
        self.cov_ = (Conv31(cin, cout, act, family, k7_mode) if multiS_conv
                     else DualDilatedBlock(cin, cout, act, family))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cov_(x)
