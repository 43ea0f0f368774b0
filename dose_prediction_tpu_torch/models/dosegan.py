"""DoseGAN, the paper's pix2pix-style 3D GAN baseline (counterpart of
dose_prediction_tpu/models/dosegan.py; reference
DosePrediction/Models/Networks/dosegan.py).

The generator is a recursive U-Net with attention-gated skips
(UnetSkipConnectionBlock3d :115, AttGate :88, whose ``initial_conv`` is
applied to both gate inputs), with same-size dilated k4 convolutions
(k4 s1 p3 d2) at its stem and head, k4 s2 p1 convolutions down and
transposed k4 s2 p1 convolutions up. The critic is the PatchGAN-style
NLayerDiscriminator (:177) of attention BlockDiscriminators (:158). Every
norm is a BatchNorm3d (momentum 0.1, unbiased running variance); no TPU
kernel runs here, and the convolutions run on cuDNN.

Module names are the reference's, so its state dicts load as they are:
the generator's ``initial_block.{0,1}``, ``model(.model.3)^d.model.{1,2,5,6}``
(the innermost level ``.model.{1,3,4}``), each level's
``att_gate.{initial_conv,intermediate.1,intermediate.2}`` and
``outer_block.0``; the critic's ``model.{0,1,6,7}`` and
``model.{3,4,5}.{downsample,pooling}.{0,1}`` with their ``att_gate``.
"""

from __future__ import annotations

import torch
from torch import nn

from dose_prediction_tpu_torch.device import resolve_device
from dose_prediction_tpu_torch.models.spec import records_config
from dose_prediction_tpu_torch.nn.layers import BatchNorm3d, Conv3d, ConvTranspose3d


def _same_k4(cin: int, cout: int) -> Conv3d:
    """The size-keeping dilated k4 convolution (k4 s1 p3 d2)."""
    return Conv3d(cin, cout, 4, stride=1, padding=3, dilation=2)


class AttGate(nn.Module):
    """Attention gate (dosegan.py:88): one 1×1 conv ``initial_conv`` on both
    inputs, their sum through ReLU → 1×1 conv → BatchNorm → sigmoid,
    multiplied onto the first input's conv."""

    def __init__(self, c: int):
        super().__init__()
        self.initial_conv = Conv3d(c, c, 1)
        self.intermediate = nn.Sequential(nn.ReLU(), Conv3d(c, c, 1), BatchNorm3d(c),
                                          nn.Sigmoid())

    def forward(self, down_inp: torch.Tensor, sample_inp: torch.Tensor) -> torch.Tensor:
        z1 = self.initial_conv(down_inp)
        return z1 * self.intermediate(z1 + self.initial_conv(sample_inp))


class UnetSkipBlock(nn.Module):
    """One level of the generator (dosegan.py:115-155) and, through
    ``model.3``, the levels below it: ``depth`` of them (0 = innermost,
    which has no down-norm and no submodule). The output has 2 × ``in_nc``
    channels: cat(att_gate(z, x), z). Widths (:63-74): ``down_nc`` below,
    the next level's capped at ``max_nc`` (8·ngf)."""

    def __init__(self, in_nc: int, down_nc: int, depth: int, max_nc: int):
        super().__init__()
        downconv = Conv3d(in_nc, down_nc, 4, stride=2, padding=1, bias=False)
        if depth == 0:
            inner, up_nc = [], down_nc
        else:
            inner = [BatchNorm3d(down_nc),
                     UnetSkipBlock(down_nc, min(2 * down_nc, max_nc), depth - 1, max_nc)]
            up_nc = 2 * down_nc
        self.model = nn.Sequential(
            nn.LeakyReLU(0.2), downconv, *inner, nn.ReLU(),
            ConvTranspose3d(up_nc, in_nc, 4, stride=2, padding=1, bias=False),
            BatchNorm3d(in_nc))
        self.att_gate = AttGate(in_nc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.model(x)
        return torch.cat([self.att_gate(z, x), z], dim=1)


class UnetGenerator3D(nn.Module):
    """The generator (dosegan.py:50-85): ``forward(x)`` on ``(N, in_ch, D,
    H, W)``, D, H and W divisible by 2^num_levels, returns the tanh dose
    ``(N, out_ch, D, H, W)``."""

    @records_config
    def __init__(self, in_ch: int = 9, out_ch: int = 1, ngf: int = 64, num_levels: int = 5,
                 device="cuda"):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.initial_block = nn.Sequential(_same_k4(in_ch, ngf), BatchNorm3d(ngf),
                                               nn.LeakyReLU(0.2))
            self.model = UnetSkipBlock(ngf, 2 * ngf, num_levels - 1, 8 * ngf)
            self.outer_block = nn.Sequential(_same_k4(2 * ngf, out_ch), nn.Tanh())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.outer_block(self.model(self.initial_block(x)))


class BlockDiscriminator(nn.Module):
    """A critic block (dosegan.py:158): a k4 s2 p1 down conv and a same-size
    dilated k4 conv, each BatchNorm + LeakyReLU 0.2, attention-gated;
    ``nc`` channels in, 2·nc out."""

    def __init__(self, nc: int):
        super().__init__()
        self.downsample = nn.Sequential(Conv3d(nc, nc, 4, stride=2, padding=1),
                                        BatchNorm3d(nc), nn.LeakyReLU(0.2))
        self.pooling = nn.Sequential(_same_k4(nc, nc), BatchNorm3d(nc), nn.LeakyReLU(0.2))
        self.att_gate = AttGate(nc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z1 = self.downsample(x)
        z2 = self.pooling(z1)
        return torch.cat([self.att_gate(z2, z1), z2], dim=1)


class NLayerDiscriminator(nn.Module):
    """The PatchGAN critic (dosegan.py:177-215): ``forward(x)`` on ``(N,
    in_ch, D, H, W)`` returns one logit a patch, ``(N, 1, D/2^n, H/2^n,
    W/2^n)``. The DoseGAN trainer's critic is unconditional: one dose
    channel in."""

    @records_config
    def __init__(self, in_ch: int = 1, ndf: int = 64, n_layers: int = 3,
                 use_sigmoid: bool = False, device="cuda"):
        super().__init__()
        with torch.device(resolve_device(device)):
            layers = [_same_k4(in_ch, ndf), BatchNorm3d(ndf), nn.LeakyReLU(0.2)]
            layers += [BlockDiscriminator(2 ** n * ndf) for n in range(n_layers)]
            layers += [_same_k4(2 ** n_layers * ndf, 1), BatchNorm3d(1), nn.LeakyReLU(0.2)]
            if use_sigmoid:
                layers.append(nn.Sigmoid())
            self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)
