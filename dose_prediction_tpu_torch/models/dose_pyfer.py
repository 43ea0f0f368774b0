"""DOSE-PYFER, the cascade's stage-2 dose model (counterpart of
dose_prediction_tpu/models/dose_pyfer.py; reference
DosePrediction/Models/Networks/dose_pyfer.py Model :325).

net_A = C3D BaseUNet(list_ch_A) → net_B = MainSubsetModel(cat(out_A, x)):
a ViT encoder with UNETR skip pyramids, four ModifiedUnetrUpBlock decoder
stages (seg-family Conv31, act='mish') and 1×1 dose convertors at 1, ½, ¼
and ⅛ resolution; conv_out_A is net_A's 1×1 head. The decoder is the
flagship's multi-scale one (mode_multi_dec=True), its stages Conv31
(``multiS_conv=True``, the default) or the DualDilatedBlock
(``multiS_conv=False``, a choice the reference's search samples,
tune_light_pyfer.py:160-168). The reference's unused ``net_B.out`` head is
left out.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from dose_prediction_tpu_torch.device import resolve_device
from dose_prediction_tpu_torch.models.spec import records_config
from dose_prediction_tpu_torch.models.c3d import BaseUNet
from dose_prediction_tpu_torch.nn import remat
from dose_prediction_tpu_torch.nn.layers import Conv3d
from dose_prediction_tpu_torch.nn.unetr import (
    ModifiedUnetrUpBlock,
    UnetrBasicBlock,
    UnetrPrUpBlock,
    UnetrUpBlock,
)
from dose_prediction_tpu_torch.nn.vit import ViT, tokens_to_volume


class ViTEncoder(nn.Module):
    def __init__(self, in_ch: int, img_size, feature_size: int, hidden: int,
                 mlp_dim: int, num_layers: int, heads: int, patch: int = 16):
        super().__init__()
        self.num_layers = num_layers
        fs = feature_size
        self.vit = ViT(in_ch, img_size, patch, hidden, mlp_dim, num_layers, heads)
        self.skip1 = UnetrBasicBlock(in_ch, fs)
        self.skip2 = UnetrPrUpBlock(hidden, fs * 2, 2)
        self.skip3 = UnetrPrUpBlock(hidden, fs * 4, 1)
        self.skip4 = UnetrPrUpBlock(hidden, fs * 8, 0)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        z, hidden = self.vit(x)
        i, grid = self.num_layers // 4, self.vit.grid(x)
        return [self.skip1(x),
                self.skip2(tokens_to_volume(hidden[i], grid)),
                self.skip3(tokens_to_volume(hidden[2 * i], grid)),
                self.skip4(tokens_to_volume(hidden[3 * i], grid)),
                tokens_to_volume(z, grid)]


class PyMSCDecoder(nn.Module):
    """Four decoder stages (JAX dose_pyfer.py:77-111): ModifiedUnetrUpBlock
    (``mode_multi``; Conv31 or, without ``multiS_conv``, DualDilatedBlock)
    or the plain UnetrUpBlock, InstanceNorm throughout (the JAX module's
    ``norm='batch'`` option, which no model uses, is not ported). ``skip_ch`` gives the skips' channels (decoder1 first) where
    they differ from the stages' own; ``remat_blocks`` recomputes each
    stage's activations in the backward (JAX dose_pyfer.py:83-97)."""

    def __init__(self, feature_size: int, hidden: int, act: str, remat_blocks: bool = False,
                 multiS_conv: bool = True, mode_multi: bool = True, skip_ch=None):
        super().__init__()
        fs = feature_size
        self.remat_blocks = remat_blocks
        kw = dict(act=act, multiS_conv=multiS_conv)
        skip = list(skip_ch) if skip_ch is not None else [None] * 4
        for level, cin, cout in ((4, hidden, fs * 8), (3, fs * 8, fs * 4), (2, fs * 4, fs * 2),
                                 (1, fs * 2, fs)):
            if mode_multi:
                if skip[level - 1] is not None:
                    raise ValueError("skip_ch needs the plain decoder (mode_multi=False)")
                stage = ModifiedUnetrUpBlock(cin, cout, **kw)
            else:
                stage = UnetrUpBlock(cin, cout, skip_ch=skip[level - 1])
            setattr(self, f"decoder{level}", stage)

    def forward(self, enc: List[torch.Tensor]) -> List[torch.Tensor]:
        e1, e2, e3, e4, e5 = enc
        on = self.remat_blocks
        dec4 = remat.checkpoint(self.decoder4, e5, e4, enabled=on)
        dec3 = remat.checkpoint(self.decoder3, dec4, e3, enabled=on)
        dec2 = remat.checkpoint(self.decoder2, dec3, e2, enabled=on)
        dec1 = remat.checkpoint(self.decoder1, dec2, e1, enabled=on)
        return [dec1, dec2, dec3, dec4]


class MainSubsetModel(nn.Module):
    """net_B: ViT encoder + pyramid decoder + deep-supervision heads."""

    def __init__(self, in_ch: int, out_ch: int, img_size, feature_size: int,
                 hidden: int, mlp_dim: int, num_layers: int, heads: int, act: str,
                 remat_blocks: bool = False, multiS_conv: bool = True):
        super().__init__()
        self.encoder = ViTEncoder(in_ch, img_size, feature_size, hidden, mlp_dim,
                                  num_layers, heads)
        self.decoder = PyMSCDecoder(feature_size, hidden, act, remat_blocks, multiS_conv)
        self.dose_convertors = nn.ModuleList(
            [nn.Sequential(Conv3d(feature_size * 2 ** i, out_ch, 1, bias=True))
             for i in range(4)])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        decs = self.decoder(self.encoder(x))
        return [conv(dec) for dec, conv in zip(decs, self.dose_convertors)]


class DosePyfer(nn.Module):
    """The cascade model. ``forward(x)`` on ``(N, in_ch, D, H, W)`` returns
    ``(output_A, [out_full, out_half, out_quarter, out_eighth])``. In train
    mode the BatchNorms of net_B's k7 branches use batch statistics and
    update their running statistics, as the JAX ``batch_stats`` collection.

    Defaults are the flagship config (train_light_pyfer.py:73-83): 9 input
    channels, 128³, feature size 16, an 8-layer ViT-768 with 6 heads, Mish.
    ``img_size`` fixes the ViT's token grid (img_size / 16).
    ``remat_blocks`` recomputes each decoder stage in the backward
    (nn/remat.py); the parameters are the same. ``multiS_conv=False``
    builds the DualDilatedBlock decoder stages (module docstring)."""

    @records_config
    def __init__(self, in_ch: int = 9, out_ch: int = 1, img_size=128,
                 list_ch_A: Sequence[int] = (-1, 16, 32, 64, 128, 256),
                 feature_size: int = 16, hidden_size: int = 768, mlp_dim: int = 3072,
                 num_layers: int = 8, num_heads: int = 6, act: str = "mish",
                 remat_blocks: bool = False, multiS_conv: bool = True, device="cuda"):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.net_A = BaseUNet(in_ch, list_ch_A)
            self.net_B = MainSubsetModel(in_ch + list_ch_A[1], out_ch, img_size,
                                         feature_size, hidden_size, mlp_dim, num_layers,
                                         num_heads, act, remat_blocks, multiS_conv)
            self.conv_out_A = Conv3d(list_ch_A[1], out_ch, 1, bias=True)

    def forward(self, x: torch.Tensor, stop_gradient_a: bool = False
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``stop_gradient_a`` runs net_A without autograd, the counterpart of
        the JAX model's ``stop_gradient`` (dose_pyfer.py:180-185): frozen-net_A
        training stores none of its activations and back-propagates nothing
        through it."""
        if stop_gradient_a:
            with torch.no_grad():
                out_a = self.net_A(x)
        else:
            out_a = self.net_A(x)
        outs_b = self.net_B(torch.cat([out_a, x], dim=1))
        return self.conv_out_A(out_a), outs_b
