"""Plain MONAI UNETR, the seg task's mode_model=0 network (counterpart of
dose_prediction_tpu/models/unetr.py; reference
OARSegmentation/train_light_transeg.py:93-107).

A ViT with hidden-state taps at num_layers/4 multiples (3/6/9 for 12
layers), UnetrBasicBlock + UnetrPrUpBlock skip encoders, UnetrUpBlock
decoders with ``res_block=True`` (UnetResBlock stages, the trainer's
setting) and a 1×1 output head ``out.conv.conv``, MONAI's UnetOutBlock.
``trained_grid`` resizes the ViT's position embedding to another token
grid, as TranSeg's does.
"""

from __future__ import annotations

import torch
from torch import nn

from dose_prediction_tpu_torch.device import resolve_device
from dose_prediction_tpu_torch.models.spec import records_config
from dose_prediction_tpu_torch.nn.unetr import (
    ModifiedUnetOutBlock,
    UnetrBasicBlock,
    UnetrPrUpBlock,
    UnetrUpBlock,
)
from dose_prediction_tpu_torch.nn.vit import ViT, tokens_to_volume


class UNETR(nn.Module):
    """``forward(x)`` on ``(N, in_ch, D, H, W)`` returns ``(N, out_ch, D, H,
    W)`` logits. Defaults: 1 input channel, 7 OARs + background, 96³
    windows, feature size 16, a 12-layer ViT-768 (MLP 3072) with 12 heads,
    patch 16."""

    @records_config
    def __init__(self, in_ch: int = 1, out_ch: int = 8, img_size=96, feature_size: int = 16,
                 hidden_size: int = 768, mlp_dim: int = 3072, num_layers: int = 12,
                 num_heads: int = 12, patch_size: int = 16, res_block: bool = True,
                 trained_grid=None, device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        fs = feature_size
        with torch.device(resolve_device(device)):
            self.vit = ViT(in_ch, img_size, patch_size, hidden_size, mlp_dim, num_layers,
                           num_heads, trained_grid)
            self.encoder1 = UnetrBasicBlock(in_ch, fs)
            self.encoder2 = UnetrPrUpBlock(hidden_size, fs * 2, 2)
            self.encoder3 = UnetrPrUpBlock(hidden_size, fs * 4, 1)
            self.encoder4 = UnetrPrUpBlock(hidden_size, fs * 8, 0)
            self.decoder5 = UnetrUpBlock(hidden_size, fs * 8, res_block)
            self.decoder4 = UnetrUpBlock(fs * 8, fs * 4, res_block)
            self.decoder3 = UnetrUpBlock(fs * 4, fs * 2, res_block)
            self.decoder2 = UnetrUpBlock(fs * 2, fs, res_block)
            self.out = ModifiedUnetOutBlock(fs, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z, hidden = self.vit(x)
        i, grid = self.num_layers // 4, self.vit.grid(x)
        enc1 = self.encoder1(x)
        enc2 = self.encoder2(tokens_to_volume(hidden[i], grid))
        enc3 = self.encoder3(tokens_to_volume(hidden[2 * i], grid))
        enc4 = self.encoder4(tokens_to_volume(hidden[3 * i], grid))
        dec3 = self.decoder5(tokens_to_volume(z, grid), enc4)
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        return self.out(self.decoder2(dec1, enc1))
