"""OAR-TranSeg, the cascade's stage-1 segmentation model (counterpart of
dose_prediction_tpu/models/transeg.py with block_family='seg',
multiS_conv=True; reference OARSegmentation/Models/Networks/oar_transeg.py:14-185).

A ViT with hidden-state taps at num_layers/4 multiples (3/6/9 for 12
layers), UnetrBasicBlock + UnetrPrUpBlock encoders, ModifiedUnetrUpBlock
decoders (seg-family Conv31, act='relu') and a 1×1 output head.
``trained_grid`` (JAX models/transeg.py:50-54) runs weights trained on one
token grid, e.g. (6, 6, 6) for 96³ windows, on volumes of another size: the
ViT's position embedding is resized; every other block is convolutional.
That is what the cascade's dense seg mode runs.
"""

from __future__ import annotations

import torch
from torch import nn

from dose_prediction_tpu_torch.device import resolve_device
from dose_prediction_tpu_torch.models.spec import records_config
from dose_prediction_tpu_torch.nn import remat
from dose_prediction_tpu_torch.nn.unetr import (
    ModifiedUnetOutBlock,
    ModifiedUnetrUpBlock,
    UnetrBasicBlock,
    UnetrPrUpBlock,
)
from dose_prediction_tpu_torch.nn.vit import ViT, tokens_to_volume


class TranSeg(nn.Module):
    """``forward(x)`` on ``(N, in_ch, D, H, W)`` returns ``(N, out_ch, D, H,
    W)`` logits; (D, H, W) is ``img_size``, or with ``trained_grid`` any
    multiple of the patch. Defaults: 1 input channel, 7 OARs + background,
    96³ windows, feature size 16, a 12-layer ViT-768 with 12 heads.
    ``remat_blocks`` recomputes each decoder stage in the backward (JAX
    transeg.py:55-101, nn/remat.py); the parameters are the same."""

    @records_config
    def __init__(self, in_ch: int = 1, out_ch: int = 8, img_size=96, feature_size: int = 16,
                 hidden_size: int = 768, mlp_dim: int = 3072, num_layers: int = 12,
                 num_heads: int = 12, act: str = "relu", patch_size: int = 16,
                 trained_grid=None, remat_blocks: bool = False, device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        self.remat_blocks = remat_blocks
        fs = feature_size
        with torch.device(resolve_device(device)):
            self.vit = ViT(in_ch, img_size, patch_size, hidden_size, mlp_dim, num_layers,
                           num_heads, trained_grid)
            self.encoder1 = UnetrBasicBlock(in_ch, fs)
            self.encoder2 = UnetrPrUpBlock(hidden_size, fs * 2, 2)
            self.encoder3 = UnetrPrUpBlock(hidden_size, fs * 4, 1)
            self.encoder4 = UnetrPrUpBlock(hidden_size, fs * 8, 0)
            self.decoder5 = ModifiedUnetrUpBlock(hidden_size, fs * 8, act)
            self.decoder4 = ModifiedUnetrUpBlock(fs * 8, fs * 4, act)
            self.decoder3 = ModifiedUnetrUpBlock(fs * 4, fs * 2, act)
            self.decoder2 = ModifiedUnetrUpBlock(fs * 2, fs, act)
            self.out = ModifiedUnetOutBlock(fs, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z, hidden = self.vit(x)
        i, grid = self.num_layers // 4, self.vit.grid(x)
        enc1 = self.encoder1(x)
        enc2 = self.encoder2(tokens_to_volume(hidden[i], grid))
        enc3 = self.encoder3(tokens_to_volume(hidden[2 * i], grid))
        enc4 = self.encoder4(tokens_to_volume(hidden[3 * i], grid))
        on = self.remat_blocks
        dec3 = remat.checkpoint(self.decoder5, tokens_to_volume(z, grid), enc4, enabled=on)
        dec2 = remat.checkpoint(self.decoder4, dec3, enc3, enabled=on)
        dec1 = remat.checkpoint(self.decoder3, dec2, enc2, enabled=on)
        return self.out(remat.checkpoint(self.decoder2, dec1, enc1, enabled=on))
