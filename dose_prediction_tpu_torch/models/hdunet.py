"""HD-UNet, the paper's dense U-Net dose baseline (counterpart of
dose_prediction_tpu/models/hdunet.py; reference
DosePrediction/Models/Networks/hdunet.py).

DenseConvolve concatenates ``[SingleConv(x), x]`` (:20); DenseDownsample
``[stride-2 SingleConv(x), max_pool3d(x)]`` (:34-43); each decoder level
upsamples trilinearly ×2 (align_corners=True) into a SingleConv
(UNetUpsample, :50), concatenates the skip and runs two SingleConvs of the
fixed widths 256/128/64/32; a 1×1 head ``final_conv`` with a kaiming-uniform
(ReLU) initialisation ends it (:106-152). SingleConv = Conv3d(bias) +
InstanceNorm(affine) + ReLU. Module names are the reference's
(encoder.encoder_L.S.single_conv.*, decoder.upconv_L.conv.*,
decoder.decoder_conv_L.S.single_conv.*, decoder.final_conv).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from dose_prediction_tpu_torch import ops
from dose_prediction_tpu_torch.device import resolve_device
from dose_prediction_tpu_torch.models.spec import records_config
from dose_prediction_tpu_torch.nn.blocks import SingleConv, UpConv
from dose_prediction_tpu_torch.nn.layers import Conv3d

DECODER_WIDTHS = {4: 256, 3: 128, 2: 64, 1: 32}


class DenseConvolve(SingleConv):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.single_conv(x), x], dim=1)


class DenseDownsample(SingleConv):
    def __init__(self, cin: int, growth: int):
        super().__init__(cin, growth, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.single_conv(x), ops.max_pool3d(x, 2)], dim=1)


class Encoder(nn.Module):
    """encoder_1: two DenseConvolves; encoder_2-4: a DenseDownsample and two
    DenseConvolves; encoder_5: a DenseDownsample and four. Each block adds
    ``growth`` channels."""

    def __init__(self, in_ch: int, growth: int):
        super().__init__()
        ch = in_ch
        for level, dense in ((1, 2), (2, 2), (3, 2), (4, 2), (5, 4)):
            blocks = []
            if level > 1:
                blocks.append(DenseDownsample(ch, growth))
                ch += growth
            for _ in range(dense):
                blocks.append(DenseConvolve(ch, growth))
                ch += growth
            setattr(self, f"encoder_{level}", nn.Sequential(*blocks))
        self.out_channels = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for level in range(1, 6):
            x = getattr(self, f"encoder_{level}")(x)
            outs.append(x)
        return outs


class Decoder(nn.Module):
    def __init__(self, skips: List[int], bottom: int, upsample_chan: int, out_ch: int):
        super().__init__()
        up_in = bottom
        for level in (4, 3, 2, 1):
            width = DECODER_WIDTHS[level]
            setattr(self, f"upconv_{level}", UpConv(up_in, upsample_chan))
            setattr(self, f"decoder_conv_{level}", nn.Sequential(
                SingleConv(skips[level - 1] + upsample_chan, width), SingleConv(width, width)))
            up_in = width
        self.final_conv = Conv3d(DECODER_WIDTHS[1], out_ch, 1, bias=True)
        nn.init.kaiming_uniform_(self.final_conv.weight, nonlinearity="relu")

    def forward(self, enc_outs: List[torch.Tensor]) -> torch.Tensor:
        x = enc_outs[4]
        for level in (4, 3, 2, 1):
            x = getattr(self, f"upconv_{level}")(x)
            x = getattr(self, f"decoder_conv_{level}")(torch.cat([x, enc_outs[level - 1]], dim=1))
        return self.final_conv(x)


class HDUNet(nn.Module):
    """``forward(x)`` on ``(N, in_ch, D, H, W)`` returns the ``(N, out_ch, D,
    H, W)`` dose; D, H and W divisible by 16. Defaults (the reference
    trainer's, train_light_hdunet.py:69): 9 input channels (PTV, 7 OARs,
    CT), growth rate 16, 64 upsampling channels, one dose channel."""

    @records_config
    def __init__(self, in_ch: int = 9, growth_rate: int = 16, upsample_chan: int = 64,
                 out_ch: int = 1, device="cuda"):
        super().__init__()
        g = growth_rate
        # channels after each encoder level: in + 2g, then + 3g at levels 2-4
        skips = [in_ch + 2 * g, in_ch + 5 * g, in_ch + 8 * g, in_ch + 11 * g]
        with torch.device(resolve_device(device)):
            self.encoder = Encoder(in_ch, g)
            self.decoder = Decoder(skips, self.encoder.out_channels, upsample_chan, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))
