"""C3D U-Net, the DOSE-PYFER cascade's net_A, and the C3D cascade that
pretrains it (counterpart of dose_prediction_tpu/models/c3d.py; reference
c3d.py BaseUNet :118, Model :152).

5 levels, stride-2 downsampling convs, trilinear (align_corners) upsampling,
Conv + InstanceNorm(affine) + ReLU everywhere. Module names are the
reference's (encoder.encoder_L.S.single_conv.*, decoder.upconv_L.conv.*,
decoder.decoder_conv_L.S.single_conv.*).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from dose_prediction_tpu_torch.device import resolve_device
from dose_prediction_tpu_torch.nn.blocks import SingleConv, UpConv
from dose_prediction_tpu_torch.nn.layers import Conv3d

DEFAULT_LIST_CH = (-1, 32, 64, 128, 256, 512)


class Encoder(nn.Module):
    def __init__(self, in_ch: int, list_ch: Sequence[int]):
        super().__init__()
        for level in range(1, 6):
            cin = in_ch if level == 1 else list_ch[level - 1]
            stride = 1 if level == 1 else 2
            setattr(self, f"encoder_{level}", nn.Sequential(
                SingleConv(cin, list_ch[level], stride),
                SingleConv(list_ch[level], list_ch[level])))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for level in range(1, 6):
            x = getattr(self, f"encoder_{level}")(x)
            outs.append(x)
        return outs


class Decoder(nn.Module):
    def __init__(self, list_ch: Sequence[int]):
        super().__init__()
        for level in (4, 3, 2):
            setattr(self, f"upconv_{level}", UpConv(list_ch[level + 1], list_ch[level]))
            setattr(self, f"decoder_conv_{level}", nn.Sequential(
                SingleConv(2 * list_ch[level], list_ch[level]),
                SingleConv(list_ch[level], list_ch[level])))
        self.upconv_1 = UpConv(list_ch[2], list_ch[1])
        self.decoder_conv_1 = nn.Sequential(SingleConv(2 * list_ch[1], list_ch[1]))

    def forward(self, enc_outs: List[torch.Tensor]) -> torch.Tensor:
        e1, e2, e3, e4, e5 = enc_outs
        x = e5
        for level, skip in ((4, e4), (3, e3), (2, e2)):
            x = getattr(self, f"upconv_{level}")(x)
            x = getattr(self, f"decoder_conv_{level}")(torch.cat([x, skip], dim=1))
        x = self.upconv_1(x)
        return self.decoder_conv_1(torch.cat([x, e1], dim=1))


class BaseUNet(nn.Module):
    """Returns the list_ch[1]-channel feature map (the cascade feeds it on)."""

    def __init__(self, in_ch: int, list_ch: Sequence[int] = DEFAULT_LIST_CH):
        super().__init__()
        self.encoder = Encoder(in_ch, list_ch)
        self.decoder = Decoder(list_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))


class CascadeC3D(nn.Module):
    """Two stacked BaseUNets (c3d.Model :152; JAX models/c3d.py:71-90):
    ``net_B`` sees ``cat(out_A, x)``; the 1×1 heads ``conv_out_A`` and
    ``conv_out_B`` give ``(pred_a, pred_b)``, ``out_ch`` channels each.
    Defaults: 9 input channels (PTV, 7 OARs, CT), one dose channel."""

    def __init__(self, in_ch: int = 9, out_ch: int = 1,
                 list_ch_A: Sequence[int] = DEFAULT_LIST_CH,
                 list_ch_B: Sequence[int] = DEFAULT_LIST_CH, device="cuda"):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.net_A = BaseUNet(in_ch, list_ch_A)
            self.net_B = BaseUNet(in_ch + list_ch_A[1], list_ch_B)
            self.conv_out_A = Conv3d(list_ch_A[1], out_ch, 1, bias=True)
            self.conv_out_B = Conv3d(list_ch_B[1], out_ch, 1, bias=True)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out_a = self.net_A(x)
        out_b = self.net_B(torch.cat([out_a, x], dim=1))
        return self.conv_out_A(out_a), self.conv_out_B(out_b)
