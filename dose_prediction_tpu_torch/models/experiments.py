"""The experiments zoo (counterpart of dose_prediction_tpu/models/experiments.py;
reference DosePrediction/Models/Networks/models_experiments.py).

- ``VitGenerator`` (:769): DOSE-PYFER's net_B without the cascade, a ViT
  encoder, a PyMSCDecoder and four 1×1 deep-supervision heads. It is the
  exp model (``exp_generator``, train_light_exp_models.py:118-129) and
  ViT-GAN's generator (``vitgan_generator``, train_light_gan.py:124-133).
  Module names are the reference's (``encoder``, ``decoder``,
  ``dose_convertors.{i}.0``), so a reference state dict loads strictly.
- ``ResNet3D`` / ``resnet10``: the MedicalNet 3D ResNet that ViT-GAN's
  critic is (train_light_gan.py:124-138): conv 7³ stride (1, 2, 2) without
  bias, BatchNorm, ReLU, a 3³ stride-2 max pool over a −inf pad of 1, four
  stages of basic blocks, a global mean and a linear head, with
  MedicalNet's module names (``conv1``, ``bn1``,
  ``layer{1-4}.{i}.{conv1,bn1,conv2,bn2,downsample.{0,1}}``, ``fc``).
- The rest of the zoo, which no entry point trains: attention gates
  (``AttGateExp``, ``MultiAttGate``), encoders (``SharedEncoder``,
  ``DilatedSharedEncoder``, ``DilatedEncoder``, ``InitialEncoderA``),
  decoders (``SharedDecoder``, ``DilatedSharedDecoder``, ``_GatedDecoder``
  as ``AttDecoder``, ``PureAttDecoder`` and ``PureMultiAttDecoder``) and the
  models built of them (``SharedEncoderModel``, ``ExperimentalBaseUNet``,
  ``ExperimentalCascade``, ``SharedUNetModel``, ``SharedUNetRModelA``,
  ``SharedUNetRModel``, ``MonaiUNet``, ``ModelMonai``). Their modules carry
  the JAX package's flax names, which weights.py maps.

Torch modules need their input channels, which flax infers: each
constructor takes ``in_ch`` where the JAX module takes none. The
multi-scale blocks of the zoo are the 'dose' family's (BatchNorm inside,
a bare 1×1 fuse), as the JAX module builds them. Where the JAX modules
take a ``norm``, the port builds its default, InstanceNorm (the 'batch'
option, which no model of either package uses, is not ported).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dose_prediction_tpu_torch import ops
from dose_prediction_tpu_torch.device import resolve_device
from dose_prediction_tpu_torch.models.c3d import Decoder as PlainDecoder
from dose_prediction_tpu_torch.models.c3d import Encoder as PlainEncoder
from dose_prediction_tpu_torch.models.dose_pyfer import PyMSCDecoder, ViTEncoder
from dose_prediction_tpu_torch.models.spec import records_config
from dose_prediction_tpu_torch.nn.blocks import SingleConv, UpConv
from dose_prediction_tpu_torch.nn.layers import BatchNorm3d, Conv3d, ConvTranspose3d, Linear
from dose_prediction_tpu_torch.nn.mdunet import Conv31, DualDilatedBlock
from dose_prediction_tpu_torch.nn.unetr import (
    UnetrBasicBlock,
    UnetResBlock,
    UnetrPrUpBlock,
    UnetrUpBlock,
)
from dose_prediction_tpu_torch.nn.vit import ViT, tokens_to_volume


def _head(cin: int, cout: int) -> Conv3d:
    return Conv3d(cin, cout, 1, bias=True)


# -- attention gates ---------------------------------------------------------

class AttGateExp(nn.Module):
    """Additive attention gate (:79-101): one 1×1 conv on both inputs,
    ReLU of the sum, a 1×1 conv, BatchNorm and a sigmoid, times the gated
    input's projection."""

    def __init__(self, ch: int):
        super().__init__()
        self.initial_conv = _head(ch, ch)
        self.inter_conv = _head(ch, ch)
        self.inter_norm = BatchNorm3d(ch)

    def _core(self, g: torch.Tensor) -> torch.Tensor:
        return self.inter_conv(g)

    def forward(self, down_inp: torch.Tensor, sample_inp: torch.Tensor) -> torch.Tensor:
        z1 = self.initial_conv(down_inp)
        g = ops.relu(z1 + self.initial_conv(sample_inp))
        return z1 * torch.sigmoid(self.inter_norm(self._core(g)))


class MultiAttGate(AttGateExp):
    """The gate with a conv_3_1 core (:52-76)."""

    def __init__(self, ch: int):
        nn.Module.__init__(self)
        self.initial_conv = _head(ch, ch)
        self.inter_conv31 = Conv31(ch, ch, family="dose")
        self.inter_norm = BatchNorm3d(ch)

    def _core(self, g: torch.Tensor) -> torch.Tensor:
        return self.inter_conv31(g)


# -- encoders ----------------------------------------------------------------

class SharedEncoder(nn.Module):
    """Four levels, one conv at level 1, a stride-2 conv and a conv at each
    level after (:247-271)."""

    def __init__(self, in_ch: int, list_ch: Sequence[int]):
        super().__init__()
        ch = list_ch
        self.enc1_conv = SingleConv(in_ch, ch[1])
        for level in (2, 3, 4):
            setattr(self, f"enc{level}_down", SingleConv(ch[level - 1], ch[level], 2))
            setattr(self, f"enc{level}_conv", SingleConv(ch[level], ch[level]))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.enc1_conv(x)
        outs = [x]
        for level in (2, 3, 4):
            x = getattr(self, f"enc{level}_conv")(getattr(self, f"enc{level}_down")(x))
            outs.append(x)
        return outs


class DilatedSharedEncoder(nn.Module):
    """Four levels: a conv, then max pool and a DualDilatedBlock a level
    (:275-297)."""

    def __init__(self, in_ch: int, list_ch: Sequence[int]):
        super().__init__()
        ch = list_ch
        self.enc1_conv = SingleConv(in_ch, ch[1])
        for level in (2, 3, 4):
            setattr(self, f"enc{level}_dual", DualDilatedBlock(ch[level - 1], ch[level],
                                                               family="dose"))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.enc1_conv(x)
        outs = [x]
        for level in (2, 3, 4):
            x = getattr(self, f"enc{level}_dual")(ops.max_pool3d(x, 2))
            outs.append(x)
        return outs


class DilatedEncoder(nn.Module):
    """Five DualDilatedBlock levels, max pool between them (:356-390)."""

    def __init__(self, in_ch: int, list_ch: Sequence[int]):
        super().__init__()
        ch = list_ch
        self.enc1_dual = DualDilatedBlock(in_ch, ch[1], family="dose")
        for level in (2, 3, 4, 5):
            setattr(self, f"enc{level}_dual", DualDilatedBlock(ch[level - 1], ch[level],
                                                               family="dose"))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.enc1_dual(x)
        outs = [x]
        for level in (2, 3, 4, 5):
            x = getattr(self, f"enc{level}_dual")(ops.max_pool3d(x, 2))
            outs.append(x)
        return outs


class InitialEncoderA(nn.Module):
    """Stem returning (full-resolution features, stride-2 features)
    (:301-319): two convs (``mode`` 1) or a DualDilatedBlock."""

    def __init__(self, in_ch: int, mid_ch: int, down_ch: int, mode: int = 1):
        super().__init__()
        self.mode = mode
        if mode == 1:
            self.conv1 = SingleConv(in_ch, mid_ch)
            self.conv2 = SingleConv(mid_ch, mid_ch)
        else:
            self.dual = DualDilatedBlock(in_ch, mid_ch, family="dose")
        self.down = SingleConv(mid_ch, down_ch, 2)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.conv2(self.conv1(x)) if self.mode == 1 else self.dual(x)
        return h, self.down(h)


# -- decoders ----------------------------------------------------------------

class SharedDecoder(nn.Module):
    """Three upsamplings over four encoder scales, two convs a level and
    one at the last (:486-517)."""

    def __init__(self, list_ch: Sequence[int]):
        super().__init__()
        ch = list_ch
        for level in (3, 2):
            setattr(self, f"up{level}", UpConv(ch[level + 1], ch[level]))
            setattr(self, f"dec{level}_c1", SingleConv(2 * ch[level], ch[level]))
            setattr(self, f"dec{level}_c2", SingleConv(ch[level], ch[level]))
        self.up1 = UpConv(ch[2], ch[1])
        self.dec1_c1 = SingleConv(2 * ch[1], ch[1])

    def forward(self, enc_outs: List[torch.Tensor]) -> torch.Tensor:
        e1, e2, e3, e4 = enc_outs
        x = e4
        for level, skip in ((3, e3), (2, e2)):
            x = torch.cat([getattr(self, f"up{level}")(x), skip], dim=1)
            x = getattr(self, f"dec{level}_c2")(getattr(self, f"dec{level}_c1")(x))
        return self.dec1_c1(torch.cat([self.up1(x), e1], dim=1))


class DilatedSharedDecoder(nn.Module):
    """SharedDecoder with a conv_3_1 a level (:521-544)."""

    def __init__(self, list_ch: Sequence[int]):
        super().__init__()
        ch = list_ch
        for level in (3, 2):
            setattr(self, f"up{level}", UpConv(ch[level + 1], ch[level]))
            setattr(self, f"dec{level}_c31", Conv31(2 * ch[level], ch[level], family="dose"))
        self.up1 = UpConv(ch[2], ch[1])
        self.dec1_conv = SingleConv(2 * ch[1], ch[1])

    def forward(self, enc_outs: List[torch.Tensor]) -> torch.Tensor:
        e1, e2, e3, e4 = enc_outs
        x = e4
        for level, skip in ((3, e3), (2, e2)):
            x = torch.cat([getattr(self, f"up{level}")(x), skip], dim=1)
            x = getattr(self, f"dec{level}_c31")(x)
        return self.dec1_conv(torch.cat([self.up1(x), e1], dim=1))


class _GatedDecoder(nn.Module):
    """Four upsamplings over five encoder scales (:591-766): each level
    gates the encoder skip against the upsample (``gate`` 'att' or
    'multi'), concatenates (up, gated) and convolves, twice a level with
    ``double_conv`` (once at level 1)."""

    def __init__(self, list_ch: Sequence[int], gate: str = "att", double_conv: bool = True):
        super().__init__()
        ch = list_ch
        gate_cls = {"att": AttGateExp, "multi": MultiAttGate}[gate]
        self.double_conv = double_conv
        for level in (4, 3, 2, 1):
            setattr(self, f"up{level}", UpConv(ch[level + 1], ch[level]))
            setattr(self, f"gate{level}", gate_cls(ch[level]))
            setattr(self, f"dec{level}_c1", SingleConv(2 * ch[level], ch[level]))
            if double_conv and level > 1:
                setattr(self, f"dec{level}_c2", SingleConv(ch[level], ch[level]))

    def forward(self, enc_outs: List[torch.Tensor]) -> torch.Tensor:
        e1, e2, e3, e4, e5 = enc_outs
        x = e5
        for level, skip in ((4, e4), (3, e3), (2, e2), (1, e1)):
            up = getattr(self, f"up{level}")(x)
            gated = getattr(self, f"gate{level}")(skip, up)
            x = getattr(self, f"dec{level}_c1")(torch.cat([up, gated], dim=1))
            if self.double_conv and level > 1:
                x = getattr(self, f"dec{level}_c2")(x)
        return x


def AttDecoder(list_ch: Sequence[int]) -> _GatedDecoder:
    return _GatedDecoder(list_ch, gate="att", double_conv=True)


def PureAttDecoder(list_ch: Sequence[int]) -> _GatedDecoder:
    return _GatedDecoder(list_ch, gate="att", double_conv=False)


def PureMultiAttDecoder(list_ch: Sequence[int]) -> _GatedDecoder:
    return _GatedDecoder(list_ch, gate="multi", double_conv=False)


# -- models ------------------------------------------------------------------

class VitGenerator(nn.Module):
    """The non-cascade ViT generator (:769-838): ``forward(x)`` on ``(N,
    in_ch, D, H, W)`` returns the four deep-supervision outputs ``[full,
    ½, ¼, ⅛]``. ``mode_multi_dec`` picks ModifiedUnetrUpBlock decoder
    stages (Conv31 with ``multiS_conv``, else DualDilatedBlock) over the
    plain UnetrUpBlock ones. ``img_size`` fixes the ViT's token grid."""

    @records_config
    def __init__(self, in_ch: int = 9, out_ch: int = 1, img_size=128, feature_size: int = 16,
                 hidden_size: int = 768, mlp_dim: int = 3072, num_heads: int = 12,
                 num_layers: int = 12, mode_multi_dec: bool = False, act: str = "relu",
                 multiS_conv: bool = True, device="cuda"):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.encoder = ViTEncoder(in_ch, img_size, feature_size, hidden_size, mlp_dim,
                                      num_layers, num_heads)
            self.decoder = PyMSCDecoder(feature_size, hidden_size, act,
                                        multiS_conv=multiS_conv, mode_multi=mode_multi_dec)
            self.dose_convertors = nn.ModuleList(
                [nn.Sequential(_head(feature_size * 2 ** i, out_ch)) for i in range(4)])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        decs = self.decoder(self.encoder(x))
        return [conv(dec) for dec, conv in zip(decs, self.dose_convertors)]


class SharedEncoderModel(nn.Module):
    """One ViT encoder and two PyMSCDecoders (plain UnetrUpBlock stages):
    stage B's encoder features are cat(encoder scale, decoder A scale);
    tanh heads on both full-resolution outputs (:841-908). Returns
    ``(out_a, out_b)``."""

    @records_config
    def __init__(self, in_ch: int = 9, out_ch: int = 1, img_size=128, feature_size_a: int = 16,
                 feature_size_b: int = 32, hidden_size: int = 768, mlp_dim: int = 3072,
                 num_heads: int = 12, num_layers: int = 12, device="cuda"):
        super().__init__()
        fa, fb = feature_size_a, feature_size_b
        with torch.device(resolve_device(device)):
            self.encoder = ViTEncoder(in_ch, img_size, fa, hidden_size, mlp_dim, num_layers,
                                      num_heads)
            self.decoder_a = PyMSCDecoder(fa, hidden_size, "relu", mode_multi=False)
            self.out_a = _head(fa, out_ch)
            self.decoder_b = PyMSCDecoder(fb, hidden_size, "relu", mode_multi=False,
                                          skip_ch=(2 * fa, 4 * fa, 8 * fa, 16 * fa))
            self.out_b = _head(fb, out_ch)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        enc = self.encoder(x)
        dec_a = self.decoder_a(enc)
        out_a = torch.tanh(self.out_a(dec_a[0]))
        enc_b = [torch.cat([e, d], dim=1) for e, d in zip(enc[:-1], dec_a)] + [enc[-1]]
        return out_a, torch.tanh(self.out_b(self.decoder_b(enc_b)[0]))


class ExperimentalBaseUNet(nn.Module):
    """A U-Net of pluggable parts (:1449-1496): encoder ``mode_encoder`` 1
    (the C3D encoder) or 2 (DilatedEncoder); decoder ``mode_decoder`` 1
    (the C3D decoder), 3 (attention), 4 (pure attention) or 5 (pure
    multi-scale attention). Returns the list_ch[1]-channel features."""

    GATES = {3: ("att", True), 4: ("att", False), 5: ("multi", False)}

    def __init__(self, in_ch: int, list_ch: Sequence[int], mode_encoder: int = 1,
                 mode_decoder: int = 1):
        super().__init__()
        self.encoder = (PlainEncoder(in_ch, list_ch) if mode_encoder == 1
                        else DilatedEncoder(in_ch, list_ch))
        if mode_decoder == 1:
            self.decoder = PlainDecoder(list_ch)
        else:
            gate, double = self.GATES[mode_decoder]
            self.decoder = _GatedDecoder(list_ch, gate=gate, double_conv=double)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))


class ExperimentalCascade(nn.Module):
    """A cascade over two ExperimentalBaseUNets (:1499-1520): net_B sees
    cat(out_A, x); 1×1 heads give ``(pred_a, pred_b)``."""

    @records_config
    def __init__(self, in_ch: int = 9, out_ch: int = 1,
                 list_ch_A: Sequence[int] = (-1, 16, 32, 64, 128, 256),
                 list_ch_B: Sequence[int] = (-1, 32, 64, 128, 256, 512),
                 mode_encoder_A: int = 1, mode_encoder_B: int = 1,
                 mode_decoder_A: int = 1, mode_decoder_B: int = 1, device="cuda"):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.net_A = ExperimentalBaseUNet(in_ch, list_ch_A, mode_encoder_A, mode_decoder_A)
            self.net_B = ExperimentalBaseUNet(in_ch + list_ch_A[1], list_ch_B, mode_encoder_B,
                                              mode_decoder_B)
            self.conv_out_A = _head(list_ch_A[1], out_ch)
            self.conv_out_B = _head(list_ch_B[1], out_ch)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out_a = self.net_A(x)
        out_b = self.net_B(torch.cat([out_a, x], dim=1))
        return self.conv_out_A(out_a), self.conv_out_B(out_b)


class SharedUNetModel(nn.Module):
    """A cascade whose two stages run one weight-shared encoder and decoder
    (:911-1008): stage A is a stem, the shared U-Net at half resolution and
    a head; stage B runs the same U-Net on cat(stage A, x) with an extra
    bottleneck level. tanh heads; returns ``(out_a, out_b)``."""

    @records_config
    def __init__(self, in_ch: int = 9, out_ch: int = 1,
                 list_ch: Sequence[int] = (-1, 16, 32, 64, 128, 256, 512),
                 mode_encoder: int = 1, mode_decoder: int = 1, device="cuda"):
        super().__init__()
        ch = list_ch
        inner = [-1] + list(ch[2:-1])
        self.mode_encoder = mode_encoder
        with torch.device(resolve_device(device)):
            self.initial_encoder_a = InitialEncoderA(in_ch, ch[1], ch[2], mode=mode_encoder)
            self.shared_encoder = (SharedEncoder(ch[2], inner) if mode_encoder == 1
                                   else DilatedSharedEncoder(ch[2], inner))
            self.shared_decoder = (SharedDecoder(inner) if mode_decoder == 1
                                   else DilatedSharedDecoder(inner))
            self.decoder_a_conv = SingleConv(ch[2], ch[2])
            self.decoder_a_up = UpConv(ch[2], ch[1])
            self.out_decoder_a = SingleConv(2 * ch[1], ch[1])
            self.initial_encoder_b = SingleConv(ch[1] + in_ch, ch[2])
            if mode_encoder == 1:
                self.bottleneck_down = SingleConv(ch[5], ch[6], 2)
                self.bottleneck_conv = SingleConv(ch[6], ch[6])
            else:
                self.bottleneck_dual = DualDilatedBlock(ch[5], ch[6], family="dose")
            self.bottleneck_up = UpConv(ch[6], ch[5])
            self.out_bottleneck_c1 = SingleConv(2 * ch[5], ch[5])
            self.out_bottleneck_c2 = SingleConv(ch[5], ch[5])
            self.conv_out_a = _head(ch[1], out_ch)
            self.conv_out_b = _head(ch[2], out_ch)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        conv, down = self.initial_encoder_a(x)
        dec_a = self.shared_decoder(self.shared_encoder(down))
        dec_a = self.decoder_a_up(self.decoder_a_conv(dec_a))
        out_dec_a = self.out_decoder_a(torch.cat([conv, dec_a], dim=1))
        enc_b = self.shared_encoder(self.initial_encoder_b(torch.cat([out_dec_a, x], dim=1)))
        if self.mode_encoder == 1:
            bott = self.bottleneck_conv(self.bottleneck_down(enc_b[-1]))
        else:
            bott = self.bottleneck_dual(ops.max_pool3d(enc_b[-1], 2))
        merged = torch.cat([enc_b[-1], self.bottleneck_up(bott)], dim=1)
        enc_b[-1] = self.out_bottleneck_c2(self.out_bottleneck_c1(merged))
        dec_b = self.shared_decoder(enc_b)
        return torch.tanh(self.conv_out_a(out_dec_a)), torch.tanh(self.conv_out_b(dec_b))


class SharedUNetRModelA(nn.Module):
    """The shared-ViT UNETR stub A (:1289-1448): one UNETR pass (taps at
    num_layers/4 multiples, UnetrUpBlock decoders) whose head fills both
    cascade slots, ``(out_a, out_a)``."""

    @records_config
    def __init__(self, in_ch: int = 9, out_ch: int = 1, img_size=128, feature_size: int = 16,
                 hidden_size: int = 768, mlp_dim: int = 3072, num_heads: int = 12,
                 num_layers: int = 12, patch_size: int = 16, device="cuda"):
        super().__init__()
        fs = feature_size
        self.num_layers = num_layers
        with torch.device(resolve_device(device)):
            self.vit = ViT(in_ch, img_size, patch_size, hidden_size, mlp_dim, num_layers,
                           num_heads)
            self.skip1 = UnetrBasicBlock(in_ch, fs)
            self.skip2 = UnetrPrUpBlock(hidden_size, fs * 2, 2)
            self.skip3 = UnetrPrUpBlock(hidden_size, fs * 4, 1)
            self.skip4 = UnetrPrUpBlock(hidden_size, fs * 8, 0)
            self.decoder4 = UnetrUpBlock(hidden_size, fs * 8)
            self.decoder3 = UnetrUpBlock(fs * 8, fs * 4)
            self.decoder2 = UnetrUpBlock(fs * 4, fs * 2)
            self.decoder1 = UnetrUpBlock(fs * 2, fs)
            self.out_a = _head(fs, out_ch)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        z, hidden = self.vit(x)
        i, grid = self.num_layers // 4, self.vit.grid(x)
        e2 = self.skip2(tokens_to_volume(hidden[i], grid))
        e3 = self.skip3(tokens_to_volume(hidden[2 * i], grid))
        e4 = self.skip4(tokens_to_volume(hidden[3 * i], grid))
        d = self.decoder4(tokens_to_volume(z, grid), e4)
        d = self.decoder1(self.decoder2(self.decoder3(d, e3), e2), self.skip1(x))
        out_a = self.out_a(d)
        return out_a, out_a


class SharedUNetRModel(nn.Module):
    """The shared-ViT two-stage UNETR cascade (:1028-1288): one ViT encodes
    stage A (a 1×1 projection of x to ``in_ch_b`` channels) and stage B
    (cat(decoder A, x), which must have ``in_ch_b`` = feature_size + in_ch
    channels); stage A decodes taps 2/4/6/8/10, stage B re-taps the ViT and
    decodes through the shared decoder stages and B-only refinement
    blocks. Returns ``(out_a, out_b)``."""

    @records_config
    def __init__(self, in_ch_b: int = 25, in_ch: int = 9, out_ch: int = 1, img_size=128,
                 feature_size: int = 16, hidden_size: int = 768, mlp_dim: int = 3072,
                 num_heads: int = 12, num_layers: int = 12, patch_size: int = 16,
                 device="cuda"):
        super().__init__()
        fs = feature_size
        self.in_ch_b = in_ch_b
        with torch.device(resolve_device(device)):
            self.vit = ViT(in_ch_b, img_size, patch_size, hidden_size, mlp_dim, num_layers,
                           num_heads)
            self.skip1 = UnetrPrUpBlock(hidden_size, fs, 3)
            self.skip2 = UnetrPrUpBlock(hidden_size, fs * 2, 2)
            self.skip3 = UnetrPrUpBlock(hidden_size, fs * 4, 1)
            self.skip4 = UnetrPrUpBlock(hidden_size, fs * 8, 0)
            self.skip5 = _head(hidden_size, fs * 16)
            self.decoder3 = UnetrUpBlock(fs * 16, fs * 8)
            self.decoder2 = UnetrUpBlock(fs * 8, fs * 4)
            self.decoder1 = UnetrUpBlock(fs * 4, fs * 2)
            self.decoder_a = UnetrUpBlock(fs * 2, fs)
            self.initial_a = _head(in_ch, in_ch_b)
            self.out_a = _head(fs, out_ch)
            self.skip2B = UnetrPrUpBlock(fs * 2, fs * 2, 0)
            self.skip3B = UnetrPrUpBlock(fs * 4, fs * 4, 0)
            self.skip4B = UnetrPrUpBlock(fs * 8, fs * 8, 0)
            self.skip5B = UnetrPrUpBlock(fs * 16, fs * 16, 0)
            self.skip6B = _head(hidden_size, fs * 32)
            self.decoder_b = UnetrUpBlock(fs * 32, fs * 16)
            self.out_b = _head(fs * 2, out_ch)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        grid = self.vit.grid(x)
        vol = lambda t: tokens_to_volume(t, grid)  # noqa: E731
        _, hidden = self.vit(self.initial_a(x))
        d = self.decoder3(self.skip5(vol(hidden[10])), self.skip4(vol(hidden[8])))
        d = self.decoder1(self.decoder2(d, self.skip3(vol(hidden[6]))),
                          self.skip2(vol(hidden[4])))
        d2a = self.decoder_a(d, self.skip1(vol(hidden[2])))
        out_a = self.out_a(d2a)
        xb = torch.cat([d2a, x], dim=1)
        if xb.shape[1] != self.in_ch_b:
            raise ValueError(f"stage-B input channels {xb.shape[1]} != in_ch_b {self.in_ch_b} "
                             "(need feature_size + in_ch == in_ch_b)")
        z12, hidden_b = self.vit(xb)
        db = self.decoder_b(self.skip6B(vol(z12)), self.skip5B(self.skip5(vol(hidden_b[10]))))
        db = self.decoder3(db, self.skip4B(self.skip4(vol(hidden_b[8]))))
        db = self.decoder2(db, self.skip3B(self.skip3(vol(hidden_b[6]))))
        db = self.decoder1(db, self.skip2B(self.skip2(vol(hidden_b[4]))))
        return out_a, self.out_b(db)


class MonaiUNet(nn.Module):
    """MONAI UNet semantics (:1522-1554's net): a residual unit a level
    (stride 2 after the first), transposed-conv upsampling, a residual unit
    a decoder level and a 1×1 head."""

    def __init__(self, in_ch: int, out_ch: int,
                 channels: Sequence[int] = (16, 32, 64, 128, 256)):
        super().__init__()
        chans = list(channels)
        self.depth = len(chans) - 1
        prev = in_ch
        for i, c in enumerate(chans[:-1]):
            setattr(self, f"down{i}", UnetResBlock(prev, c, stride=2 if i > 0 else 1))
            prev = c
        self.bottom = UnetResBlock(prev, chans[-1], stride=2)
        for i in reversed(range(self.depth)):
            setattr(self, f"up{i}", ConvTranspose3d(chans[i + 1], chans[i], 2, stride=2,
                                                    bias=False))
            setattr(self, f"dec{i}", UnetResBlock(2 * chans[i], chans[i]))
        self.out = _head(chans[0], out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips, h = [], x
        for i in range(self.depth):
            h = getattr(self, f"down{i}")(h)
            skips.append(h)
        h = self.bottom(h)
        for i in reversed(range(self.depth)):
            h = torch.cat([getattr(self, f"up{i}")(h), skips[i]], dim=1)
            h = getattr(self, f"dec{i}")(h)
        return self.out(h)


class ModelMonai(nn.Module):
    """The MONAI-UNet cascade (:1522-1554): net_A gives ``feat_ch_a``
    features, net_B the dose from cat(them, x); a 1×1 head on A. Returns
    ``(out_a, out_b)``."""

    @records_config
    def __init__(self, in_ch: int = 9, out_ch: int = 1, feat_ch_a: int = 16,
                 channels_a: Sequence[int] = (16, 32, 64, 128, 256),
                 channels_b: Sequence[int] = (16, 32, 64, 128, 256), device="cuda"):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.net_A = MonaiUNet(in_ch, feat_ch_a, channels_a)
            self.net_B = MonaiUNet(in_ch + feat_ch_a, 1, channels_b)
            self.conv_out_A = _head(feat_ch_a, out_ch)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out_net_a = self.net_A(x)
        out_b = self.net_B(torch.cat([out_net_a, x], dim=1))
        return self.conv_out_A(out_net_a), out_b


# -- the MedicalNet ResNet (the ViT-GAN critic) -------------------------------

class ResBlock3D(nn.Module):
    """A basic block: conv-BN-ReLU, conv-BN, plus the identity or a 1×1
    stride-s conv and BN (``downsample``), then ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv3d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm3d(cout)
        self.conv2 = Conv3d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = BatchNorm3d(cout)
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(Conv3d(cin, cout, 1, stride=stride, bias=False),
                                            BatchNorm3d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn2(self.conv2(ops.relu(self.bn1(self.conv1(x)))))
        residual = self.downsample(x) if hasattr(self, "downsample") else x
        return ops.relu(h + residual)


class ResNet3D(nn.Module):
    """MedicalNet / MONAI 3D ResNet of basic blocks: ``forward(x)`` on
    ``(N, in_ch, D, H, W)`` returns ``(N, num_classes)`` logits."""

    @records_config
    def __init__(self, in_ch: int = 1, block_counts: Sequence[int] = (1, 1, 1, 1),
                 widths: Sequence[int] = (64, 128, 256, 512), num_classes: int = 1,
                 device="cuda"):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.conv1 = Conv3d(in_ch, widths[0], 7, stride=(1, 2, 2), padding=3, bias=False)
            self.bn1 = BatchNorm3d(widths[0])
            prev = widths[0]
            for stage, (n, w) in enumerate(zip(block_counts, widths)):
                blocks = []
                for i in range(n):
                    blocks.append(ResBlock3D(prev, w, 2 if (stage > 0 and i == 0) else 1))
                    prev = w
                setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            self.stages = len(block_counts)
            self.fc = Linear(prev, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = ops.relu(self.bn1(self.conv1(x)))
        h = ops.max_pool3d(F.pad(h, (1, 1, 1, 1, 1, 1), value=float("-inf")), 3, 2)
        for stage in range(self.stages):
            h = getattr(self, f"layer{stage + 1}")(h)
        return self.fc(h.mean(dim=(2, 3, 4)))


def resnet10(num_classes: int = 1, in_ch: int = 1, widths: Sequence[int] = (64, 128, 256, 512),
             device="cuda") -> ResNet3D:
    return ResNet3D(in_ch=in_ch, block_counts=(1, 1, 1, 1), widths=widths,
                    num_classes=num_classes, device=device)


_SMALL_VIT = dict(hidden_size=24, mlp_dim=48, num_layers=2, num_heads=2, feature_size=2)


def vitgan_generator(small: bool = False, img_size=128, device="cuda") -> VitGenerator:
    """ViT-GAN's generator as the reference trains it (train_light_gan.py:124-133:
    feature size 16, 8 layers, 6 heads, mode_multi_dec, Mish,
    multiS_conv=False); ``small`` is the reduced development width."""
    size = _SMALL_VIT if small else dict(num_layers=8, num_heads=6)
    return VitGenerator(img_size=img_size, mode_multi_dec=True, act="mish", multiS_conv=False,
                        device=device, **size)


def exp_generator(small: bool = False, *, act: str = "mish", multis_conv: bool = True,
                  img_size=128, device="cuda") -> VitGenerator:
    """The exp models' TestModel generator (train_light_exp_models.py:118-129,
    :356-363: 8 layers, 6 heads, mode_multi_dec, multiS_conv, ``act`` from
    the command line); ``small`` is the reduced development width."""
    size = _SMALL_VIT if small else dict(num_layers=8, num_heads=6)
    return VitGenerator(img_size=img_size, mode_multi_dec=True, act=act,
                        multiS_conv=multis_conv, device=device, **size)


__all__ = ["AttDecoder", "AttGateExp", "DilatedEncoder", "DilatedSharedDecoder",
           "DilatedSharedEncoder", "ExperimentalBaseUNet", "ExperimentalCascade",
           "InitialEncoderA", "ModelMonai", "MonaiUNet", "MultiAttGate", "PureAttDecoder",
           "PureMultiAttDecoder", "ResBlock3D", "ResNet3D", "SharedDecoder", "SharedEncoder",
           "SharedEncoderModel", "SharedUNetModel", "SharedUNetRModel", "SharedUNetRModelA",
           "VitGenerator", "exp_generator", "resnet10", "vitgan_generator"]
