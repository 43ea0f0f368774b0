"""Seeded parameter initialisation with an explicit ``torch.Generator``.

Matches torch's default scales (uniform ±1/√fan_in for conv, transposed-conv
and linear weights and biases), ones/zeros for norm affines, zero-mean
unit-variance BatchNorm statistics, and trunc_normal(0.02) ViT position
embeddings. Draws happen on the parameters' own device, so full-width models
are made on the card without a host copy. ``reinit_weights`` is the pix2pix
re-initialisation ViT-GAN's trainer may apply to its generator.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from dose_prediction_tpu_torch.nn import layers


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter and buffer of ``module`` from ``generator``
    (which must live on the parameters' device). Returns ``module``."""
    for m in module.modules():
        if isinstance(m, (layers.Conv3d, layers.ConvTranspose3d, layers.Linear)):
            fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (layers.InstanceNorm3d, layers.BatchNorm3d, layers.LayerNorm)):
            if m.weight is not None:
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
            if isinstance(m, layers.BatchNorm3d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
        for name, p in m.named_parameters(recurse=False):
            if name == "position_embeddings":
                nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=generator)
    return module


def _fans(module: nn.Module, shape) -> tuple:
    """(fan_in, fan_out) of a weight as the JAX package counts them on its
    (k.., I, O) kernels."""
    receptive = math.prod(shape[2:])
    if isinstance(module, layers.ConvTranspose3d):       # (I, O, k..)
        return shape[0] * receptive, shape[1] * receptive
    return shape[1] * receptive, shape[0] * receptive    # (O, I, k..) and (O, I)


def _orthogonal(module: nn.Module, shape, gain: float, generator: torch.Generator
                ) -> torch.Tensor:
    """JAX's orthogonal draw: Q of a normal (receptive·I, O) matrix (rows and
    columns swapped when it is wide), signs from R's diagonal, × gain,
    laid out as the weight."""
    transposed = isinstance(module, layers.ConvTranspose3d)
    cin, cout = (shape[0], shape[1]) if transposed else (shape[1], shape[0])
    rows = math.prod(shape[2:]) * cin
    a = torch.randn((rows, cout), generator=generator, device=generator.device)
    wide = rows < cout
    q, r = torch.linalg.qr(a.T if wide else a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    q = (q.T if wide else q) * gain                       # (rows, O), flax order (k.., I)
    flax = q.reshape(*shape[2:], cin, cout)
    n = len(shape) - 2
    order = (n, n + 1, *range(n)) if transposed else (n + 1, n, *range(n))
    return flax.permute(order).contiguous()


@torch.no_grad()
def reinit_weights(module: nn.Module, generator: torch.Generator, *,
                   init_type: str = "normal", init_gain: float = 0.02) -> nn.Module:
    """The pix2pix re-initialisation (JAX nn/init.py:73-126; reference
    init_weights, train_light_gan.py:29-59), in place: conv, transposed-conv
    and linear weights by ``init_type`` ('normal': N(0, gain); 'xavier':
    N(0, gain·√(2 / (fan_in + fan_out))); 'kaiming': N(0, √(2 / fan_in));
    'orthogonal': gain × an orthogonal matrix), every bias to 0, and norm
    scales to N(1, gain). Draws come from ``generator`` (on the parameters'
    device); they are not the JAX package's draws. Returns ``module``."""
    if init_type not in ("normal", "xavier", "kaiming", "orthogonal"):
        raise NotImplementedError(f"init type {init_type!r}")
    for m in module.modules():
        for name, p in m.named_parameters(recurse=False):
            if name == "bias":
                p.zero_()
            elif name == "weight" and p.ndim >= 2:
                fan_in, fan_out = _fans(m, p.shape)
                if init_type == "orthogonal":
                    p.copy_(_orthogonal(m, p.shape, init_gain, generator))
                    continue
                std = {"normal": init_gain,
                       "xavier": init_gain * math.sqrt(2.0 / (fan_in + fan_out)),
                       "kaiming": math.sqrt(2.0 / fan_in)}[init_type]
                p.normal_(0.0, std, generator=generator)
            elif name == "weight":                         # a norm's scale
                p.normal_(1.0, init_gain, generator=generator)
    return module
