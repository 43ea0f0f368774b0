"""Seeded parameter initialisation with an explicit ``torch.Generator``.

Matches torch's default scales (uniform ±1/√fan_in for conv, transposed-conv
and linear weights and biases), ones/zeros for norm affines, zero-mean
unit-variance BatchNorm statistics, and trunc_normal(0.02) ViT position
embeddings. Draws happen on the parameters' own device, so full-width models
are made on the card without a host copy.
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
