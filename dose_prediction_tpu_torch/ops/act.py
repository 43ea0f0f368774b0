"""Activation functions (counterpart of dose_prediction_tpu/ops/act.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)), computed in float32 like the JAX version."""
    xf = x.float()
    return (xf * torch.tanh(F.softplus(xf))).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x where x >= 0, else alpha · x; a 1-D ``alpha`` is per channel (axis 1)."""
    if alpha.ndim == 1:
        alpha = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    return torch.where(x >= 0, x, alpha * x)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


_ACTS = {
    "relu": relu,
    "leakyrelu": leaky_relu,
    "mish": mish,
    "gelu": gelu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "identity": identity,
    "none": identity,
}


def get_act(name: str):
    """Resolve an activation by name ('relu' | 'mish' | 'leakyrelu' | ...)."""
    try:
        return _ACTS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; options: {sorted(_ACTS)}") from None
