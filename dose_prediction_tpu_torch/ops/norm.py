"""Normalization on NCDHW tensors (counterpart of dose_prediction_tpu/ops/norm.py).

Statistics are float32 with biased variance whatever the activation dtype;
results are cast back to the input dtype. ``instance_norm`` is the plain
version that kernel K2 (kernels/instance_norm.py) is held against.
"""

from __future__ import annotations

import torch

_SPATIAL = (2, 3, 4)


def _affine(y: torch.Tensor, scale, bias) -> torch.Tensor:
    shape = (1, -1) + (1,) * (y.ndim - 2)
    if scale is not None:
        y = y * scale.float().reshape(shape)
    if bias is not None:
        y = y + bias.float().reshape(shape)
    return y


def instance_norm(x: torch.Tensor, scale: torch.Tensor | None = None,
                  bias: torch.Tensor | None = None, *, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm3d over each (sample, channel) of ``(N, C, D, H, W)``, two
    passes: the mean, then the mean squared deviation."""
    xf = x.float()
    mean = xf.mean(dim=_SPATIAL, keepdim=True)
    var = (xf - mean).square().mean(dim=_SPATIAL, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return _affine(y, scale, bias).to(x.dtype)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, *,
               training: bool, momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm3d per channel of ``(N, C, D, H, W)``. Returns
    ``(y, new_running_mean, new_running_var)``; the running variance update
    uses the unbiased batch variance, as torch does."""
    xf = x.float()
    dims = (0,) + _SPATIAL
    shape = (1, -1, 1, 1, 1)
    if training:
        mean = xf.mean(dim=dims)
        var = (xf - mean.reshape(shape)).square().mean(dim=dims)
        n = x.numel() // x.shape[1]
        unbiased = var * (n / max(n - 1, 1))
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * unbiased
    else:
        mean, var = running_mean.float(), running_var.float()
        new_mean, new_var = running_mean, running_var
    y = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
    return _affine(y, scale, bias).to(x.dtype), new_mean, new_var


def group_norm(x: torch.Tensor, scale: torch.Tensor | None = None,
               bias: torch.Tensor | None = None, *, num_groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of ``(N, C, D, H, W)`` over each group's channels and the
    volume, statistics in float32 (JAX ops/norm.py:91-111)."""
    n, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    xf = x.float().reshape(n, num_groups, c // num_groups, *x.shape[2:])
    dims = tuple(range(2, xf.ndim))
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return _affine(y, scale, bias).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing feature axis, in float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)
