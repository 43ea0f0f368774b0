"""3D resize with torch interpolate() semantics (counterpart of
dose_prediction_tpu/ops/resize.py). Computed in float32 like the JAX
version's interpolation matrices, then cast back."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F


def resize3d(x: torch.Tensor, out_size: Sequence[int], *, mode: str = "trilinear",
             align_corners: bool = False) -> torch.Tensor:
    """Resize an NCDHW volume to ``out_size = (D', H', W')``; ``mode`` is
    'trilinear', 'nearest' or 'nearest-exact'."""
    if mode not in ("trilinear", "nearest", "nearest-exact"):
        raise ValueError(f"unknown resize mode {mode!r}")
    size = tuple(int(s) for s in out_size)
    if size == tuple(x.shape[2:]):
        return x
    kwargs = {"align_corners": align_corners} if mode == "trilinear" else {}
    return F.interpolate(x.float(), size=size, mode=mode, **kwargs).to(x.dtype)


def upsample3d(x: torch.Tensor, scale: int = 2, *, mode: str = "trilinear",
               align_corners: bool = True) -> torch.Tensor:
    """Scale-factor upsampling (reference F.interpolate(scale_factor=2))."""
    d, h, w = x.shape[2:]
    return resize3d(x, (d * scale, h * scale, w * scale), mode=mode,
                    align_corners=align_corners)


def downsample_pyramid(volume: torch.Tensor, mask: torch.Tensor, *,
                       levels: Sequence[int] = (2, 4, 8)
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """GenLoss.downSample parity (reference loss.py:57-67): trilinear
    (align_corners=True) volumes and nearest-exact masks at ``size / level``
    for each pyramid level, on NCDHW tensors."""
    d, h, w = volume.shape[2:]
    vols, masks = [], []
    for f in levels:
        size = (d // f, h // f, w // f)
        vols.append(resize3d(volume, size, mode="trilinear", align_corners=True))
        masks.append(resize3d(mask, size, mode="nearest-exact"))
    return vols, masks
