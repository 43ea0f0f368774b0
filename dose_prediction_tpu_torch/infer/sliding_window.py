"""Sliding-window inference (counterpart of
dose_prediction_tpu/infer/sliding_window.py::sliding_window_inference,
constant and gaussian blends).

MONAI dense-grid spacing: interval = roi·(1−overlap), the last window
clamped flush to the edge; a volume smaller than the ROI is zero-padded and
the output cropped back. Windows run through the predictor ``sw_batch_size``
at a time; predictions are weighted by the importance map (1 everywhere for
'constant', a separable gaussian for 'gaussian'), summed in float32 and
divided by the summed weights covering each voxel. When ``sw_batch_size``
does not divide the number of windows, the last batch is padded by
repeating the last window and the count counts the repeats, as the JAX
version does
(dose_prediction_tpu/infer/sliding_window.py:110-115): every batch has
``sw_batch_size`` windows, and the repeated window weighs more than the
others in the blend. MONAI runs a shorter last batch instead; that
difference is a fault of both packages (ROADMAP queue 3), kept here so the
two agree. On the main path, 8 windows in one batch of 8, nothing is padded.

``sliding_window_inference_sharded`` splits the window batch over a mesh
axis (parallel/mesh.py; JAX :153-268): the grid is padded to a multiple of
the axis size by repeating the last window, each rank predicts its
contiguous rows of windows in one call, the float32 predictions are
gathered whole over the axis (an exact all-reduce into zeros,
parallel/collectives.py::gather), and every rank blends all of them as the
local engine does, the repeated window counted in the blend as there.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _scan_starts(image: int, roi: int, overlap: float) -> List[int]:
    """MONAI dense_patch_slices grid along one axis."""
    if roi >= image:
        return [0]
    interval = max(int(roi * (1.0 - overlap)), 1)
    num = int(np.ceil((image - roi) / interval)) + 1
    starts: List[int] = []
    for i in range(num):
        start = min(i * interval, image - roi)
        if not starts or start != starts[-1]:
            starts.append(start)
    return starts


def window_grid(image_size: Sequence[int], roi_size: Sequence[int],
                overlap: float = 0.25) -> List[Tuple[int, int, int]]:
    zs, ys, xs = (_scan_starts(image_size[i], roi_size[i], overlap) for i in range(3))
    return [(z, y, x) for z in zs for y in ys for x in xs]


def _importance_map(roi_size: Sequence[int], mode: str, sigma_scale: float = 0.125, *,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """The ``(1, 1, *roi)`` float32 window weights (JAX :56-72): ones for
    'constant'; for 'gaussian' the product of one gaussian per axis
    (centre (s − 1)/2, sigma s·sigma_scale), divided by its maximum and
    floored at float32's smallest normal number."""
    if mode == "constant":
        return torch.ones((1, 1, *roi_size), dtype=torch.float32, device=device)
    if mode != "gaussian":
        raise ValueError(f"unknown blend mode {mode!r}")
    m = None
    for i, s in enumerate(roi_size):
        center, sigma = (s - 1) / 2.0, max(s * sigma_scale, 1e-3)
        x = torch.arange(s, dtype=torch.float32, device=device)
        axis = torch.exp(-0.5 * ((x - center) / sigma) ** 2).view(
            [1, 1] + [s if j == i else 1 for j in range(3)])
        m = axis if m is None else m * axis
    m = m / m.max()
    return m.clamp_min(torch.finfo(torch.float32).tiny)


def _pad_to_roi(volume: torch.Tensor, roi: Tuple[int, int, int]) -> torch.Tensor:
    """``volume`` zero-padded at the far end of each axis shorter than ``roi``."""
    pads = [max(0, roi[i] - volume.shape[2 + i]) for i in range(3)]
    if any(pads):
        volume = F.pad(volume, (0, pads[2], 0, pads[1], 0, pads[0]))
    return volume


def _region(start, roi):
    z, y, x = start
    return (slice(None), slice(None), slice(z, z + roi[0]), slice(y, y + roi[1]),
            slice(x, x + roi[2]))


def _blend(acc: torch.Tensor, count: torch.Tensor, preds: torch.Tensor, starts, roi,
           weight) -> None:
    """Add each window's prediction (× ``weight``, None for 'constant') and
    its weight into ``acc`` and ``count``, in the order of ``starts``."""
    for i, s in enumerate(starts):
        if weight is None:
            acc[_region(s, roi)] += preds[i:i + 1]
            count[_region(s, roi)] += 1.0
        else:
            acc[_region(s, roi)] += preds[i:i + 1] * weight
            count[_region(s, roi)] += weight


def sliding_window_inference(volume: torch.Tensor, predictor: Callable, *,
                             roi_size: Sequence[int] = (96, 96, 96), sw_batch_size: int = 4,
                             overlap: float = 0.25, mode: str = "constant",
                             out_channels: int | None = None) -> torch.Tensor:
    """Run ``predictor`` over overlapping ROI windows of ``volume``.

    Args:
        volume: ``(1, C, D, H, W)``.
        predictor: maps ``(n, C, *roi) -> (n, C_out, *roi)``.
        mode: the blend, 'constant' or 'gaussian'.
        out_channels: C_out (defaults to C).

    Returns:
        ``(1, C_out, D, H, W)`` float32 blend.
    """
    if volume.shape[0] != 1:
        raise ValueError("sliding_window_inference expects batch size 1")
    _, c, d, h, w = volume.shape
    roi = tuple(int(r) for r in roi_size)
    volume = _pad_to_roi(volume, roi)
    full = tuple(volume.shape[2:])
    grid = window_grid(full, roi, overlap)
    n_batches = -(-len(grid) // sw_batch_size)
    # pad the last batch by repeating the last window; the count counts it
    grid = grid + [grid[-1]] * (n_batches * sw_batch_size - len(grid))
    c_out = int(out_channels) if out_channels is not None else c
    # constant: every window weighs 1, added as such
    weight = None if mode == "constant" else _importance_map(roi, mode, device=volume.device)
    acc = torch.zeros((1, c_out, *full), dtype=torch.float32, device=volume.device)
    count = torch.zeros((1, 1, *full), dtype=torch.float32, device=volume.device)
    for b in range(0, len(grid), sw_batch_size):
        starts = grid[b:b + sw_batch_size]
        preds = predictor(torch.cat([volume[_region(s, roi)] for s in starts])).float()
        _blend(acc, count, preds, starts, roi, weight)
    out = acc / count
    return out[:, :, :d, :h, :w]


def make_sliding_window_sharded_fn(predictor: Callable, mesh, *, axis: str = "data",
                                   roi_size: Sequence[int] = (96, 96, 96),
                                   overlap: float = 0.25, mode: str = "constant",
                                   out_channels: int | None = None
                                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``run(volume)``: the sliding window with the window batch split over
    ``mesh``'s ``axis`` (module docstring). Every rank of the axis calls it
    on the same ``(1, C, D, H, W)`` volume and returns the same
    ``(1, C_out, D, H, W)`` float32 blend; ``predictor`` maps ``(n, C,
    *roi) -> (n, C_out, *roi)`` and runs once a call, on this rank's
    windows."""
    from dose_prediction_tpu_torch.parallel import collectives as PC

    roi = tuple(int(r) for r in roi_size)
    parts, index, group = mesh.size(axis), mesh.index(axis), mesh.group(axis)

    def run(volume: torch.Tensor) -> torch.Tensor:
        _, c, d, h, w = volume.shape
        volume = _pad_to_roi(volume, roi)
        full = tuple(volume.shape[2:])
        grid = window_grid(full, roi, overlap)
        grid = grid + [grid[-1]] * (-len(grid) % parts)
        per = len(grid) // parts
        mine = grid[index * per:(index + 1) * per]
        local = predictor(torch.cat([volume[_region(s, roi)] for s in mine])).float()
        preds = PC.gather(local.contiguous(), 0, group)
        c_out = int(out_channels) if out_channels is not None else c
        weight = None if mode == "constant" else _importance_map(roi, mode,
                                                                 device=volume.device)
        acc = torch.zeros((1, c_out, *full), dtype=torch.float32, device=volume.device)
        count = torch.zeros((1, 1, *full), dtype=torch.float32, device=volume.device)
        _blend(acc, count, preds, grid, roi, weight)
        return (acc / count)[:, :, :d, :h, :w]

    return run


def sliding_window_inference_sharded(volume: torch.Tensor, predictor: Callable, mesh, *,
                                     axis: str = "data",
                                     roi_size: Sequence[int] = (96, 96, 96),
                                     overlap: float = 0.25, mode: str = "constant",
                                     out_channels: int | None = None) -> torch.Tensor:
    """One call of :func:`make_sliding_window_sharded_fn` on ``volume``
    (batch 1). The JAX package memoises the function it builds
    (``_SHARDED_FN_CACHE``) only so that a repeat call does not trace and
    compile its program again; the port compiles nothing, so it builds and
    calls."""
    if volume.shape[0] != 1:
        raise ValueError("sliding_window_inference_sharded expects batch size 1")
    return make_sliding_window_sharded_fn(predictor, mesh, axis=axis, roi_size=roi_size,
                                          overlap=overlap, mode=mode,
                                          out_channels=out_channels)(volume)
