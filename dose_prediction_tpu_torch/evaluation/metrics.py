"""Dose post-processing on the device (counterpart of
dose_prediction_tpu/evaluation/metrics.py::postprocess_prediction_jax)."""

from __future__ import annotations

import torch


def postprocess_prediction(pred: torch.Tensor, mask: torch.Tensor, *,
                           scale: float = 70.0) -> torch.Tensor:
    """Zero the prediction outside the possible-dose mask and where negative,
    then scale to Gy (reference train_light_pyfer.py:169-173)."""
    keep = (mask >= 1) & (pred >= 0)
    return scale * torch.where(keep, pred, torch.zeros_like(pred))
