"""Training losses (counterpart of dose_prediction_tpu/train/losses.py) on
NCDHW tensors.

Every masked loss is ``sum(err * mask) / max(sum(mask), 1)`` over mask > 0
voxels, in float32, as the JAX package writes the reference's boolean-index
means (DosePrediction/Train/loss.py). Ground truth stacks the dose (÷70) and
the possible-dose mask on the channel axis: ``gt (N, 2, D, H, W)``.
"""

from __future__ import annotations

import torch

from dose_prediction_tpu_torch.ops import downsample_pyramid


def _masked_mean(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = (mask > 0).float()
    return (err.float() * m).sum() / m.sum().clamp_min(1.0)


def masked_l1(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean |pred − gt| over mask > 0 voxels (loss.py:22-27)."""
    return _masked_mean((pred.float() - gt.float()).abs(), mask)


def masked_huber(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                 delta: float = 0.5) -> torch.Tensor:
    """torch.nn.HuberLoss(delta=0.5) over masked voxels (loss.py:53)."""
    d = pred.float() - gt.float()
    ad = d.abs()
    err = torch.where(ad < delta, 0.5 * d * d, delta * (ad - 0.5 * delta))
    return _masked_mean(err, mask)


def cascade_l1_loss(pred_a: torch.Tensor, pred_b: torch.Tensor, gt: torch.Tensor, *,
                    freeze: bool = True) -> torch.Tensor:
    """The plain cascade Loss (loss.py:7-41); an unfrozen net_A's head adds a
    0.5-weighted L1."""
    gt_dose, mask = gt[:, 0:1], gt[:, 1:2]
    loss = masked_l1(pred_b, gt_dose, mask)
    if not freeze:
        loss = 0.5 * masked_l1(pred_a, gt_dose, mask) + loss
    return loss


def gen_loss(predictions, gt: torch.Tensor, *, delta1: float = 10.0, delta2: float = 1.0,
             mode: str = "train", cascade: bool = False, freeze: bool = True,
             huber: bool = False) -> torch.Tensor:
    """The DOSE-PYFER deep-supervision loss (GenLoss, loss.py:50-119).

    ``predictions``: in train + cascade mode ``(pred_A, [B_full, B½, B¼, B⅛])``;
    in train mode without cascade the list of B outputs; in val/test mode one
    full-resolution prediction."""
    gt_dose, mask = gt[:, 0:1], gt[:, 1:2]
    if mode != "train":
        if huber:
            return masked_huber(predictions, gt_dose, mask) + masked_l1(predictions, gt_dose, mask)
        return masked_l1(predictions, gt_dose, mask)
    pred_a, preds_b = predictions if cascade else (None, predictions)
    pred_full, pred_intermediate = preds_b[0], preds_b[1:]
    gt_pyr, mask_pyr = downsample_pyramid(gt_dose, mask, levels=(2, 4, 8))
    l_ds = torch.zeros((), dtype=torch.float32, device=gt.device)
    for pred_i, gt_i, mask_i in zip(pred_intermediate, gt_pyr, mask_pyr):
        l_ds = l_ds + masked_l1(pred_i, gt_i, mask_i)
    l_ds = l_ds / len(pred_intermediate)
    l_pre = (masked_huber if huber else masked_l1)(pred_full, gt_dose, mask)
    loss = delta1 * l_pre + delta2 * l_ds
    if cascade and not freeze:
        loss = loss + 0.5 * masked_l1(pred_a, gt_dose, mask)
    return loss
