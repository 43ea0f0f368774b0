"""Training losses (counterpart of dose_prediction_tpu/train/losses.py) on
NCDHW tensors (class and channel axis 1), all computed in float32.

Every masked loss is ``sum(err * mask) / max(sum(mask), 1)`` over mask > 0
voxels, in float32, as the JAX package writes the reference's boolean-index
means (DosePrediction/Train/loss.py). Ground truth stacks the dose (÷70) and
the possible-dose mask on the channel axis: ``gt (N, 2, D, H, W)``.
"""

from __future__ import annotations

import torch
from torch import nn

from dose_prediction_tpu_torch.ops import downsample_pyramid
from dose_prediction_tpu_torch.parallel.collectives import all_reduce_


def _masked_mean(err: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    m = (mask > 0).float()
    count = m.sum()
    if group is not None:       # this rank's share of the global batch's mean
        all_reduce_(count, group)
    return (err.float() * m).sum() / count.clamp_min(1.0)


def masked_l1(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
              group=None) -> torch.Tensor:
    """Mean |pred − gt| over mask > 0 voxels (loss.py:22-27)."""
    return _masked_mean((pred.float() - gt.float()).abs(), mask, group)


def masked_l1_per_sample(pred: torch.Tensor, gt: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Per-sample masked mean |pred − gt| → (N,) (losses.py:30-38), the
    batched-validation primitive."""
    err = (pred.float() - gt.float()).abs()
    m = (mask > 0).float()
    axes = tuple(range(1, err.ndim))
    return (err * m).sum(dim=axes) / m.sum(dim=axes).clamp_min(1.0)


def masked_huber(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                 delta: float = 0.5, group=None) -> torch.Tensor:
    """torch.nn.HuberLoss(delta=0.5) over masked voxels (loss.py:53)."""
    d = pred.float() - gt.float()
    ad = d.abs()
    err = torch.where(ad < delta, 0.5 * d * d, delta * (ad - 0.5 * delta))
    return _masked_mean(err, mask, group)


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
             huber: bool = False, group=None) -> torch.Tensor:
    """The DOSE-PYFER deep-supervision loss (GenLoss, loss.py:50-119).

    ``predictions``: in train + cascade mode ``(pred_A, [B_full, B½, B¼, B⅛])``;
    in train mode without cascade the list of B outputs; in val/test mode one
    full-resolution prediction. With ``group`` (the 'data' axis of a mesh,
    each rank holding some rows of the global batch) each masked mean
    divides by the global batch's mask count, clamped after the sum: the
    loss is this rank's share, and the shares sum to the global batch's
    loss (every term is linear in the masked means)."""
    gt_dose, mask = gt[:, 0:1], gt[:, 1:2]
    if mode != "train":
        if huber:
            return (masked_huber(predictions, gt_dose, mask, group=group)
                    + masked_l1(predictions, gt_dose, mask, group))
        return masked_l1(predictions, gt_dose, mask, group)
    pred_a, preds_b = predictions if cascade else (None, predictions)
    pred_full, pred_intermediate = preds_b[0], preds_b[1:]
    gt_pyr, mask_pyr = downsample_pyramid(gt_dose, mask, levels=(2, 4, 8))
    l_ds = torch.zeros((), dtype=torch.float32, device=gt.device)
    for pred_i, gt_i, mask_i in zip(pred_intermediate, gt_pyr, mask_pyr):
        l_ds = l_ds + masked_l1(pred_i, gt_i, mask_i, group)
    l_ds = l_ds / len(pred_intermediate)
    l_pre = (masked_huber(pred_full, gt_dose, mask, group=group) if huber
             else masked_l1(pred_full, gt_dose, mask, group))
    loss = delta1 * l_pre + delta2 * l_ds
    if cascade and not freeze:
        loss = loss + 0.5 * masked_l1(pred_a, gt_dose, mask, group)
    return loss


def disc_hinge_loss(real_valid: torch.Tensor, fake_valid: torch.Tensor) -> torch.Tensor:
    """Hinge discriminator loss (DiscLoss, loss.py:44-47; losses.py:115-120)."""
    return (torch.relu(1.0 - real_valid.float()).mean()
            + torch.relu(1.0 + fake_valid.float()).mean())


def gan_loss(logits: torch.Tensor, target_is_real: bool, *, use_lsgan: bool = True
             ) -> torch.Tensor:
    """GANLoss (dosegan.py:12-46; losses.py:123-132): MSE against 1/0 labels
    (LSGAN) or BCE on the sigmoid with eps 1e-12."""
    target = 1.0 if target_is_real else 0.0
    x = logits.float()
    if use_lsgan:
        return (x - target).square().mean()
    p = torch.sigmoid(x)
    eps = 1e-12
    return -(target * torch.log(p + eps) + (1 - target) * torch.log(1 - p + eps)).mean()


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch BCEWithLogitsLoss, written as losses.py:135-139:
    ``mean(max(x, 0) − x·t + log1p(exp(−|x|)))``."""
    x, t = logits.float(), target.float()
    return (torch.clamp_min(x, 0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """torch CrossEntropyLoss on (N, C, D, H, W) logits against integer
    labels (N, D, H, W) (losses.py:141-145)."""
    logp = torch.log_softmax(logits.float(), dim=1)
    return -torch.gather(logp, 1, labels.long().unsqueeze(1)).mean()


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, *, include_background: bool = True,
              smooth_nr: float = 1e-5, smooth_dr: float = 1e-5) -> torch.Tensor:
    """MONAI DiceLoss(to_onehot_y=True, softmax=True) (losses.py:148-167):
    softmax over classes, one-hot labels, soft dice per (sample, class) over
    space, then the mean."""
    n_classes = logits.shape[1]
    probs = torch.softmax(logits.float(), dim=1)
    onehot = nn.functional.one_hot(labels.long(), n_classes).movedim(-1, 1).float()
    if not include_background:
        probs, onehot = probs[:, 1:], onehot[:, 1:]
    axes = tuple(range(2, probs.ndim))
    inter = (probs * onehot).sum(dim=axes)
    denom = probs.sum(dim=axes) + onehot.sum(dim=axes)
    return (1.0 - (2.0 * inter + smooth_nr) / (denom + smooth_dr)).mean()


def dice_ce_loss(logits: torch.Tensor, labels: torch.Tensor, *, lambda_dice: float = 1.0,
                 lambda_ce: float = 1.0, group=None) -> torch.Tensor:
    """MONAI DiceCELoss(to_onehot_y=True, softmax=True), the TranSeg loss
    (train_light_transeg.py:148; losses.py:170-174). With ``group`` (the
    'data' axis of a mesh, each rank holding as many rows of the global
    batch) the loss is this rank's share: both terms are means over the
    rows, so the global loss is the mean of the ranks' losses, and the
    shares sum to it."""
    loss = (lambda_dice * dice_loss(logits, labels)
            + lambda_ce * softmax_cross_entropy(logits, labels))
    return loss if group is None else loss / group.size()
