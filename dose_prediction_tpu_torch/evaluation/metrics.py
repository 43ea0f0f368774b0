"""OpenKBP evaluation metrics: dose score, DVH metrics, IVS, and the seg
metrics (counterpart of dose_prediction_tpu/evaluation/metrics.py).

The host half (:16-241) is the port's own numpy copy of the reference math
(DosePrediction/Evaluate/evaluate_openKBP.py), equal to the JAX package's
on the same arrays. The device half (:242-379) scores on the card: the
``*_device`` functions take torch tensors and keep every intermediate on
their device, so that only scalars leave it. ``postprocess_prediction``
takes a numpy array (host) or a tensor (device).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

OAR_NAMES = [
    "Brainstem",
    "SpinalCord",
    "RightParotid",
    "LeftParotid",
    "Esophagus",
    "Larynx",
    "Mandible",
]
PTV_NAMES = ["PTV70", "PTV63", "PTV56"]
STRUCTURE_NAMES = OAR_NAMES + PTV_NAMES


# ---------------------------------------------------------------------------
# host (numpy) half
# ---------------------------------------------------------------------------

def dose_score(pred: np.ndarray, gt: np.ndarray, mask: Optional[np.ndarray] = None) -> float:
    """Mean |pred − gt| inside mask (get_3D_Dose_dif, evaluate_openKBP.py:42-48)."""
    if mask is not None:
        pred = pred[mask > 0]
        gt = gt[mask > 0]
    return float(np.mean(np.abs(pred - gt)))


def ivs(pred: np.ndarray, gt: np.ndarray, isodose_level: float,
        mask: Optional[np.ndarray] = None) -> float:
    """Isodose volume similarity: Dice of ≥level regions
    (IVS, evaluate_openKBP.py:17-39)."""
    if mask is not None:
        pred = pred[mask > 0]
        gt = gt[mask > 0]
    p = pred >= isodose_level
    g = gt >= isodose_level
    denom = p.sum() + g.sum()
    return float(2.0 * np.sum(p & g) / denom) if denom else float("nan")


def ivs_sweep(pred: np.ndarray, gt: np.ndarray, *, max_gy: float = 70.0,
              n_levels: int = 101, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """IVS over linspace(0, 70, 101) levels (evaluate_openKBP.py:163-168)."""
    levels = np.linspace(0.0, max_gy, n_levels)
    return np.array([ivs(pred, gt, lv, mask) for lv in levels])


def dvh_metrics(dose: np.ndarray, mask: np.ndarray, *, mode: str,
                spacing: Optional[Sequence[float]] = None) -> Dict[str, float]:
    """DVH features (get_DVH_metrics, evaluate_openKBP.py:51-81). target
    (PTV): D1/D95/D99 as percentiles 99/5/1, and Dmean. OAR: D_0.1_cc as a
    voxel-size-aware percentile, and Dmean."""
    roi = dose[mask > 0]
    out: Dict[str, float] = {}
    if mode == "target":
        out["D1"] = float(np.percentile(roi, 99))
        out["D95"] = float(np.percentile(roi, 5))
        out["D99"] = float(np.percentile(roi, 1))
        out["mean"] = float(np.mean(roi))
    elif mode == "OAR":
        if spacing is None:
            raise ValueError("OAR DVH metrics need voxel spacing")
        voxel_size = float(np.prod(spacing))
        voxels_in_tenth_cc = np.maximum(1, np.round(100.0 / voxel_size))
        frac = 100.0 - voxels_in_tenth_cc / len(roi) * 100.0
        out["D_0.1_cc"] = float(np.percentile(roi, frac))
        out["mean"] = float(np.mean(roi))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return out


def dvh_score_for_patient(pred: np.ndarray, gt: np.ndarray,
                          structures: Dict[str, np.ndarray],
                          spacing: Sequence[float]) -> Dict[str, object]:
    """Per-patient DVH differences over the 10 OpenKBP structures
    (get_Dose_score_and_DVH_score_batch, evaluate_openKBP.py:149-222):
    'dvh_dif' (mean |Δmetric|) and the per-structure pred/gt values."""
    difs: List[float] = []
    detail: Dict[str, float] = {}
    for name in STRUCTURE_NAMES:
        struct = structures.get(name)
        if struct is None or not np.any(struct):
            continue
        mode = "target" if "PTV" in name else "OAR"
        pred_m = dvh_metrics(pred, struct, mode=mode, spacing=spacing)
        gt_m = dvh_metrics(gt, struct, mode=mode, spacing=spacing)
        for metric in gt_m:
            difs.append(abs(gt_m[metric] - pred_m[metric]))
            detail[f"pre{name}_{metric}"] = pred_m[metric]
            detail[f"gt_{name}_{metric}"] = gt_m[metric]
    return {"dvh_dif": float(np.mean(difs)) if difs else float("nan"), "detail": detail}


def postprocess_prediction(pred, mask, *, scale: float = 70.0):
    """Reference post-process (train_light_pyfer.py:169-173,210-212): zero
    the prediction outside the possible-dose mask and where negative, then
    scale to Gy. On a numpy array (a copy, the host path) or a torch tensor
    (on its device, JAX postprocess_prediction_jax)."""
    if isinstance(pred, torch.Tensor):
        keep = (mask >= 1) & (pred >= 0)
        return scale * torch.where(keep, pred, torch.zeros_like(pred))
    out = pred.copy()
    out[np.logical_or(mask < 1, out < 0)] = 0
    return scale * out


def score_prediction_dirs(prediction_dir: str, gt_dir: str):
    """Directory-based OpenKBP scoring (get_Dose_score_and_DVH_score,
    evaluate_openKBP.py:84-146): per-patient folders of ``dose.nii.gz``
    predictions against the ground-truth folders. Returns (mean dose
    difference, mean DVH difference, per-metric gt/pred/dif means)."""
    from dose_prediction_tpu_torch.data.nifti import read_nifti

    list_dose_dif: List[float] = []
    list_dvh_dif: List[float] = []
    sums: Dict[str, Dict[str, List[float]]] = {}

    for patient_id in sorted(os.listdir(prediction_dir)):
        pred_path = os.path.join(prediction_dir, patient_id, "dose.nii.gz")
        gt_path = os.path.join(gt_dir, patient_id, "dose.nii.gz")
        mask_path = os.path.join(gt_dir, patient_id, "possible_dose_mask.nii.gz")
        if not (os.path.exists(pred_path) and os.path.exists(gt_path)
                and os.path.exists(mask_path)):
            continue
        pred = read_nifti(pred_path).data
        gt = read_nifti(gt_path).data
        mask = read_nifti(mask_path).data
        list_dose_dif.append(dose_score(pred, gt, mask))
        for name in STRUCTURE_NAMES:
            spath = os.path.join(gt_dir, patient_id, f"{name}.nii.gz")
            if not os.path.exists(spath):
                continue
            simg = read_nifti(spath)
            mode = "target" if "PTV" in name else "OAR"
            pm = dvh_metrics(pred, simg.data, mode=mode, spacing=simg.spacing)
            gm = dvh_metrics(gt, simg.data, mode=mode, spacing=simg.spacing)
            for metric in gm:
                list_dvh_dif.append(abs(gm[metric] - pm[metric]))
                bucket = sums.setdefault(metric, {"gt": [], "pred": [], "dif": []})
                bucket["gt"].append(gm[metric])
                bucket["pred"].append(pm[metric])
                bucket["dif"].append(abs(gm[metric] - pm[metric]))

    metric_means = {m: {k: float(np.mean(v)) for k, v in b.items()} for m, b in sums.items()}
    return (float(np.mean(list_dose_dif)) if list_dose_dif else float("nan"),
            float(np.mean(list_dvh_dif)) if list_dvh_dif else float("nan"),
            metric_means)


def dice_coefficient(pred: np.ndarray, gt: np.ndarray) -> float:
    """Binary Dice; NaN when both are empty (MONAI DiceMetric)."""
    p = pred > 0
    g = gt > 0
    denom = p.sum() + g.sum()
    if denom == 0:
        return float("nan")
    return float(2.0 * np.sum(p & g) / denom)


def hausdorff95(pred: np.ndarray, gt: np.ndarray,
                spacing: Optional[Sequence[float]] = None) -> float:
    """95th-percentile symmetric Hausdorff distance over surface voxels
    (MONAI HausdorffDistanceMetric(percentile=95), train_light_transeg.py:149-165)."""
    from scipy import ndimage

    p = pred > 0
    g = gt > 0
    if not p.any() or not g.any():
        return float("nan")
    # surface = set minus erosion, on the full arrays (a mask at a crop
    # boundary grows no phantom surface)
    p_surf = p ^ ndimage.binary_erosion(p)
    g_surf = g ^ ndimage.binary_erosion(g)
    # the distance transforms only inside the joint surface bounding box:
    # every source and nearest-target voxel lies in it, so the distances
    # are exact
    union = p_surf | g_surf
    nz = np.nonzero(union)
    slices = tuple(slice(int(i.min()), int(i.max()) + 1) for i in nz)
    p_surf = p_surf[slices]
    g_surf = g_surf[slices]
    sampling = None if spacing is None else tuple(spacing)
    dt_g = ndimage.distance_transform_edt(~g_surf, sampling=sampling)
    dt_p = ndimage.distance_transform_edt(~p_surf, sampling=sampling)
    d_pg = dt_g[p_surf]
    d_gp = dt_p[g_surf]
    return float(max(np.percentile(d_pg, 95), np.percentile(d_gp, 95)))


def seg_metrics_per_class(pred_labels: np.ndarray, gt_labels: np.ndarray,
                          num_classes: int, spacing: Optional[Sequence[float]] = None,
                          include_background: bool = False):
    """Per-class Dice and HD95 from integer label maps (argmax outputs)."""
    start = 0 if include_background else 1
    dices, hds = [], []
    for c in range(start, num_classes):
        p = pred_labels == c
        g = gt_labels == c
        dices.append(dice_coefficient(p, g))
        hds.append(hausdorff95(p, g, spacing))
    return np.array(dices), np.array(hds)


# ---------------------------------------------------------------------------
# device (torch) half
# ---------------------------------------------------------------------------

def dose_score_device(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean |pred − gt| in float32 (dose_score_jax, :242-245)."""
    m = (mask > 0).float()
    num = ((pred.float() - gt.float()).abs() * m).sum()
    return num / m.sum().clamp_min(1.0)


def masked_percentile_device(values: torch.Tensor, mask: torch.Tensor, q) -> torch.Tensor:
    """``np.percentile(values[mask > 0], q)`` without leaving the device
    (masked_percentile_jax, :253-269): one sort with masked-out voxels at
    +inf, the position ``q/100·(n−1)`` in float32 and a linear
    interpolation. ``q`` is a number or a tensor of them (one sort for all);
    an empty mask gives 0."""
    v = values.reshape(-1).float()
    m = mask.reshape(-1) > 0
    n = m.sum()
    v_sorted = torch.sort(torch.where(m, v, torch.full_like(v, float("inf")))).values
    q = torch.as_tensor(q, dtype=torch.float32, device=v.device)
    pos = q / 100.0 * (n.float() - 1.0)
    last = v.shape[0] - 1
    lo = pos.floor().long().clamp(0, last)
    hi = (lo + 1).clamp(0, last)
    frac = pos - lo.float()
    val_lo = v_sorted[lo]
    val_hi = torch.where(hi < n, v_sorted[hi], val_lo)
    # every sorted slot is +inf under an empty mask: 0 keeps a weighted sum finite
    return torch.where(n > 0, val_lo + frac * (val_hi - val_lo), torch.zeros_like(val_lo))


def _tenth_cc_voxels(spacing: Sequence[float]) -> float:
    voxel_size = float(np.prod(np.asarray(spacing, np.float64)))
    return max(1.0, float(np.round(100.0 / voxel_size)))


def dvh_metrics_device(dose: torch.Tensor, mask: torch.Tensor, *, mode: str,
                       spacing=None) -> Dict[str, torch.Tensor]:
    """get_DVH_metrics on the device (dvh_metrics_jax, :272-301): a dict of
    0-d float32 tensors."""
    m = (mask.reshape(-1) > 0).float()
    v = dose.reshape(-1).float()
    n = m.sum().clamp_min(1.0)
    mean = (v * m).sum() / n
    if mode == "target":
        d1, d95, d99 = masked_percentile_device(v, m, [99.0, 5.0, 1.0])
        return {"D1": d1, "D95": d95, "D99": d99, "mean": mean}
    if mode == "OAR":
        if spacing is None:
            raise ValueError("OAR DVH metrics need voxel spacing")
        frac = 100.0 - _tenth_cc_voxels(spacing) / n * 100.0
        return {"D_0.1_cc": masked_percentile_device(v, m, frac), "mean": mean}
    raise ValueError(f"unknown mode {mode!r}")


def isodose_levels(max_gy: float = 70.0, n_levels: int = 101, *,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """The float32 thresholds of ``jnp.linspace(0, max_gy, n_levels)`` as
    XLA folds them (``i · (max_gy · (1 / (n − 1)))``, then ``max_gy``), bit
    for bit: numpy's float64 levels flip boundary voxels."""
    div = n_levels - 1
    step = torch.tensor(max_gy, dtype=torch.float32) * (
        torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(div), dtype=torch.float32))
    levels = torch.arange(div, dtype=torch.float32) * step
    return torch.cat([levels, torch.tensor([max_gy], dtype=torch.float32)]).to(device)


def ivs_sweep_device(pred: torch.Tensor, gt: torch.Tensor, *, max_gy: float = 70.0,
                     n_levels: int = 101) -> torch.Tensor:
    """The IVS sweep over all levels at once (ivs_sweep_jax, :304-312): two
    (levels, voxels) boolean intermediates, 212 MB each at 128³."""
    levels = isodose_levels(max_gy, n_levels, device=pred.device).reshape(-1, 1)
    p = pred.reshape(1, -1).float() >= levels
    g = gt.reshape(1, -1).float() >= levels
    inter = (p & g).sum(dim=1).float()
    denom = (p.sum(dim=1) + g.sum(dim=1)).float()
    return 2.0 * inter / denom.clamp_min(1.0)


def stack_structures(structures: Dict[str, np.ndarray], shape):
    """A patient's structures as a fixed (10, D, H, W) uint8 stack and (10,)
    validity flags in STRUCTURE_NAMES order (absent or empty: valid 0)."""
    stack = np.zeros((len(STRUCTURE_NAMES), *shape), np.uint8)
    valid = np.zeros((len(STRUCTURE_NAMES),), np.float32)
    for i, name in enumerate(STRUCTURE_NAMES):
        s = structures.get(name)
        if s is not None and np.any(s):
            stack[i] = (s > 0)
            valid[i] = 1.0
    return stack, valid


def make_patient_score_fn(spacing: "tuple[float, float, float]", *, with_ivs: bool = True
                          ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``score(pred, gt, mask, struct_stack, valid)``: the dose score, the
    10-structure DVH difference and (``with_ivs``) the IVS sweep of one
    patient, as 0-d (and (101,)) tensors on the inputs' device
    (make_patient_score_fn, :329-357)."""

    def score(pred, gt, mask, struct_stack, valid) -> Dict[str, torch.Tensor]:
        ds = dose_score_device(pred, gt, mask)
        total = torch.zeros((), dtype=torch.float32, device=pred.device)
        count = torch.zeros((), dtype=torch.float32, device=pred.device)
        for i, name in enumerate(STRUCTURE_NAMES):
            mode = "target" if "PTV" in name else "OAR"
            pm = dvh_metrics_device(pred, struct_stack[i], mode=mode, spacing=spacing)
            gm = dvh_metrics_device(gt, struct_stack[i], mode=mode, spacing=spacing)
            for k in gm:
                total = total + valid[i] * (gm[k] - pm[k]).abs()
                count = count + valid[i]
        dvh = torch.where(count > 0, total / count.clamp_min(1.0),
                          torch.full_like(total, float("nan")))
        out = {"dose_dif": ds, "dvh_dif": dvh}
        if with_ivs:
            out["ivs"] = ivs_sweep_device(pred, gt)
        return out

    return score


def patient_scores_device(pred: torch.Tensor, patient, *, with_ivs: bool = True,
                          sync: bool = True) -> Dict[str, object]:
    """OpenKBP scores of one Patient on ``pred``'s device; ``pred`` is the
    post-processed Gy prediction (D, H, W) (patient_scores_device,
    :360-379). ``sync=False`` returns the device tensors unread, so that the
    caller decides when the host waits."""
    dev = pred.device
    stack, valid = stack_structures(patient.structures, patient.real_dose.shape)
    fn = make_patient_score_fn(tuple(float(s) for s in patient.spacing), with_ivs=with_ivs)
    out = fn(pred, torch.from_numpy(patient.real_dose).to(dev),
             torch.from_numpy(patient.dose_mask).to(dev),
             torch.from_numpy(stack).to(dev), torch.from_numpy(valid).to(dev))
    if not sync:
        return out
    res = {"dose_dif": float(out["dose_dif"]), "dvh_dif": float(out["dvh_dif"])}
    if with_ivs:
        res["ivs"] = out["ivs"].cpu().numpy()
    return res
