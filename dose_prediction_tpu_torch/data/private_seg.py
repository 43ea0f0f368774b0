"""Private 13-OAR head segmentation dataset loader; counterpart of
dose_prediction_tpu/data/private_seg.py (load_private_patient :58,
PrivateSegDataset :88), with its own copy of
dose_prediction_tpu/ops/resize.py::_interp_matrix (:27).

Parity target: OARSegmentation/DataLoader/private_dataset.py — in-house head
CT dataset with 13 OAR structures (OAR_NAMES_DIC :32-47), preprocessing chain
(:141-180): in-plane resize to 128×128 (area for CT, nearest for masks), CT
clip [-2048, 2500] ÷ 2000 (:126-133, get_dataset defaults :225), label-encoded
OAR channel (ORTransform :112-118), depth zero-pad to ≥128 (SpatialPadd
:172), and the fixed 16-patient validation split (:227).
"""

from __future__ import annotations

from functools import lru_cache
from glob import glob
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from dose_prediction_tpu_torch.data.nifti import read_nifti
from dose_prediction_tpu_torch.data.transforms import pad_to_shape

PRIVATE_OAR_NAMES = [
    "BRAIN_STEM",
    "L_EYE",
    "R_EYE",
    "L_LACRIMAL",
    "R_LACRIMAL",
    "L_LENS",
    "R_LENS",
    "L_OPTIC_NERVE",
    "R_OPTIC_NERVE",
    "L_TEMPORAL_LOBE",
    "R_TEMPORAL_LOBE",
    "OPTIC_CHIASM",
    "PITUITARY",
]
PRIVATE_OAR_LABELS = {n: i + 1 for i, n in enumerate(PRIVATE_OAR_NAMES)}

# fixed validation patient indices (private_dataset.py:227)
VAL_SPLIT = [44, 23, 6, 16, 43, 42, 90, 21, 54, 46, 39, 75, 62, 84, 65, 30]

CT_CLIP = (-2048.0, 2500.0)
CT_SCALE = 2000.0


@lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, mode: str, align_corners: bool) -> np.ndarray:
    """Dense (out_size, in_size) resampling matrix, float32 (PyTorch
    interpolate() semantics for 'linear', 'nearest' and 'nearest-exact')."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    i = np.arange(out_size, dtype=np.float64)
    if mode == "linear":
        if align_corners:
            src = i * (in_size - 1) / max(out_size - 1, 1)
        else:
            src = np.clip((i + 0.5) * in_size / out_size - 0.5, 0.0, in_size - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, in_size - 1)
        frac = (src - lo).astype(np.float64)
        np.add.at(m, (np.arange(out_size), lo), (1.0 - frac).astype(np.float32))
        np.add.at(m, (np.arange(out_size), hi), frac.astype(np.float32))
    elif mode == "nearest":
        idx = np.minimum(np.floor(i * in_size / out_size), in_size - 1).astype(np.int64)
        m[np.arange(out_size), idx] = 1.0
    elif mode == "nearest-exact":
        idx = np.minimum(np.floor((i + 0.5) * in_size / out_size), in_size - 1).astype(np.int64)
        m[np.arange(out_size), idx] = 1.0
    else:
        raise ValueError(f"unknown resize mode {mode!r}")
    return m


def _resize_axis(vol: np.ndarray, axis: int, out_size: int, mode: str) -> np.ndarray:
    """Host-side per-axis resize with the framework's interpolation matrices
    ('linear' ≈ MONAI 'area' for downscale parity within tolerance;
    'nearest' exact)."""
    in_size = vol.shape[axis]
    if in_size == out_size:
        return vol
    m = _interp_matrix(in_size, out_size, mode, False)
    return np.moveaxis(np.tensordot(m, np.moveaxis(vol, axis, 0), axes=(1, 0)), 0, axis)


def load_private_patient(patient_dir: str) -> Dict[str, np.ndarray]:
    """Load one patient: returns {'ct': (D,128,128), 'labels': (D,128,128) int32,
    'spacing': (3,)}; depth padded to ≥128."""
    pdir = Path(patient_dir)
    ct_img = read_nifti(pdir / "CT.nii.gz")
    # on-disk (i,j,k) → (D,H,W) like the OpenKBP loader
    ct = np.ascontiguousarray(np.transpose(ct_img.data, (2, 1, 0))).astype(np.float32)

    labels = np.zeros(ct.shape, np.int32)
    for name, lab in PRIVATE_OAR_LABELS.items():
        p = pdir / f"{name}.nii.gz"
        if p.exists():
            mask = np.transpose(read_nifti(p).data, (2, 1, 0))
            labels[mask > 0] = lab

    # in-plane resize to 128×128 (area/linear CT, nearest labels)
    for axis in (1, 2):
        ct = _resize_axis(ct, axis, 128, "linear")
    lab_f = labels.astype(np.float32)
    for axis in (1, 2):
        lab_f = _resize_axis(lab_f, axis, 128, "nearest")
    labels = lab_f.astype(np.int32)

    ct = np.clip(ct, CT_CLIP[0], CT_CLIP[1]) / CT_SCALE
    ct = pad_to_shape(ct, (128, 128, 128))
    labels = pad_to_shape(labels, (128, 128, 128))
    return {"ct": ct.astype(np.float32), "labels": labels,
            "spacing": np.asarray(ct_img.spacing[::-1], np.float32)}


class PrivateSegDataset:
    """RAM-cached private dataset with the reference's fixed val split."""

    def __init__(self, pattern: str, *, split: str = "train",
                 val_indices: Optional[Sequence[int]] = None):
        dirs = sorted(glob(pattern))
        if not dirs:
            raise FileNotFoundError(f"no patients match {pattern!r}")
        val_idx = set(val_indices if val_indices is not None else VAL_SPLIT)
        if split == "train":
            chosen = [d for i, d in enumerate(dirs) if i not in val_idx]
        elif split == "val":
            chosen = [d for i, d in enumerate(dirs) if i in val_idx]
        else:
            raise ValueError(f"unknown split {split!r}")
        self._dirs = chosen
        self.records = [load_private_patient(d) for d in chosen]

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i):
        return self.records[i]

    def as_seg(self) -> "_PrivateSegPatients":
        """Adapt to the seg-trainer surface (ct / oars_label_encoded / spacing)
        so TranSegTrainer + seg_batches consume the private dataset unchanged
        — the PrivateDataModule path (train_light_transeg.py:64-82). Use
        num_classes=14 (13 OARs + background)."""
        return _PrivateSegPatients(self)


class _PrivateSegPatient:
    def __init__(self, record: Dict[str, np.ndarray], patient_id: str):
        self.patient_id = patient_id
        self.ct = record["ct"]
        self.oars_label_encoded = record["labels"]
        self.spacing = tuple(float(s) for s in record["spacing"])


class _PrivateSegPatients:
    def __init__(self, ds: PrivateSegDataset):
        self.patients = [
            _PrivateSegPatient(rec, Path(d).name)
            for rec, d in zip(ds.records, ds._dirs)
        ]

    def __len__(self):
        return len(self.patients)

    def __getitem__(self, i):
        return self.patients[i]
