"""Synthetic OpenKBP-style fixture generator; a copy of
dose_prediction_tpu/data/synthetic.py (make_synthetic_patient :26,
make_synthetic_dataset :72): the same seed writes the same volumes.

Writes a miniature per-patient directory tree (CT/dose/possible_dose_mask +
a subset of PTV/OAR structures as .nii.gz) so the full pipeline — NIfTI IO,
preprocessing, augmentation, training, evaluation — is testable without the
real dataset.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from dose_prediction_tpu_torch.data.nifti import write_nifti
from dose_prediction_tpu_torch.data.openkbp import OAR_NAMES, PTV_NAMES


def _blob(shape, center, radius) -> np.ndarray:
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    dist = ((zz - center[0]) ** 2 + (yy - center[1]) ** 2 + (xx - center[2]) ** 2) ** 0.5
    return (dist <= radius).astype(np.uint8)


def make_synthetic_patient(
    out_dir: Path,
    *,
    shape: Sequence[int] = (32, 32, 32),
    spacing: Sequence[float] = (3.906, 3.906, 2.5),
    seed: int = 0,
    missing_structures: Sequence[str] = (),
) -> Path:
    """Create one synthetic patient directory; returns its path.

    Volumes are written in the on-disk (i, j, k) layout the loader transposes
    (2,1,0), mirroring the real OpenKBP NIfTI convention.
    """
    rng = np.random.default_rng(seed)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    shape = tuple(shape)

    ct = rng.normal(0.0, 300.0, shape).astype(np.float32) - 200.0
    ct += 800.0 * _blob(shape, [s // 2 for s in shape], min(shape) // 3)
    write_nifti(out_dir / "CT.nii.gz", ct.astype(np.int16), spacing=spacing)

    mask = _blob(shape, [s // 2 for s in shape], min(shape) // 2 - 2)
    write_nifti(out_dir / "possible_dose_mask.nii.gz", mask, spacing=spacing)

    dose = np.zeros(shape, np.float32)
    structures = {}
    centers = {}
    for i, name in enumerate(PTV_NAMES + OAR_NAMES):
        c = [int(rng.integers(s // 4, 3 * s // 4)) for s in shape]
        centers[name] = c
        structures[name] = _blob(shape, c, max(2, min(shape) // 8))
    for name, level in (("PTV70", 70.0), ("PTV63", 63.0), ("PTV56", 56.0)):
        dose += level * structures[name] * rng.uniform(0.9, 1.0)
    dose += 5.0 * mask * rng.random(shape).astype(np.float32)
    dose = np.clip(dose, 0.0, 70.0)  # overlapping PTV blobs; real plans cap ≈70 Gy
    dose *= mask
    write_nifti(out_dir / "dose.nii.gz", dose.astype(np.float32), spacing=spacing)

    for name, vol in structures.items():
        if name in missing_structures:
            continue
        write_nifti(out_dir / f"{name}.nii.gz", vol, spacing=spacing)
    return out_dir


def make_synthetic_dataset(
    root: Path,
    *,
    n_patients: int = 2,
    shape: Sequence[int] = (32, 32, 32),
    seed: int = 0,
) -> str:
    """Create ``root/pt_{i}`` patients; returns the glob pattern for them.
    Patient 1 (if present) is missing PTV63 + Esophagus to exercise the
    Empty2FullOAR path (dataloader_OpenKBP_monai.py:84-95)."""
    root = Path(root)
    for i in range(n_patients):
        missing = ("PTV63", "Esophagus") if i == 1 else ()
        make_synthetic_patient(root / f"pt_{i}", shape=shape, seed=seed + i,
                               missing_structures=missing)
    return str(root / "pt_*")
