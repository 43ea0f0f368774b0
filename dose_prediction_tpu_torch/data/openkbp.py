"""OpenKBP dataset pipeline (head-and-neck, 128³, 200 train / 100 test);
counterpart of dose_prediction_tpu/data/openkbp.py (Patient :51,
_load_volume :95-108, load_patient :111, OpenKBPDataset :171).

Parity target: DosePrediction/DataLoader/dataloader_OpenKBP_monai.py —
per-patient directories ``pt_*`` containing CT/dose/possible_dose_mask plus
optional PTV{70,63,56} and 7 OAR NIfTIs (:46-81); preprocessing chain (:160-243):

1. load volumes, missing structures → zeros (Empty2FullOAR :84);
2. transpose (2,1,0) then reorient to RAS;
3. PTV merge: (70·PTV70 + 63·PTV63 + 56·PTV56)/70 (NormalizePTVTr :116);
4. CT clip [-1024, 1500] ÷ 1000 (MyIntensityNormalTransform :138);
5. dose ÷ 70, keep real_dose (NormalizeDoseTr :129);
6. Input = concat(PTV, 7×OAR, CT) → 9 channels; GT = (dose, mask) → 2 channels.

Preprocessing happens once on the host into a RAM cache of channels-last
numpy arrays (the CacheDataset equivalent, :248-255); training iterates the
cache with numpy-side augmentation (data/pipeline.py) and a pinned-memory
prefetch onto the card.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from dataclasses import dataclass
from glob import glob
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from dose_prediction_tpu_torch.data.nifti import read_nifti, reorient_to_ras

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
OAR_LABELS = {name: i + 1 for i, name in enumerate(OAR_NAMES)}  # ORTransform labels

CT_CLIP = (-1024.0, 1500.0)
CT_SCALE = 1000.0
DOSE_SCALE = 70.0


@dataclass
class Patient:
    """One preprocessed patient, (D, H, W[, C]) arrays. Scalar volumes are
    float32; binary masks (oars, structures) are cached as uint8 — at 200
    patients × 128³ the f32-mask cache alone is ~12 GB of host RAM for
    information that is one bit per voxel. Consumers that need floats get
    them through the model_input/gt properties (astype on the way out)."""

    patient_id: str
    ct: np.ndarray                       # (D,H,W) normalized f32
    ptv: np.ndarray                      # (D,H,W) weighted PTV channel f32
    oars: np.ndarray                     # (D,H,W,7) binary masks, uint8
    dose: np.ndarray                     # (D,H,W) ÷70 normalized f32
    real_dose: np.ndarray                # (D,H,W) in Gy f32
    dose_mask: np.ndarray                # (D,H,W) possible_dose_mask f32
    structures: Dict[str, np.ndarray]    # raw masks for DVH eval, uint8
    spacing: Sequence[float]

    @property
    def model_input(self) -> np.ndarray:
        """(D,H,W,9): PTV, 7 OARs, CT — reference channel order (:196)."""
        return np.concatenate(
            [self.ptv[..., None], self.oars, self.ct[..., None]], axis=-1
        ).astype(np.float32)

    @property
    def gt(self) -> np.ndarray:
        """(D,H,W,2): normalized dose + possible_dose_mask (:199-201)."""
        return np.stack([self.dose, self.dose_mask], axis=-1).astype(np.float32)

    @property
    def oars_label_encoded(self) -> np.ndarray:
        """(D,H,W) int label map, 0=background, 1..7 per OAR_LABELS —
        ORTransform semantics (dataloader_OpenKBP_linked_monai.py:112-117)."""
        out = np.zeros(self.ct.shape, np.int32)
        for i, name in enumerate(OAR_NAMES):
            out[self.oars[..., i] > 0] = i + 1
        return out


def find_patients(pattern: str) -> List[str]:
    """Glob per-patient directories (read_data, :46-50)."""
    return sorted(glob(pattern))


def _load_volume(path: Path) -> Optional[np.ndarray]:
    if not path.exists():
        return None
    img = read_nifti(path)
    # reference: Transposed(indices=[2,1,0]) then Orientationd('RAS')
    img.data = np.ascontiguousarray(np.transpose(img.data, (2, 1, 0)))
    img.spacing = tuple(img.spacing[::-1])
    perm = np.zeros((4, 4))
    perm[3, 3] = 1
    perm[:3, :3] = img.affine[:3, :3][:, ::-1]
    perm[:3, 3] = img.affine[:3, 3]
    img.affine = perm
    img = reorient_to_ras(img)
    return img.data


def load_patient(patient_dir: str, *, keep_structures: bool = True) -> Patient:
    """Load + preprocess one patient directory into a Patient record."""
    pdir = Path(patient_dir)
    ct_img = read_nifti(pdir / "CT.nii.gz")
    spacing = ct_img.spacing

    def vol(name: str) -> Optional[np.ndarray]:
        return _load_volume(pdir / f"{name}.nii.gz")

    ct = vol("CT")
    dose = vol("dose")
    mask = vol("possible_dose_mask")
    if ct is None or dose is None or mask is None:
        raise FileNotFoundError(f"{patient_dir}: missing CT/dose/possible_dose_mask")
    shape = ct.shape

    structures: Dict[str, np.ndarray] = {}
    oars = np.zeros((*shape, len(OAR_NAMES)), np.uint8)
    for i, name in enumerate(OAR_NAMES):
        v = vol(name)
        if v is not None:
            if not np.isin(v, (0.0, 1.0)).all():
                # OpenKBP masks are {0,1}; a non-binary file would be fed
                # verbatim by the reference — surface it instead of silently
                # truncating into the uint8 cache
                print(f"[openkbp] WARNING: {name} mask of {pdir.name} has "
                      f"non-binary values; thresholding at >0")
            oars[..., i] = v > 0
            if keep_structures:
                structures[name] = (v > 0).astype(np.uint8)
    ptvs = {}
    for name in PTV_NAMES:
        v = vol(name)
        if v is not None:
            ptvs[name] = v
            if keep_structures:
                structures[name] = (v > 0).astype(np.uint8)

    ptv = np.zeros(shape, np.float32)
    for name, weight in (("PTV70", 70.0), ("PTV63", 63.0), ("PTV56", 56.0)):
        if name in ptvs:
            ptv += (weight / 70.0) * ptvs[name].astype(np.float32)

    ct_n = np.clip(ct, CT_CLIP[0], CT_CLIP[1]).astype(np.float32) / CT_SCALE
    real_dose = dose.astype(np.float32)
    dose_n = real_dose / DOSE_SCALE

    return Patient(
        patient_id=pdir.name,
        ct=ct_n,
        ptv=ptv,
        oars=oars,
        dose=dose_n,
        real_dose=real_dose,
        dose_mask=mask.astype(np.float32),
        structures=structures,
        spacing=spacing,
    )


class OpenKBPDataset:
    """RAM-cached preprocessed dataset (CacheDataset equivalent, :248-255)."""

    def __init__(self, pattern: str, *, size: Optional[int] = None,
                 keep_structures: bool = False, num_workers: Optional[int] = None):
        dirs = find_patients(pattern)
        if not dirs:
            raise FileNotFoundError(f"no patients match {pattern!r}")
        if size is not None:
            dirs = dirs[:size]
        workers = num_workers if num_workers is not None else min(len(dirs), os.cpu_count() or 1)
        if workers > 1:
            with cf.ThreadPoolExecutor(workers) as ex:
                self.patients = list(ex.map(
                    lambda d: load_patient(d, keep_structures=keep_structures), dirs))
        else:
            self.patients = [load_patient(d, keep_structures=keep_structures) for d in dirs]

    def __len__(self) -> int:
        return len(self.patients)

    def __getitem__(self, idx: int) -> Patient:
        return self.patients[idx]
