"""Official OpenKBP CSV release → the NIfTI layout this framework (and the
reference) trains on; a copy of dose_prediction_tpu/data/openkbp_prepare.py
(parse_sparse_csv :58, prepare_patient :125), its checks included.

The OpenKBP-2020 challenge dataset ships one directory per patient of SPARSE
CSV files — ``ct.csv``, ``dose.csv``, ``possible_dose_mask.csv``, the three
PTVs, the seven OAR masks, and ``voxel_dimensions.csv`` — each CSV holding
flat voxel indices (plus a value column for ct/dose) into a C-ordered
128×128×128 volume. The reference repo trains on a per-patient NIfTI layout
(CT.nii.gz, dose.nii.gz, ..., read_data: dataloader_OpenKBP_monai.py:46-81)
but ships no converter from the official release; this module is that
converter, so a real-data validation run is one command away from the
official download (VERDICT r4 next-round #4).

CSV dialect (matches open-kbp's ``general_functions.load_file``):
- header row ``,data`` (pandas index_col=0 style), then ``<index>,<value>``
  rows; mask files carry ``<index>,`` rows (empty value = membership).
- ``voxel_dimensions.csv``: three voxel sizes, one per line.

Axis convention: the converter writes NIfTI so that OUR loader
(data/openkbp.py: Transposed([2,1,0]) + RAS) reproduces the dense CSV array
exactly — volume[i0,i1,i2] == csv_dense[i0,i1,i2] and the voxel volume
(spacing product) is preserved. This is the one convention that is
verifiable in-repo (roundtrip-tested on a synthetic CSV fixture); the
reference authors' private CSV→NIfTI conversion is not published.

CT values are copied VERBATIM (int16). If your release stores CT with an
unsigned offset instead of Hounsfield units, pass ``ct_offset`` (e.g.
-1024) — the training transform expects HU (clip [-1024,1500] ÷1000,
MyIntensityNormalTransform, dataloader_OpenKBP_monai.py:138-146).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from dose_prediction_tpu_torch.data.nifti import write_nifti
from dose_prediction_tpu_torch.data.openkbp import OAR_NAMES, PTV_NAMES

# the official release is always 128³; the env hook exists ONLY so the
# runbook smoke test (tests/test_validate_real.py) can exercise the whole
# chain at a CI-sized volume through subprocess boundaries
SHAPE = tuple(int(s) for s in
              os.environ.get("DPT_OPENKBP_SHAPE", "128,128,128").split(","))

# official csv name (lowercase) → framework NIfTI stem
CSV_TO_NIFTI = {
    "ct": "CT",
    "dose": "dose",
    "possible_dose_mask": "possible_dose_mask",
    **{name.lower(): name for name in PTV_NAMES + OAR_NAMES},
}


def parse_sparse_csv(path: Path) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(indices, values|None) from one official sparse CSV. values is None
    for mask files (empty/absent value column = membership list)."""
    indices, values = [], []
    has_values = False
    n_missing = 0
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            head = line.split(",")[0].strip()
            if not (head.lstrip("-").isdigit()):
                continue  # header row (',data') or stray text
            parts = line.split(",")
            indices.append(int(parts[0]))
            if len(parts) > 1 and parts[1].strip() not in ("", "nan"):
                values.append(float(parts[1]))
                has_values = True
            else:
                values.append(1.0)
                n_missing += 1
    # a release file is either a value file (ct/dose: EVERY row carries a
    # value) or a membership list (masks: NO row does) — a mix means a
    # corrupt/truncated download, and silently substituting 1.0 for the
    # missing cells would convert it into subtly wrong voxels
    if has_values and n_missing:
        raise ValueError(
            f"{path}: {n_missing} row(s) missing a value in a value-carrying "
            f"CSV — corrupt ct/dose file? (mask files carry no values at all)")
    idx = np.asarray(indices, np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= int(np.prod(SHAPE))):
        raise ValueError(f"{path}: voxel index out of range for {SHAPE}")
    vals = np.asarray(values, np.float32) if has_values else None
    if vals is not None and not np.all(np.isfinite(vals)):
        raise ValueError(f"{path}: non-finite voxel values")
    return idx, vals


def csv_volume(path: Path) -> np.ndarray:
    """Dense C-ordered 128³ float32 volume from a sparse CSV."""
    idx, values = parse_sparse_csv(path)
    flat = np.zeros(int(np.prod(SHAPE)), np.float32)
    flat[idx] = values if values is not None else 1.0
    return flat.reshape(SHAPE)


def read_voxel_dimensions(path: Path) -> Tuple[float, float, float]:
    txt = path.read_text().replace(",", " ").split()
    dims = [float(v) for v in txt]
    if len(dims) != 3 or any(not np.isfinite(d) or d <= 0 for d in dims):
        raise ValueError(f"{path}: expected 3 positive voxel dimensions, "
                         f"got {txt}")
    return tuple(dims)


def _write_dense(out_dir: Path, stem: str, dense: np.ndarray,
                 spacing: Sequence[float], dtype) -> None:
    # with a positive-diagonal sform, the loader's Transposed([2,1,0]) and
    # its RAS reorientation cancel exactly (the reoriented affine permutes
    # the axes back), so the loaded volume equals the file's (i,j,k) array —
    # write the dense CSV array and its voxel dims verbatim
    # (roundtrip identity pinned by test_openkbp_prepare)
    write_nifti(out_dir / f"{stem}.nii.gz", dense.astype(dtype),
                spacing=tuple(spacing))


def prepare_patient(csv_dir: str | Path, out_dir: str | Path, *,
                    ct_offset: float = 0.0,
                    default_spacing: Optional[Sequence[float]] = None,
                    ) -> Dict[str, str]:
    """Convert one official-release patient directory. Returns
    {nifti_stem: 'written'|'absent'} (patients legitimately lack some
    structures — Empty2FullOAR handles that downstream).

    ``voxel_dimensions.csv`` is required: DVH metrics (D0.1cc uses the voxel
    volume) depend on the true per-patient spacing, so a missing file is an
    error rather than a silent guess. Pass ``default_spacing`` (CLI
    ``--assume-spacing D,H,W``) to convert anyway with a stated assumption."""
    csv_dir, out_dir = Path(csv_dir), Path(out_dir)
    files = {p.stem.lower(): p for p in csv_dir.glob("*.csv")}
    if "ct" not in files or "dose" not in files \
            or "possible_dose_mask" not in files:
        raise FileNotFoundError(
            f"{csv_dir}: not an OpenKBP patient directory (needs ct.csv, "
            f"dose.csv, possible_dose_mask.csv)")
    vd = files.get("voxel_dimensions")
    if vd is not None:
        spacing = read_voxel_dimensions(vd)
    elif default_spacing is not None:
        spacing = tuple(float(s) for s in default_spacing)
        print(f"[openkbp-prepare] WARNING {csv_dir.name}: no "
              f"voxel_dimensions.csv — assuming spacing {spacing}; DVH/"
              f"D0.1cc scores for this patient use the assumed voxel volume")
    else:
        raise FileNotFoundError(
            f"{csv_dir}: voxel_dimensions.csv missing (the official release "
            f"always ships it; DVH metrics depend on the true voxel volume). "
            f"Pass --assume-spacing D,H,W to convert with a stated "
            f"assumption.")
    out_dir.mkdir(parents=True, exist_ok=True)

    status: Dict[str, str] = {}
    for csv_name, stem in CSV_TO_NIFTI.items():
        src = files.get(csv_name)
        if src is None:
            status[stem] = "absent"
            continue
        dense = csv_volume(src)
        if csv_name == "ct":
            dense = np.round(dense + ct_offset)
            _write_dense(out_dir, stem, dense, spacing, np.int16)
        elif csv_name == "dose":
            _write_dense(out_dir, stem, dense, spacing, np.float32)
        else:
            _write_dense(out_dir, stem, dense, spacing, np.uint8)
        status[stem] = "written"
    return status


def prepare_cohort(csv_root: str | Path, out_root: str | Path, *,
                   pattern: str = "pt_*", ct_offset: float = 0.0,
                   default_spacing: Optional[Sequence[float]] = None) -> int:
    """Convert every ``pattern`` patient under ``csv_root``; returns the
    number converted. Layout mirrors the input: <out_root>/<patient_id>/."""
    csv_root, out_root = Path(csv_root), Path(out_root)
    patients = sorted(p for p in csv_root.glob(pattern) if p.is_dir())
    if not patients:
        raise FileNotFoundError(f"no '{pattern}' patient dirs in {csv_root}")
    for p in patients:
        status = prepare_patient(p, out_root / p.name, ct_offset=ct_offset,
                                 default_spacing=default_spacing)
        written = sum(v == "written" for v in status.values())
        print(f"[openkbp-prepare] {p.name}: {written} volumes "
              f"({sum(v == 'absent' for v in status.values())} absent)")
    return len(patients)
