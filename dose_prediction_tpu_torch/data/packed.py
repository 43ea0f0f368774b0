"""Packed training feed: bit-packed masks + bf16 scalars shipped host→card,
unpacked and augmented on the card at the top of the train step; counterpart
of dose_prediction_tpu/data/packed.py (pack_patient :47,
packed_dose_batches :79, unpack_dose_batch :167, packed_batch_nbytes :217).

Per voxel on the wire:

    ct         bf16 (D,H,W)   2 B   (clipped [-1.024, 1.5])
    dose       bf16 (D,H,W)   2 B
    ptv        uint8 (D,H,W)  1 B   = round(70·ptv): the PTV weights 70/63/56
                                    and their overlap sums are integers ≤ 189
    mask_bits  uint8 (D,H,W)  1 B   bit i = OAR i (7 OARs), bit 7 =
                                    possible_dose_mask

6 B a voxel against 36 B in float32 and 18 B in bf16: a 128³ sample is
12.6 MB. The host draws each sample's augmentation (shift, flip mask, rot90
k; transforms.draw_augment_decisions, the numpy chain's stream) and ships
them as three small tensors; the flips and rot90 are one gather on the card
and the CT shift one add. A patient whose masks are not binary or whose
70·ptv is not an integer declines packing, and callers use the float32 feed.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from dose_prediction_tpu_torch.data.openkbp import OpenKBPDataset, Patient
from dose_prediction_tpu_torch.data.pipeline import _epoch_order, _local_row_range
from dose_prediction_tpu_torch.data.transforms import draw_augment_decisions

_PACKED_ATTR = "_packed_cache"
PACKED_KEYS = ("ct", "dose", "ptv", "mask_bits")


def pack_patient(p: Patient) -> Optional[Dict[str, torch.Tensor]]:
    """Pack one preprocessed patient into the wire format (cached on the
    Patient). Returns None when the volumes are not exactly packable."""
    cached = getattr(p, _PACKED_ATTR, None)
    if cached is not None:
        return cached if cached else None
    ptv70 = p.ptv * 70.0
    ptv_u8 = np.rint(ptv70).astype(np.uint8)
    ok = (
        p.oars.shape[-1] <= 7   # bits 0-6; bit 7 is the dose mask
        and np.abs(ptv70 - np.rint(ptv70)).max() < 1e-3 and ptv70.max() <= 255
        and np.isin(p.oars, (0.0, 1.0)).all()
        and np.isin(p.dose_mask, (0.0, 1.0)).all()
    )
    if not ok:
        setattr(p, _PACKED_ATTR, {})   # remember the decline
        return None
    bits = (p.dose_mask > 0).astype(np.uint8) << 7
    for i in range(p.oars.shape[-1]):
        bits |= (p.oars[..., i] > 0).astype(np.uint8) << i
    packed = {
        "ct": torch.from_numpy(p.ct).to(torch.bfloat16),
        "dose": torch.from_numpy(p.dose).to(torch.bfloat16),
        "ptv": torch.from_numpy(ptv_u8),
        "mask_bits": torch.from_numpy(np.ascontiguousarray(bits)),
    }
    setattr(p, _PACKED_ATTR, packed)
    return packed


def packed_dose_batches(
    dataset: OpenKBPDataset,
    *,
    batch_size: int = 1,
    shuffle: bool = True,
    augment: bool = True,
    seed: int = 0,
    drop_last: bool = False,
    num_samples_per_epoch: int | None = None,
    process_rows=None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """One epoch of packed batches:
    {'ct','dose' (B,D,H,W) bf16; 'ptv','mask_bits' (B,D,H,W) u8;
     'shift' (B,) f32; 'flip' (B,) i32; 'rot_k' (B,) i32}.

    The decisions consume the same rng stream as dose_batches' numpy chain,
    so a packed run and a float32 run with one seed see identical
    augmentations. Raises ValueError if a patient declines packing.
    ``num_samples_per_epoch`` and ``process_rows`` as in
    pipeline.dose_batches."""
    if process_rows is not None:
        # every process must fail (or not) at the same point: an unpackable
        # patient owned by one process would otherwise raise only there
        patients = getattr(dataset, "patients", None)
        if patients is not None:
            bad = [p.patient_id for p in patients if pack_patient(p) is None]
            if bad:
                raise ValueError(
                    f"dataset is not packable (e.g. {bad[:3]}); use the "
                    f"float32 feed for multi-process runs of this dataset")

    rng = np.random.default_rng(seed)
    order = _epoch_order(len(dataset), rng, shuffle, num_samples_per_epoch)
    lo, hi = (None, None)
    if process_rows is not None:
        lo, hi = _local_row_range(batch_size, process_rows)
    for i in range(0, len(order), batch_size):
        idx = order[i:i + batch_size]
        if (drop_last or process_rows is not None) and len(idx) < batch_size:
            return
        cols = {k: [] for k in PACKED_KEYS}
        shifts, flips, rots = [], [], []
        for r, j in enumerate(idx):
            if lo is not None and not (lo <= r < hi):
                if augment:
                    draw_augment_decisions(rng)  # stream parity with owners
                continue
            p = dataset[int(j)]
            packed = pack_patient(p)
            if packed is None:
                raise ValueError(
                    f"patient {p.patient_id} is not packable (non-binary masks "
                    f"or non-integer 70·PTV); use the float32 feed")
            for k in cols:
                cols[k].append(packed[k])
            shift, flip_mask, rot_k = draw_augment_decisions(rng) if augment else (0.0, 0, 0)
            shifts.append(shift)
            flips.append(flip_mask)
            rots.append(rot_k)
        batch = {k: torch.stack(v) for k, v in cols.items()}
        batch["shift"] = torch.tensor(shifts, dtype=torch.float32)
        batch["flip"] = torch.tensor(flips, dtype=torch.int32)
        batch["rot_k"] = torch.tensor(rots, dtype=torch.int32)
        yield batch


def _augment_index(flip: torch.Tensor, rot_k: torch.Tensor, d: int, h: int, w: int):
    """Per-sample source indices of flips over (D, H, W) followed by
    rot90^k in the (D, H) plane (D == H): rows (B, D·H) into the flattened
    (D, H) plane and cols (B, W). Built on the decisions' device from the
    decisions themselves, so choosing a permutation reads nothing back to
    the host."""
    dev = flip.device
    plane = torch.arange(d * h, device=dev).reshape(d, h)
    # rots[k][p] is the plane position that output position p of rot90^k reads
    rots = torch.stack([torch.rot90(plane, k, (0, 1)).reshape(-1) for k in range(4)])
    src = rots[rot_k.long().clamp(0, 3)]               # lax.switch clamps its index
    flip = flip.long()[:, None]
    a, b = src // h, src % h
    a = torch.where((flip & 1) == 1, d - 1 - a, a)
    b = torch.where(((flip >> 1) & 1) == 1, h - 1 - b, b)
    col = torch.arange(w, device=dev).expand(flip.shape[0], w)
    col = torch.where(((flip >> 2) & 1) == 1, w - 1 - col, col)
    return a * h + b, col


def unpack_dose_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Reconstruct {'input': (B,D,H,W,9), 'gt': (B,D,H,W,2)} in float32 from
    a packed batch and apply each sample's augmentation on the batch's device
    (shift → flips → rot90, the transforms.apply_dose_augment order). rot90
    needs D == H (the JAX package's ``lax.switch`` refuses other shapes too).
    The decisions (``shift``, ``flip``, ``rot_k``) must lie on the volumes'
    device, as device_prefetch puts the whole batch: the unpack copies
    nothing from the host, so that a CUDA graph of the step can hold it.

    An already-unpacked {'input','gt'} batch returns unchanged, so steps made
    with ``packed=True`` also take the float32 feed."""
    if "input" in batch:
        return batch
    ct = batch["ct"].float()
    b, d, h, w = ct.shape
    if d != h:
        raise ValueError(f"the packed feed's rot90 needs D == H, got {(d, h, w)}")
    dev = ct.device
    away = {k: str(batch[k].device) for k in ("shift", "flip", "rot_k") if batch[k].device != dev}
    if away:
        raise ValueError(f"packed batch: decisions {away} off the volumes' device {dev}; move "
                         "the whole batch (device_prefetch does)")
    ptv = batch["ptv"].float() * (1.0 / 70.0)
    bits = batch["mask_bits"]
    oars = [((bits >> i) & 1).float() for i in range(7)]
    dose_mask = ((bits >> 7) & 1).float()
    ct = ct + batch["shift"].float()[:, None, None, None]
    inp = torch.stack([ptv, *oars, ct], dim=-1)
    gt = torch.stack([batch["dose"].float(), dose_mask], dim=-1)

    rows, cols = _augment_index(batch["flip"], batch["rot_k"], d, h, w)
    sample = torch.arange(b, device=dev)[:, None, None]

    def aug(vol: torch.Tensor) -> torch.Tensor:
        flat = vol.reshape(b, d * h, w, vol.shape[-1])
        return flat[sample, rows[:, :, None], cols[:, None, :]].reshape(vol.shape)

    return {"input": aug(inp), "gt": aug(gt)}


def packed_batch_nbytes(batch: Dict[str, torch.Tensor]) -> int:
    """Host→card payload of one batch (for feed diagnostics)."""
    return int(sum(v.numel() * v.element_size() for v in batch.values()))
