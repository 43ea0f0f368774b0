"""Host-side augmentation transforms with reference-parity semantics; a copy
of dose_prediction_tpu/data/transforms.py (draw_augment_decisions :180,
rand_rotate_z :127), so that both packages draw one random stream.

Parity targets (dataloader_OpenKBP_monai.py:189-241 and the legacy numpy chain
DosePrediction/DataAugmentation/augmentation_OpenKBP_C3D.py):
- RandShiftIntensityd(CT, offsets=0.10, prob=0.50): uniform offset in
  [-0.1, 0.1] added to the CT channel;
- RandFlipd per spatial axis, prob=0.10 each;
- RandRotate90d(prob=0.10, max_k=3) in the (H, W)-analog plane;
- RandCropByPosNegLabeld(spatial_size, pos=2, neg=1, num_samples): crop
  centers sampled from label>0 voxels with probability pos/(pos+neg), else
  from background.

All transforms act on channels-last (D, H, W, C) numpy arrays and use an
explicit np.random.Generator (keyed randomness discipline; the reference's
global `random` state is deliberately not reproduced).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Arrays = Dict[str, np.ndarray]


def rand_shift_intensity(x: np.ndarray, rng: np.random.Generator,
                         *, offsets: float = 0.10, prob: float = 0.50) -> np.ndarray:
    if rng.random() < prob:
        x = x + np.float32(rng.uniform(-offsets, offsets))
    return x


def rand_flip(arrays: Arrays, rng: np.random.Generator,
              *, prob: float = 0.10) -> Arrays:
    """Independent flips over the three spatial axes, applied consistently to
    every array in the dict."""
    for axis in range(3):
        if rng.random() < prob:
            arrays = {k: np.flip(v, axis=axis) for k, v in arrays.items()}
    return arrays


def rand_rotate90(arrays: Arrays, rng: np.random.Generator,
                  *, prob: float = 0.10, max_k: int = 3,
                  axes: Tuple[int, int] = (0, 1)) -> Arrays:
    if rng.random() < prob:
        k = int(rng.integers(1, max_k + 1))
        arrays = {key: np.rot90(v, k=k, axes=axes) for key, v in arrays.items()}
    return arrays


def _sample_crop_start(label: np.ndarray, rng: np.random.Generator,
                       spatial_size: Sequence[int], *, pos: float, neg: float,
                       fg_indices: Optional[np.ndarray] = None) -> Tuple[int, int, int]:
    """Pick a crop start: sample a center uniformly from label-positive (prob
    pos/(pos+neg)) or background voxels, then clamp so the window fits.

    Foreground centers draw from ``fg_indices`` (pass the cached
    ``np.argwhere(label > 0)`` when sampling the same volume repeatedly).
    Background centers use bounded REJECTION sampling — uniform over the
    background set without materializing ``argwhere(label <= 0)`` (a ~48 MB
    index array per draw on 128³ volumes; the seg feed's old host hotspot)."""
    shape = label.shape[:3]
    take_pos = rng.random() < pos / (pos + neg)
    def _uniform_center():
        return (int(rng.integers(shape[0])), int(rng.integers(shape[1])),
                int(rng.integers(shape[2])))

    if take_pos:
        fg = fg_indices if fg_indices is not None else np.argwhere(label > 0)
        center = fg[rng.integers(len(fg))][:3] if len(fg) else _uniform_center()
    else:
        center = None
        for _ in range(64):   # bg is the majority class in practice
            c = _uniform_center()
            # np.any handles labels with a trailing channel dim (a voxel is
            # background when no channel is positive)
            if not np.any(label[c] > 0):
                center = c
                break
        if center is None:    # (near-)all-foreground volume: exact fallback
            bg = np.argwhere(label <= 0)
            center = (bg[rng.integers(len(bg))][:3] if len(bg)
                      else _uniform_center())
    return tuple(
        int(np.clip(center[i] - spatial_size[i] // 2, 0, shape[i] - spatial_size[i]))
        for i in range(3)
    )


def rand_crop_pos_neg(arrays: Arrays, label: np.ndarray, rng: np.random.Generator,
                      *, spatial_size: Sequence[int] = (96, 96, 96),
                      pos: float = 2.0, neg: float = 1.0,
                      num_samples: int = 1) -> List[Arrays]:
    """RandCropByPosNegLabeld: num_samples crops per volume, centers biased to
    label-positive voxels (provided_dataset.py:158-167). The foreground index
    set is computed at most once per call, not once per sample."""
    out = []
    # one foreground scan per call (not per sample); empty set when no fg
    fg = np.argwhere(label > 0) if np.any(label > 0) else np.empty((0, 3), np.int64)
    for _ in range(num_samples):
        z0, y0, x0 = _sample_crop_start(label, rng, spatial_size,
                                        pos=pos, neg=neg, fg_indices=fg)
        sz, sy, sx = spatial_size
        crop = {
            k: v[z0:z0 + sz, y0:y0 + sy, x0:x0 + sx]
            for k, v in arrays.items()
        }
        out.append(crop)
    return out


def pad_to_shape(x: np.ndarray, target: Sequence[int], *, mode: str = "constant") -> np.ndarray:
    """SpatialPadd equivalent: symmetric zero-pad spatial dims up to target."""
    pads = []
    for i, t in enumerate(target):
        extra = max(0, t - x.shape[i])
        pads.append((extra // 2, extra - extra // 2))
    while len(pads) < x.ndim:
        pads.append((0, 0))
    if not any(p[0] or p[1] for p in pads):
        return x
    return np.pad(x, pads, mode=mode)


def rand_rotate_z(arrays: Arrays, rng: np.random.Generator,
                  *, angles: Sequence[float] = tuple(range(-40, 41, 5)),
                  prob: float = 0.5,
                  orders: Optional[Dict[str, int]] = None,
                  cvals: Optional[Dict[str, float]] = None) -> Arrays:
    """Legacy rotation around the z axis (random_rotate_around_z_axis,
    DataAugmentation/augmentation_OpenKBP_C3D.py:32-55): one angle drawn from
    ``angles``, applied slice-wise in the (H, W) plane about the slice center,
    constant border fill. cv2.warpAffine is replaced by scipy.ndimage.rotate
    (order 1 = bilinear for images, order 0 = nearest for masks)."""
    from scipy import ndimage

    if rng.random() > prob:
        return arrays
    angle = float(angles[int(rng.integers(len(angles)))])
    out = {}
    for key, vol in arrays.items():
        order = (orders or {}).get(key, 1)
        cval = (cvals or {}).get(key, 0.0)
        out[key] = ndimage.rotate(
            vol, angle, axes=(2, 1), reshape=False, order=order,
            mode="constant", cval=cval).astype(vol.dtype)
    return out


def rand_translate(arrays: Arrays, roi_mask: np.ndarray, rng: np.random.Generator,
                   *, prob: float = 0.5, max_shift: int = 20,
                   pad_values: Optional[Dict[str, float]] = None) -> Arrays:
    """Legacy ROI-preserving random translation (random_translate +
    random_pad_to_size_3d, augmentation_OpenKBP_C3D.py:59-113): crop to a box
    that keeps the ROI inside while trimming up to ``max_shift`` border
    voxels, then re-pad to the original size at a random offset."""
    if rng.random() > prob or not np.any(roi_mask > 0):
        return arrays
    nz = np.where(roi_mask > 0)
    shape = roi_mask.shape[:3]
    lo, hi = [], []
    for ax in range(3):
        lo.append(min(max_shift - 1, int(np.min(nz[ax]))))
        hi.append(max(shape[ax] - 1 - max_shift, int(np.max(nz[ax]))))
    cropped = {k: v[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1, lo[2]:hi[2] + 1]
               for k, v in arrays.items()}
    pads = [shape[i] - (hi[i] - lo[i] + 1) for i in range(3)]
    starts = [int(rng.integers(0, p + 1)) for p in pads]
    out = {}
    for k, v in cropped.items():
        width = [(starts[i], pads[i] - starts[i]) for i in range(3)]
        width += [(0, 0)] * (v.ndim - 3)
        out[k] = np.pad(v, width, mode="constant",
                        constant_values=(pad_values or {}).get(k, 0.0))
    return out


def draw_augment_decisions(rng: np.random.Generator,
                           *, shift_prob: float = 0.50, offsets: float = 0.10,
                           flip_prob: float = 0.10, rot_prob: float = 0.10,
                           max_k: int = 3) -> Tuple[float, int, int]:
    """Draw (shift, flip_mask, rot_k) in EXACTLY the rng order the full chain
    consumes them (shift → 3 flips → rot90), so every consumer — the numpy
    chain, the native C++ gather, and the on-device packed-feed augment — sees
    one identical random stream for a given rng state."""
    shift = float(rng.uniform(-offsets, offsets)) if rng.random() < shift_prob else 0.0
    flip_mask = 0
    for axis in range(3):
        if rng.random() < flip_prob:
            flip_mask |= 1 << axis
    rot_k = int(rng.integers(1, max_k + 1)) if rng.random() < rot_prob else 0
    return shift, flip_mask, rot_k


def apply_dose_augment(inp: np.ndarray, gt: np.ndarray, shift: float,
                       flip_mask: int, rot_k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic numpy application of pre-drawn dose-augment decisions
    (the fallback partner of the native fused path: both consume ONE set of
    draws, so the random stream never diverges between paths)."""
    inp = inp.copy()
    if shift:
        inp[..., -1] += np.float32(shift)
    for axis in range(3):
        if flip_mask & (1 << axis):
            inp = np.flip(inp, axis=axis)
            gt = np.flip(gt, axis=axis)
    if rot_k:
        inp = np.rot90(inp, k=rot_k, axes=(0, 1))
        gt = np.rot90(gt, k=rot_k, axes=(0, 1))
    return np.ascontiguousarray(inp), np.ascontiguousarray(gt)


def augment_dose_sample(inp: np.ndarray, gt: np.ndarray,
                        rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """The train-time chain for the dose task (crop_flag=False config):
    intensity shift on the CT channel (last), 3 flips, rot90."""
    shift, flip_mask, rot_k = draw_augment_decisions(rng)
    return apply_dose_augment(inp, gt, shift, flip_mask, rot_k)


def augment_seg_sample(ct: np.ndarray, labels: np.ndarray, rng: np.random.Generator,
                       *, crop: Sequence[int] = (96, 96, 96),
                       num_samples: int = 4) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The seg task chain (provided_dataset.py:125-210): pos/neg 96³ crops ×
    num_samples, then flips/rot90/intensity shift per crop."""
    ct = pad_to_shape(ct, crop)
    labels = pad_to_shape(labels, crop)
    crops = rand_crop_pos_neg({"ct": ct, "labels": labels}, labels, rng,
                              spatial_size=crop, num_samples=num_samples)
    out = []
    for c in crops:
        d = rand_flip({"ct": c["ct"], "labels": c["labels"]}, rng)
        d = rand_rotate90(d, rng)
        cvol = rand_shift_intensity(d["ct"], rng)
        out.append((np.ascontiguousarray(cvol), np.ascontiguousarray(d["labels"])))
    return out


def draw_seg_aug_decisions(rng: np.random.Generator,
                           *, flip_prob: float = 0.10, rot_prob: float = 0.10,
                           max_k: int = 3, shift_prob: float = 0.50,
                           offsets: float = 0.10) -> Tuple[float, int, int]:
    """Draw one seg crop's (shift, flip_mask, rot_k) in EXACTLY the rng order
    augment_seg_sample's per-crop chain consumes them (3 flips → rot90 →
    intensity shift — note: a DIFFERENT order from the dose chain's
    draw_augment_decisions), so the native fused gather and the numpy chain
    see one identical random stream for a given rng state."""
    flip_mask = 0
    for axis in range(3):
        if rng.random() < flip_prob:
            flip_mask |= 1 << axis
    rot_k = int(rng.integers(1, max_k + 1)) if rng.random() < rot_prob else 0
    shift = float(rng.uniform(-offsets, offsets)) if rng.random() < shift_prob else 0.0
    return shift, flip_mask, rot_k


def apply_seg_augment(ct_crop: np.ndarray, labels_crop: np.ndarray,
                      shift: float, flip_mask: int, rot_k: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic numpy application of pre-drawn seg-augment decisions —
    the fallback partner of the native fused gather (both consume ONE set of
    draws, so the random stream never diverges between paths)."""
    for axis in range(3):
        if flip_mask & (1 << axis):
            ct_crop = np.flip(ct_crop, axis=axis)
            labels_crop = np.flip(labels_crop, axis=axis)
    if rot_k:
        ct_crop = np.rot90(ct_crop, k=rot_k, axes=(0, 1))
        labels_crop = np.rot90(labels_crop, k=rot_k, axes=(0, 1))
    ct_crop = np.ascontiguousarray(ct_crop)
    if shift:
        ct_crop = ct_crop + np.float32(shift)
    return ct_crop, np.ascontiguousarray(labels_crop)


def seg_crop_starts(ct_shape: Sequence[int], labels: np.ndarray,
                    rng: np.random.Generator, *, crop: Sequence[int],
                    num_samples: int) -> List[Tuple[int, int, int]]:
    """The crop-start draws of augment_seg_sample, standalone: same stream,
    same clamping — the native fused path samples starts here and gathers in
    C++ (the volume must already fit the crop; callers pad first).
    ``ct_shape`` must agree with the labels' spatial dims: the native gather
    indexes both buffers with one set of strides."""
    if tuple(ct_shape[:3]) != tuple(labels.shape[:3]):
        raise ValueError(f"ct shape {tuple(ct_shape)} does not match labels "
                         f"shape {labels.shape}")
    fg = np.argwhere(labels > 0) if np.any(labels > 0) else np.empty((0, 3), np.int64)
    return [
        _sample_crop_start(labels, rng, crop, pos=2.0, neg=1.0, fg_indices=fg)
        for _ in range(num_samples)
    ]
