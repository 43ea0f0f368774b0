"""Minimal pure-numpy NIfTI-1 reader/writer (.nii / .nii.gz); counterpart of
dose_prediction_tpu/data/nifti.py (read_nifti :54, _qform_affine :153,
write_nifti :170, orientation_codes :201, reorient_to_ras :221), a copy that
reads through the port's own native wrapper (data/native.py).

The reference reads OpenKBP volumes through SimpleITK / MONAI LoadImaged
(dataloader_OpenKBP_monai.py:163, dataloader_OpenKBP_C3D.py:45); neither is in
this image, so the framework carries its own IO. Supports the subset of
NIfTI-1 the OpenKBP-style datasets use: scalar 3D volumes, common dtypes,
scl_slope/scl_inter scaling, qform/sform affines.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HEADER_SIZE = 348


@dataclass
class NiftiImage:
    data: np.ndarray                      # index order (i, j, k) = fastest-first
    affine: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float64))
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    @property
    def shape(self):
        return self.data.shape


def _open_maybe_gz(path: Path, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: Union[str, Path], *, prefer_native: bool = True) -> NiftiImage:
    """Read a NIfTI-1 file. Returns data indexed (i, j, k) like
    nibabel.get_fdata() — i.e. the first axis is the fastest-varying on disk.

    When the native C++ runtime is available (native/dose_io.cpp, built by
    data/native.py) it handles the gzip inflate + voxel decode (float32
    output); the numpy path is the fallback and the behavior reference. A
    library that did not build is reported by native.native_build_error().
    """
    path = Path(path)
    if prefer_native:
        from dose_prediction_tpu_torch.data import native as _native

        out = _native.read_image_full(path)
        if out is not None:
            data, spacing, affine = out
            return NiftiImage(data=data, affine=affine,
                              spacing=tuple(abs(s) for s in spacing))
    try:
        with _open_maybe_gz(path, "rb") as f:
            raw = f.read()
    except (EOFError, OSError, gzip.BadGzipFile) as e:
        # truncated/corrupt gzip streams raise EOFError / BadGzipFile from
        # the zlib layer; surface ONE exception type for malformed inputs
        raise ValueError(f"{path}: corrupt or truncated gzip stream ({e})") from e
    if len(raw) < HEADER_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr == HEADER_SIZE:
        endian = "<"
    elif struct.unpack_from(">i", raw, 0)[0] == HEADER_SIZE:
        endian = ">"
    else:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")

    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack_from(endian + "8h", raw, 40)
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: invalid NIfTI rank dim[0]={ndim}")
    shape = tuple(int(d) for d in dim[1: 1 + ndim])
    if any(d < 1 for d in shape):
        raise ValueError(f"{path}: non-positive dimension in {shape}")
    # scalar volumes only: squeeze trailing singletons (a (128³,1) file is a
    # 3D volume); anything genuinely >3D has no meaning to this pipeline
    while len(shape) > 3 and shape[-1] == 1:
        shape = shape[:-1]
    if len(shape) > 3:
        raise ValueError(f"{path}: only scalar 3D volumes supported, got {shape}")
    datatype = struct.unpack_from(endian + "h", raw, 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    pixdim = struct.unpack_from(endian + "8f", raw, 76)
    vox_offset_f = struct.unpack_from(endian + "f", raw, 108)[0]
    # vox_offset is a FLOAT field: reject NaN/negative/past-EOF before use
    if not (HEADER_SIZE <= vox_offset_f <= len(raw)):
        raise ValueError(f"{path}: invalid vox_offset {vox_offset_f}")
    vox_offset = int(vox_offset_f)
    scl_slope = struct.unpack_from(endian + "f", raw, 112)[0]
    scl_inter = struct.unpack_from(endian + "f", raw, 116)[0]
    if not (np.isfinite(scl_slope) and np.isfinite(scl_inter)):
        scl_slope, scl_inter = 1.0, 0.0  # nibabel semantics: ignore bad scl
    sform_code = struct.unpack_from(endian + "h", raw, 254)[0]
    qform_code = struct.unpack_from(endian + "h", raw, 252)[0]

    count = int(np.prod(shape)) if shape else 0
    if len(raw) - vox_offset < count * np_dtype.itemsize:
        raise ValueError(
            f"{path}: voxel data truncated — header claims {shape} "
            f"({count * np_dtype.itemsize} bytes) but only "
            f"{len(raw) - vox_offset} bytes follow vox_offset")
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=vox_offset)
    # NIfTI voxels are Fortran-ordered: first index fastest
    data = data.reshape(shape, order="F")
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter

    affine = np.eye(4)
    if sform_code > 0:
        rows = struct.unpack_from(endian + "12f", raw, 280)
        affine[0, :] = rows[0:4]
        affine[1, :] = rows[4:8]
        affine[2, :] = rows[8:12]
    elif qform_code > 0:
        affine = _qform_affine(raw, endian, pixdim)
    else:
        affine[0, 0], affine[1, 1], affine[2, 2] = pixdim[1], pixdim[2], pixdim[3]

    spacing = tuple(float(abs(p)) for p in pixdim[1:4])
    return NiftiImage(data=np.ascontiguousarray(data), affine=affine, spacing=spacing)


def _qform_affine(raw: bytes, endian: str, pixdim) -> np.ndarray:
    b, c, d = struct.unpack_from(endian + "3f", raw, 256)
    qx, qy, qz = struct.unpack_from(endian + "3f", raw, 268)
    a2 = 1.0 - (b * b + c * c + d * d)
    a = float(np.sqrt(max(a2, 0.0)))
    qfac = -1.0 if pixdim[0] < 0 else 1.0
    r = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    affine = np.eye(4)
    affine[:3, :3] = r * np.array([pixdim[1], pixdim[2], qfac * pixdim[3]])
    affine[:3, 3] = (qx, qy, qz)
    return affine


def write_nifti(path: Union[str, Path], data: np.ndarray,
                affine: Optional[np.ndarray] = None,
                spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)) -> None:
    """Write a 3D volume as NIfTI-1 (.nii or .nii.gz), sform affine."""
    path = Path(path)
    data = np.asarray(data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    if affine is None:
        affine = np.diag([spacing[0], spacing[1], spacing[2], 1.0])

    hdr = bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, HEADER_SIZE)
    dims = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[data.dtype])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, spacing[0], spacing[1], spacing[2], 0, 0, 0, 0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)    # scl_inter
    struct.pack_into("<h", hdr, 252, 0)      # qform_code
    struct.pack_into("<h", hdr, 254, 1)      # sform_code = NIFTI_XFORM_SCANNER_ANAT
    struct.pack_into("<12f", hdr, 280, *affine[0, :], *affine[1, :], *affine[2, :])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + np.asfortranarray(data).tobytes(order="F")
    with _open_maybe_gz(path, "wb") as f:
        f.write(payload)


def orientation_codes(affine: np.ndarray) -> str:
    """Closest-axis orientation code (e.g. 'RAS', 'LPS') of an affine —
    nibabel aff2axcodes semantics for orthogonal-ish affines."""
    rot = affine[:3, :3]
    codes = []
    labels = (("L", "R"), ("P", "A"), ("I", "S"))
    used = set()
    for col in range(3):
        vec = rot[:, col]
        axis = int(np.argmax(np.abs(vec)))
        while axis in used:  # degenerate affine: pick next-best axis
            v = np.abs(vec).copy()
            for u in used:
                v[u] = -1
            axis = int(np.argmax(v))
        used.add(axis)
        codes.append(labels[axis][1] if vec[axis] >= 0 else labels[axis][0])
    return "".join(codes)


def reorient_to_ras(img: NiftiImage) -> NiftiImage:
    """Flip/permute voxel axes so the affine maps +i,+j,+k to +R,+A,+S —
    MONAI Orientationd(axcodes='RAS') semantics (dataloader_OpenKBP_monai.py:180)."""
    rot = img.affine[:3, :3]
    data = img.data
    affine = img.affine.copy()
    # assign each voxel axis to its dominant world axis
    perm = []
    flips = []
    used = set()
    for col in range(3):
        vec = rot[:, col]
        axis = int(np.argmax(np.abs(vec)))
        while axis in used:
            v = np.abs(vec).copy()
            for u in used:
                v[u] = -1
            axis = int(np.argmax(v))
        used.add(axis)
        perm.append(axis)
        flips.append(vec[axis] < 0)
    # inverse permutation: world axis w comes from voxel axis perm.index(w)
    inv = [perm.index(w) for w in range(3)]
    data = np.transpose(data, inv)
    new_affine = np.eye(4)
    for w in range(3):
        src = inv[w]
        new_affine[:3, w] = affine[:3, src]
    spacing = tuple(img.spacing[src] for src in inv)
    for w in range(3):
        if flips[inv[w]]:
            data = np.flip(data, axis=w)
            new_affine[:3, 3] = new_affine[:3, 3] + new_affine[:3, w] * (data.shape[w] - 1)
            new_affine[:3, w] = -new_affine[:3, w]
    return NiftiImage(data=np.ascontiguousarray(data), affine=new_affine, spacing=spacing)
