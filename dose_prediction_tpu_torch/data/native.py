"""ctypes bindings for the native C++ data-path runtime (native/dose_io.cpp);
counterpart of dose_prediction_tpu/data/native.py, with the same argtypes
(:46-89).

The port compiles ``native/dose_io.cpp`` itself with the flags of
``native/Makefile`` into ``dose_prediction_tpu_torch/_build/`` (git-ignored),
under a name hashed from the source and the flags. The build holds a file
lock, writes to a temporary name and moves the library into place with
``os.replace``, so processes that load at once build it once and a second
caller finds the finished library. It never runs ``make`` and never writes
under ``native/``.

Every entry point returns None when the library is unavailable or declines
an input, and the callers then take the numpy path (data/nifti.py,
data/transforms.py), as in the JAX package. A failed build is not hidden:
``native_build_error()`` returns the compiler's output. bf16 outputs are
``torch.bfloat16`` tensors on the host.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dose_prediction_tpu_torch.data.transforms import draw_augment_decisions

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dose_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall")
LD_FLAGS = ("-shared", "-lz", "-lpthread")
BUILD_TIMEOUT_S = 300
# the longest wait for another process's build (its compile limit, and then some)
LOCK_WAIT_S = BUILD_TIMEOUT_S + 60

_P = ctypes.POINTER
_F32, _I64, _INT = ctypes.c_float, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "dose_io_load": (_INT, [ctypes.c_char_p, _P(_F32), _I64, _P(_I64), _P(_F32)]),
    "dose_io_probe": (_INT, [ctypes.c_char_p, _P(_I64), _P(_F32)]),
    "dose_io_load_full": (_INT, [ctypes.c_char_p, _P(_F32), _I64, _P(_I64), _P(_F32),
                                 _P(_F32)]),
    "dose_io_load_batch": (_INT, [_P(ctypes.c_char_p), _INT, _P(_F32), _I64, _P(_I64),
                                  _P(_F32), _P(_INT), _INT]),
    "dose_io_preprocess_ct": (None, [_P(_F32), _I64, _F32, _F32, _F32]),
    "dose_io_augment_dose_bf16": (_INT, [_P(_F32), _P(_F32), _I64, _I64, _I64, _I64, _I64,
                                         _F32, _INT, _INT, _P(ctypes.c_uint16),
                                         _P(ctypes.c_uint16), _INT]),
    "dose_io_augment_seg_bf16": (_INT, [_P(_F32), _P(ctypes.c_uint8), _I64, _I64, _I64,
                                        _I64, _I64, _I64, _I64, _I64, _I64, _F32, _INT,
                                        _INT, _P(ctypes.c_uint16), _P(ctypes.c_uint8),
                                        _INT]),
}


def library_path() -> Path:
    """Path of the library built from the current source and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdose_io_{h.hexdigest()[:16]}.so"


def _wait_for_lock(lock) -> None:
    """Take the build lock, or raise after LOCK_WAIT_S: a holder that builds
    for longer than its own compile limit has died or hung."""
    deadline = time.monotonic() + LOCK_WAIT_S
    while True:
        try:
            fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
            return
        except BlockingIOError:
            if time.monotonic() > deadline:
                raise RuntimeError(f"{lock.name}: held for over {LOCK_WAIT_S} s by another "
                                   "build") from None
            time.sleep(0.1)


def build() -> Path:
    """Compile ``native/dose_io.cpp`` unless the library for this source
    exists. Raises RuntimeError with the compiler's output if it fails."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libdose_io.lock", "w") as lock:
        _wait_for_lock(lock)                   # released when the file closes
        if out.is_file():                      # built by the holder before us
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LD_FLAGS],
                                  capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                                   f"{(proc.stdout + proc.stderr)[-4000:]}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=1)
def _load() -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        return None, f"{type(e).__name__}: {e}"
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib, None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at first use; None if it could not be
    built or loaded (``native_build_error()`` says why)."""
    return _load()[0]


def native_build_error() -> Optional[str]:
    """Why the library is unavailable (the compiler's output tail), or None
    when it built and loaded."""
    return _load()[1]


def native_available() -> bool:
    return get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_P(_F32))


def _probe(lib, path) -> Optional[Tuple[int, int, int]]:
    """The volume's (i, j, k) shape from its header, or None if declined."""
    shape = (_I64 * 3)()
    spacing = (_F32 * 3)()
    if lib.dose_io_probe(str(path).encode(), shape, spacing) != 0:
        return None
    return tuple(shape)


def _ijk(buf: np.ndarray, shape) -> np.ndarray:
    # NIfTI voxels are Fortran-ordered; match data.nifti.read_nifti layout
    return np.ascontiguousarray(buf.reshape((shape[2], shape[1], shape[0])).transpose(2, 1, 0))


def read_volume_f32(path: str | Path) -> Optional[Tuple[np.ndarray, Tuple[float, float, float]]]:
    """Native load of one NIfTI volume as float32 (i,j,k order); None when the
    native library is unavailable or declines the file."""
    lib = get_lib()
    probed = None if lib is None else _probe(lib, path)
    if probed is None:
        return None
    shape = (_I64 * 3)(*probed)
    spacing = (_F32 * 3)()
    n = int(np.prod(probed))
    buf = np.empty(n, np.float32)
    if lib.dose_io_load(str(path).encode(), _fptr(buf), n, shape, spacing) != 0:
        return None
    return _ijk(buf, shape), (spacing[0], spacing[1], spacing[2])


def read_image_full(path: str | Path):
    """Native load of one volume with full geometry: returns
    (data (i,j,k) float32, spacing, affine 4x4) or None when unavailable."""
    lib = get_lib()
    probed = None if lib is None else _probe(lib, path)
    if probed is None:
        return None
    shape = (_I64 * 3)(*probed)
    spacing = (_F32 * 3)()
    affine12 = (_F32 * 12)()
    n = int(np.prod(probed))
    buf = np.empty(n, np.float32)
    if lib.dose_io_load_full(str(path).encode(), _fptr(buf), n, shape, spacing, affine12) != 0:
        return None
    affine = np.eye(4)
    affine[:3, :] = np.asarray(affine12, np.float64).reshape(3, 4)
    return (_ijk(buf, shape), (float(spacing[0]), float(spacing[1]), float(spacing[2])),
            affine)


def read_batch_f32(paths: Sequence[str | Path], *, n_threads: int = 4
                   ) -> Optional[List[Tuple[np.ndarray, Tuple[float, float, float]]]]:
    """Concurrent native load of many volumes; None on unavailability."""
    lib = get_lib()
    if lib is None or not paths:
        return None
    count = len(paths)
    shapes = (_I64 * (3 * count))()
    spacings = (_F32 * (3 * count))()
    stride = 0                                  # the largest volume sizes each slot
    for p in paths:
        probed = _probe(lib, p)
        if probed is None:
            return None
        stride = max(stride, int(np.prod(probed)))
    buf = np.empty(count * stride, np.float32)
    status = (_INT * count)()
    c_paths = (ctypes.c_char_p * count)(*[str(p).encode() for p in paths])
    if lib.dose_io_load_batch(c_paths, count, _fptr(buf), stride, shapes, spacings, status,
                              n_threads) != 0:
        return None
    out = []
    for i in range(count):
        shape = shapes[3 * i: 3 * i + 3]
        vol = buf[i * stride: i * stride + int(np.prod(shape))]
        out.append((_ijk(vol, shape), tuple(spacings[3 * i: 3 * i + 3])))
    return out


def _bf16(a: np.ndarray) -> torch.Tensor:
    """uint16 bit patterns of bfloat16 values as a torch.bfloat16 tensor."""
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)


def augment_dose_bf16(inp: np.ndarray, gt: np.ndarray,
                      rng: Optional[np.random.Generator] = None, *,
                      decisions: Optional[Tuple[float, int, int]] = None,
                      n_threads: int = 4
                      ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Fused native augmentation + bf16 cast for one (D,H,W,Ci)/(D,H,W,Cg)
    sample: one gather pass instead of the numpy chain's several full-volume
    copies, and the output ships as bf16. Returns None when the library is
    unavailable or the inputs unfit (callers fall back to the numpy chain).

    ``decisions`` takes pre-drawn (shift, flip_mask, rot_k); pass it when the
    caller shares one set of draws with a fallback path (the random stream
    must not diverge when the native call declines)."""
    lib = get_lib()
    if lib is None or inp.dtype != np.float32 or gt.dtype != np.float32:
        return None
    # the kernel indexes gt with inp's (d,h,w) strides: a rank or spatial
    # mismatch would read past gt's buffer
    if inp.ndim != 4 or gt.ndim != 4 or inp.shape[:3] != gt.shape[:3]:
        return None
    inp = np.ascontiguousarray(inp)
    gt = np.ascontiguousarray(gt)
    if decisions is None:
        decisions = draw_augment_decisions(rng)
    shift, flip_mask, rot_k = decisions
    d, h, w, ci = inp.shape
    cg = gt.shape[-1]
    od, oh = (h, d) if rot_k % 2 else (d, h)
    out_inp = np.empty((od, oh, w, ci), np.uint16)
    out_gt = np.empty((od, oh, w, cg), np.uint16)
    rc = lib.dose_io_augment_dose_bf16(
        _fptr(inp), _fptr(gt), d, h, w, ci, cg, shift, flip_mask, rot_k,
        out_inp.ctypes.data_as(_P(ctypes.c_uint16)),
        out_gt.ctypes.data_as(_P(ctypes.c_uint16)), n_threads)
    if rc != 0:
        return None
    return _bf16(out_inp), _bf16(out_gt)


def augment_seg_bf16(ct: np.ndarray, labels_u8: np.ndarray,
                     start: Tuple[int, int, int], crop: Sequence[int],
                     decisions: Tuple[float, int, int], *,
                     n_threads: int = 4
                     ) -> Optional[Tuple[torch.Tensor, np.ndarray]]:
    """Fused native seg crop + flips/rot90/intensity-shift + bf16 cast for ONE
    crop of a (D,H,W) CT volume with (D,H,W) uint8 labels. Returns
    (ct crop as torch.bfloat16, uint8 labels crop) or None when the library is
    unavailable or the inputs unfit; callers fall back to the numpy chain with
    the same pre-drawn decisions."""
    lib = get_lib()
    if lib is None or ct.dtype != np.float32 or labels_u8.dtype != np.uint8 or ct.ndim != 3:
        return None
    if ct.shape != labels_u8.shape:
        # the kernel indexes labels with the CT's strides
        return None
    ct = np.ascontiguousarray(ct)
    labels_u8 = np.ascontiguousarray(labels_u8)
    shift, flip_mask, rot_k = decisions
    d, h, w = ct.shape
    z0, y0, x0 = (int(s) for s in start)
    cd, ch, cw = (int(c) for c in crop)
    od, oh = (ch, cd) if rot_k % 2 else (cd, ch)
    out_ct = np.empty((od, oh, cw), np.uint16)
    out_lab = np.empty((od, oh, cw), np.uint8)
    rc = lib.dose_io_augment_seg_bf16(
        _fptr(ct), labels_u8.ctypes.data_as(_P(ctypes.c_uint8)),
        d, h, w, z0, y0, x0, cd, ch, cw, shift, flip_mask, rot_k,
        out_ct.ctypes.data_as(_P(ctypes.c_uint16)),
        out_lab.ctypes.data_as(_P(ctypes.c_uint8)), n_threads)
    if rc != 0:
        return None
    return _bf16(out_ct), out_lab


def preprocess_ct_inplace(buf: np.ndarray, a_min: float = -1024.0,
                          a_max: float = 1500.0, scale: float = 1000.0) -> np.ndarray:
    """Native in-place CT clip+scale; numpy fallback."""
    lib = get_lib()
    if lib is not None and buf.dtype == np.float32 and buf.flags.c_contiguous:
        lib.dose_io_preprocess_ct(_fptr(buf), buf.size, a_min, a_max, 1.0 / scale)
        return buf
    np.clip(buf, a_min, a_max, out=buf)
    buf /= scale
    return buf
