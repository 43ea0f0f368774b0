"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` files are compiled by ONE ``nvcc`` call into a shared
library with a plain C interface, loaded with ctypes. No PyTorch headers are
included, so the build takes seconds. The library's name carries a hash of
the sources and flags: a second run in the same checkout finds it and skips
the build. Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, bh, L, dh, dtype, warps_m, warps_n, scale, stream
    "dpt_attention_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # x, y, partials, scale, bias, planes, channels, S, chunk, eps, act, dtype, stream
    "dpt_instance_norm_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
    # x, w, bias, y, N, C, D, H, W, dtype, stream
    "dpt_conv3d_k3_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump, ...)."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / name).is_file():
            return str(Path(cand) / "bin" / name)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found (set CUDA_HOME or put it on PATH)")
    return found


def _sources() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.cu")) + sorted(SOURCE_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Path of the library built from the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdpt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` with one nvcc call unless the library for
    these sources exists. Raises with nvcc's output if the build fails; the
    compiler's report (registers, spills) is kept beside the library."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [cuda_tool(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sorted(SOURCE_DIR.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current stream on ``t``'s device, for a launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t: torch.Tensor, name: str) -> None:
    """Kernels take CUDA tensors only; other devices raise."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got {t.device}")
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        f"(want one of {sorted(map(str, DTYPE_CODES))})")
