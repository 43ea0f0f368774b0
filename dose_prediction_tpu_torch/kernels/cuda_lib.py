"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ctypes. No PyTorch headers are included, so the build
takes seconds. The library's name carries a hash of
the sources and flags: a second run in the same checkout finds it and skips
the build. It is built into core/bootstrap.py::cache_dir() (``DPT_CACHE_DIR``,
by default ``dose_prediction_tpu_torch/_build``). Nothing is built when this
module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from dose_prediction_tpu_torch.core.bootstrap import cache_dir

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, bh, L, dh, dtype, warps_m, warps_n, scale, stream
    "dpt_attention_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # x, y, partials, counters, scale, bias, planes, channels, S, chunk, eps, act, dtype,
    # vector, single_read, stream
    "dpt_instance_norm_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P),
    # dtype, vector, chunk (out), resident blocks (out)
    "dpt_instance_norm_capacity": (_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)),
    # x, w, bias, y, N, C, D, H, W, dtype, th, tw, td, g (the bf16 tile), vector, stream
    "dpt_conv3d_k3_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
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


def sources() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.cu")) + sorted(SOURCE_DIR.glob("*.cuh"))


def source_hash() -> str:
    """Hash of the kernel sources and the nvcc flags: the library's tag."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Path of the library built from the current sources and flags."""
    return cache_dir() / f"libdpt_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` (one nvcc process each, in parallel) and
    link them unless the library for these sources exists. Raises with
    nvcc's output if a step fails; the compiler's report (registers,
    spills) is kept beside the library."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    units = sorted(SOURCE_DIR.glob("*.cu"))
    objects = [out.parent / f"{tag}.{src.stem}.o" for src in units]
    tmp = out.with_name(f"{tag}.tmp.so")
    try:
        compiles = [[cuda_tool(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(units, objects)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in compiles]
        steps = [(cmd, p.communicate()[0], p.returncode) for cmd, p in zip(compiles, procs)]
        link = [cuda_tool(), *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
        if all(rc == 0 for _, _, rc in steps):
            proc = subprocess.run(link, capture_output=True, text=True)
            steps.append((link, proc.stdout + proc.stderr, proc.returncode))
        out.with_suffix(".log").write_text("".join(log for _, log, _ in steps))
        failed = [(cmd, log, rc) for cmd, log, rc in steps if rc != 0]
        if failed:
            cmd, log, rc = failed[0]
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
    return out


# one build at a time in a process: its threads share the pid that names
# build()'s object and temporary files (concurrent trials, train/tune.py)
_BUILD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    with _BUILD_LOCK:
        path = build()
    lib = ctypes.CDLL(str(path))
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
