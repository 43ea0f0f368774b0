"""Process-level start-up shared by every entry point (counterpart of
dose_prediction_tpu/core/bootstrap.py).

The JAX package configures XLA's persistent compilation cache here, so that
a restarted process does not compile its programs again. The port compiles
one thing ahead of a run, the CUDA kernel library (kernels/cuda_lib.py), and
its counterpart of that cache is the library's build directory: a library
built from the same sources and flags is found there and loaded, not built
again. Nothing is shipped, so there is nothing to seed. The CLI calls
``configure_compile_cache`` before dispatch for every subcommand on
``--device cuda`` except ``score``, ``doctor`` and ``openkbp-prepare``.

Environment knob: ``DPT_CACHE_DIR``, the build directory (default
``dose_prediction_tpu_torch/_build``).
"""

from __future__ import annotations

import os
import time
from pathlib import Path

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[1] / "_build"


def cache_dir() -> Path:
    return Path(os.environ.get("DPT_CACHE_DIR", DEFAULT_CACHE_DIR))


def configure_compile_cache() -> dict:
    """Build the kernel library from the sources in the repository, or find
    the one built from them. Returns ``{"sources": n, "built": bool,
    "reused": bool, "seconds": s}``."""
    from dose_prediction_tpu_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    reused = cuda_lib.library_path().is_file()
    cuda_lib.library()
    return {"sources": len(cuda_lib.sources()), "built": not reused, "reused": reused,
            "seconds": time.perf_counter() - t0}
