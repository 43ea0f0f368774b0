"""``python -m dose_prediction_tpu_torch doctor``: a preflight report of what
a run on the card needs (counterpart of dose_prediction_tpu/cli/doctor.py).

  versions       python, numpy, torch, its CUDA, nvcc, CUTLASS's headers, triton
  backend        the card: name, capability (the kernels are built for 9.0),
                 count, power limit; with ``--probe`` one K1 launch against
                 its plain version in a subprocess, and the round trip's seconds
  native IO      libdose_io.so (the native NIfTI reader) and g++
  kernel build   the kernel library for the current sources, and libraries of
                 other sources in the build directory
  serve capture  whether DPT_NO_AOT turns the captured serve stages off
  train capture  the CLI quick-starts whose train steps are captured as CUDA
                 graphs, and whether DPT_NO_AOT turns that off
  data           with ``--data``, the patient directories a glob matches

The design is the JAX command's: ``collect_report()`` returns a dict that
can be written as JSON and changes nothing (doctor builds nothing and writes
nothing), ``render()`` turns it into ``[ok]``/``[warn]`` lines, and the exit
code is 0 unless ``--strict`` is given and a warning exists. With
``--probe`` every fact about the card comes from a subprocess that is killed
after ``--probe-timeout`` seconds: doctor itself never touches the card.
"""

from __future__ import annotations

import importlib
import json
import os
import platform as _platform
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Tuple

_REPO = Path(__file__).resolve().parents[2]
HOPPER = (9, 0)
# the quick-starts the JAX doctor enumerates (its cli/doctor.py:86-111);
# the port captures their trainers' steps at the first step, whatever feed
TRAIN_QUICKSTARTS = ("train pyfer --feed-dtype float32", "train pyfer --feed-dtype packed",
                     "train transeg")
_SMI = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]

# The probe: the card's facts, then one K1 launch held against K1's plain
# version where the kernel library for these sources is built (the probe
# builds nothing), and its seconds.
_PROBE = r"""
import json, subprocess, sys, time
import torch
rec = {"cuda": torch.cuda.is_available(), "device_count": torch.cuda.device_count()}
if rec["cuda"]:
    rec["device_name"] = torch.cuda.get_device_name(0)
    rec["capability"] = list(torch.cuda.get_device_capability(0))
    try:
        smi = subprocess.run(SMI, capture_output=True, text=True, timeout=60)
        rec["power"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        rec["power"] = None
    from dose_prediction_tpu_torch.kernels import attention as k1, cuda_lib
    if cuda_lib.library_path().is_file():
        g = torch.Generator("cuda").manual_seed(0)
        q, k, v = (torch.randn((1, 2, 64, 64), generator=g, device="cuda").bfloat16()
                   for _ in range(3))
        t0 = time.perf_counter()
        got = k1.fused_attention(q, k, v)
        torch.cuda.synchronize()
        rec["k1_s"] = time.perf_counter() - t0
        want = k1.plain_attention(q, k, v)
        rec["k1_max_abs_err"] = (got.float() - want.float()).abs().max().item()
    else:
        rec["k1_s"] = None
print(json.dumps(rec))
"""


def check_data_pattern(pattern: str, *, max_detail: int = 3) -> dict:
    """How many patient directories a --data glob matches, and which required
    volumes the first few lack. CT.nii.gz is the one a patient cannot do
    without (data/openkbp.py::load_patient raises); dose and mask are needed
    to train and score; PTVs and OARs may be absent, but not all of them."""
    from dose_prediction_tpu_torch.data.openkbp import OAR_NAMES, PTV_NAMES, find_patients

    dirs = find_patients(pattern)
    rec: dict = {"pattern": pattern, "patients": len(dirs), "issues": []}
    for d in dirs[:max_detail]:
        pdir = Path(d)
        missing_hard = [n for n in ("CT", "dose", "possible_dose_mask")
                        if not (pdir / f"{n}.nii.gz").exists()]
        if missing_hard:
            rec["issues"].append(f"{pdir.name}: missing {', '.join(missing_hard)}.nii.gz")
        elif not any((pdir / f"{n}.nii.gz").exists() for n in PTV_NAMES + OAR_NAMES):
            rec["issues"].append(f"{pdir.name}: no PTV or OAR volumes at all (structure "
                                 f"channels would be empty)")
    return rec


def _run(cmd) -> List[str]:
    """A tool's output lines; none when it is missing or fails."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return []
    return out.stdout.strip().splitlines() if out.returncode == 0 else []


def _nvcc() -> Optional[str]:
    from dose_prediction_tpu_torch.kernels.cuda_lib import cuda_tool

    try:
        lines = _run([cuda_tool("nvcc"), "--version"])
    except RuntimeError:
        return None
    return next((ln.strip() for ln in lines if "release" in ln), None)


def _cutlass() -> Optional[str]:
    """The CUTLASS include directory: $CUTLASS_PATH/include, CUDA's own
    include directory, or /usr/local/cutlass/include, the first that holds
    cutlass/cutlass.h."""
    roots = [Path(os.environ["CUTLASS_PATH"]) / "include"] if "CUTLASS_PATH" in os.environ else []
    roots += [Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "include",
              Path("/usr/local/cutlass/include")]
    return next((str(r) for r in roots if (r / "cutlass" / "cutlass.h").is_file()), None)


def _versions() -> dict:
    import importlib.metadata as im

    out = {"python": _platform.python_version()}
    for dist in ("numpy", "torch"):
        try:
            out[dist] = im.version(dist)
        except im.PackageNotFoundError:
            out[dist] = "missing"
    import torch

    out["torch_cuda"] = torch.version.cuda or "none (a CPU build)"
    out["nvcc"] = _nvcc() or "missing"
    out["cutlass"] = _cutlass() or "missing"
    try:
        out["triton"] = importlib.import_module("triton").__version__
    except Exception:
        out["triton"] = "missing"
    return out


def _subprocess_probe(timeout_s: float) -> dict:
    """The probe in a subprocess with a deadline: a card that hangs blocks
    a C call, which only a process boundary can interrupt."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(_REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    code = f"SMI = {_SMI!r}\n{_PROBE}"
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True,
                             timeout=timeout_s, env=env)
    except subprocess.TimeoutExpired:
        return {"probe_error": f"card unresponsive: the probe did not finish in "
                               f"{timeout_s:.0f} s (--probe-timeout raises the budget)"}
    except subprocess.CalledProcessError as e:
        return {"probe_error": "the probe subprocess failed (not a hang): "
                               + e.stderr.decode(errors="replace")[-300:]}
    rec = json.loads(out.stdout.decode().strip().splitlines()[-1])
    rec["probe_s"] = round(time.perf_counter() - t0, 3)
    return rec


def _backend(probe: bool, *, probe_timeout: float = 600.0) -> dict:
    if probe:
        rec = _subprocess_probe(probe_timeout)
        if "probe_error" in rec:
            rec.update(cuda=False, device_count=0)
        return rec
    import torch

    rec: dict = {"cuda": torch.cuda.is_available(), "device_count": torch.cuda.device_count()}
    if rec["cuda"]:
        rec["device_name"] = torch.cuda.get_device_name(0)
        rec["capability"] = list(torch.cuda.get_device_capability(0))
        rec["power"] = next(iter(_run(_SMI)), None)
    return rec


def _native_io() -> dict:
    from dose_prediction_tpu_torch.data import native as N

    lib = N.library_path()
    return {"built": lib.is_file(), "lib": str(lib),
            "toolchain_gxx": shutil.which("g++") is not None}


def _kernel_build() -> dict:
    from dose_prediction_tpu_torch.kernels import cuda_lib

    lib = cuda_lib.library_path()
    others = sorted(p.name for p in lib.parent.glob("libdpt_kernels_*.so") if p != lib)
    return {"dir": str(lib.parent), "lib": lib.name, "built": lib.is_file(),
            "sources": len(cuda_lib.sources()), "other_sources": others}


def collect_report(*, data: Optional[str] = None, probe: bool = False,
                   probe_timeout: float = 600.0) -> dict:
    """The whole report, changing nothing. With ``probe`` the card's facts
    come from the subprocess probe only."""
    from dose_prediction_tpu_torch.infer import aot as A

    backend = _backend(probe, probe_timeout=probe_timeout)
    report = {
        "versions": _versions(),
        "backend": backend,
        "native_io": _native_io(),
        "kernel_build": _kernel_build(),
        "runtime": A.build_info(backend.get("device_name", "none"), backend.get("capability")),
        "serve_capture": {"disabled": A.disabled()},
        "train_capture": {"ported": True, "disabled": A.disabled(),
                          "quickstarts": list(TRAIN_QUICKSTARTS)},
    }
    if data:
        report["data"] = check_data_pattern(data)
    return report


def render(report: dict) -> Tuple[List[str], int]:
    """(lines, warnings). Each condition that needs the user is a [warn]
    line with its remedy; [note] lines count as no warning."""
    lines: List[str] = []
    warns = 0

    def ok(msg: str) -> None:
        lines.append(f"[ok]   {msg}")

    def warn(msg: str) -> None:
        nonlocal warns
        warns += 1
        lines.append(f"[warn] {msg}")

    v = report["versions"]
    missing = [k for k, val in v.items() if val == "missing"]
    (warn if missing else ok)(
        "versions: " + ", ".join(f"{k} {val}" for k, val in v.items())
        + (f"; MISSING: {', '.join(missing)} (nvcc builds the kernels)" if missing else ""))

    b = report["backend"]
    probe = (f", probe {b['probe_s']} s" if "probe_s" in b else "")
    if "probe_error" in b:
        warn(f"backend: probe FAILED: {b['probe_error']}")
    elif not b["cuda"]:
        warn("backend: no CUDA card (torch.cuda.is_available() is False); every entry point "
             "but --device cpu will refuse to run")
    else:
        cap = tuple(b["capability"])
        msg = (f"backend: {b['device_count']} x {b['device_name']}, capability "
               f"{cap[0]}.{cap[1]}, {b.get('power') or 'power limit unknown'}{probe}")
        if cap != HOPPER:
            warn(f"{msg}: the kernels are built for sm_90a and need capability 9.0")
        else:
            ok(msg)
        if "k1_s" in b:
            if b["k1_s"] is None:
                warn("backend: the probe launched no K1, the kernel library for these sources "
                     "is not built (the first CUDA run builds it)")
            else:
                ok(f"backend: K1 launched in {b['k1_s']:.3f} s, {b['k1_max_abs_err']:.3g} "
                   f"from its plain version")

    n = report["native_io"]
    if n["built"]:
        ok(f"native IO: {n['lib']}")
    else:
        warn(f"native IO: {n['lib']} not built yet (g++ "
             f"{'present' if n['toolchain_gxx'] else 'MISSING'}); the first read builds it, "
             "and without g++ the feeds read through numpy (slower, same results)")

    k = report["kernel_build"]
    others = (f"; {len(k['other_sources'])} libraries of other sources there, unused"
              if k["other_sources"] else "")
    if k["built"]:
        ok(f"kernel build: {k['lib']} in {k['dir']} from {k['sources']} sources{others}")
    else:
        warn(f"kernel build: {k['lib']} not in {k['dir']}; the first CUDA run builds it from "
             f"{k['sources']} sources (nvcc, seconds){others}")

    if report["serve_capture"]["disabled"]:
        warn("serve capture: DPT_NO_AOT=1, aot runs the eager stages (every launch "
             "from the host)")
    else:
        ok("serve capture: on; each serve stage is captured as a CUDA graph at its first "
           "request (nothing is shipped)")
    train = report["train_capture"]
    if train["disabled"]:
        warn("train capture: DPT_NO_AOT=1, the DOSE-PYFER and TranSeg trainers launch every "
             "kernel of a step from the host")
    else:
        ok(f"train capture: on; the step of {', '.join(train['quickstarts'])} is captured as "
           "a CUDA graph at the first step (nothing is shipped)")

    if "data" in report:
        d = report["data"]
        if d["patients"] == 0:
            warn(f"data: pattern {d['pattern']!r} matches NO patient dirs "
                 f"(want e.g. '/data/train-pats/pt_*')")
        elif d["issues"]:
            warn(f"data: {d['patients']} patients; issues in the first checked: "
                 + " | ".join(d["issues"]))
        else:
            ok(f"data: {d['patients']} patient dirs, first {min(3, d['patients'])} have "
               f"CT/dose/mask + structures")

    lines.append(f"doctor: {warns} warning(s)")
    return lines, warns


def run(args) -> int:
    report = collect_report(data=getattr(args, "data", None),
                            probe=getattr(args, "probe", False),
                            probe_timeout=getattr(args, "probe_timeout", 600.0))
    lines, warns = render(report)
    if getattr(args, "json", False):
        print(json.dumps(report, indent=2, default=str))
    else:
        print("\n".join(lines))
    return 1 if (warns and getattr(args, "strict", False)) else 0
