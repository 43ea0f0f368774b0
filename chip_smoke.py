#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dose_prediction_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its seconds on a line of its own:

1. device   require CUDA (no fallback) and print the card's name and power
            limit as nvidia-smi reports them;
2. build    build the CUDA kernels (one nvcc call over csrc/*.cu);
3. kernels  hold K1 (attention) and K2 (instance norm) against their plain
            PyTorch versions at the main path's shapes, in float32 and
            bfloat16, and time kernel, plain version and one PyTorch library
            call computing the same function (a yardstick the port never
            calls), beside the least time the card could take;
4. parity   the full-width 128³ serve cascade (12-layer ViT-768 TranSeg over
            96³ windows, then DOSE-PYFER) in float32 with TF32 off, once
            through the kernels and once with the plain versions swapped in;
5. serve    three bfloat16 requests after one warm-up through the same
            entry points, with the kernels' launch counts read around them;
6. profile  one more bfloat16 request under torch.profiler: device time by
            kernel group and the device's idle share;

then a ``kernels`` JSON line, the card's name and power limit, and the
last line ``{"ok": true, "device": {...}}``. Weights and volumes are made
from seeds on the card. Any failed phase exits non-zero without a result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from unittest import mock

import torch

# H100 SXM data-sheet peaks (dense): HBM bytes/s; bfloat16 tensor-core and
# float32 (non-tensor) operations/s. The kernels run float32 arithmetic.
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SEED = 0
DOSE_TOL_OF_SCALE = 1e-3     # f32 cascade: |dose_kernels - dose_plain| ≤ 1e-3 × 70 Gy
LABEL_AGREEMENT_MIN = 0.999

K1_SHAPES = [(8, 12, 216, 64), (1, 6, 512, 128)]          # TranSeg windows, DOSE-PYFER
K2_SHAPES = [(1, 16, 128, 128, 128), (8, 16, 96, 96, 96)]  # C3D level 1, TranSeg decoder2
ACTS = ["identity", "relu", "leakyrelu", "mish", "gelu"]


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def tolerance(ref: torch.Tensor) -> float:
    """float32: 1e-4 absolute (summation order only). bfloat16: two bf16
    ulps at the largest output magnitude (both sides round float32 values
    that differ in the last float32 bits, and the plain attention rounds
    its probabilities to bf16 as the JAX reference does)."""
    if ref.dtype == torch.float32:
        return 1e-4
    return 2.0 ** -6 * max(ref.float().abs().max().item(), 1.0)


def time_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls after a warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, dtype: torch.dtype):
    """Least time (ms) for the work and which of bytes or operations sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def plain_kernels(k1, k2):
    """Swap the plain versions in where the model calls the kernels."""
    with mock.patch.object(k1, "fused_attention", k1.plain_attention), \
            mock.patch.object(k2, "instance_norm_act", k2.plain_instance_norm_act):
        yield


def check_kernel(name, kernel, plain, library, args, dtype, nbytes, ops, iters):
    out = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    err = (out.float() - ref.float()).abs().max().item()
    tol = tolerance(ref)
    ok = bool(torch.isfinite(out).all()) and err <= tol
    del out, ref
    row = {"max_abs_err": err, "tol": tol,
           "ms": time_ms(lambda: kernel(*args), iters),
           "plain_ms": time_ms(lambda: plain(*args), max(2, iters // 4)),
           "library_ms": time_ms(lambda: library(*args), iters)}
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, dtype)
    log(f"{name} {str(dtype).replace('torch.', '')}: max_abs_err {err:.3g} (tol {tol:.3g}) "
        f"{'ok' if ok else 'FAIL'}; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    if not ok:
        raise AssertionError(f"{name}: max abs err {err} > {tol} or non-finite output")
    return row


def phase_kernels(dev):
    import torch.nn.functional as F

    from dose_prediction_tpu_torch.kernels import attention as k1
    from dose_prediction_tpu_torch.kernels import instance_norm as k2

    g = torch.Generator(dev).manual_seed(SEED)
    rows = {}
    for shape in K1_SHAPES:
        n, h, l, dh = shape
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(3))
            rows[("attention", shape, dtype)] = check_kernel(
                f"K1 attention {shape}", k1.fused_attention, k1.plain_attention,
                F.scaled_dot_product_attention, (q, k, v), dtype,
                nbytes=4 * q.numel() * q.element_size(), ops=4 * n * h * l * l * dh, iters=20)
    for shape in K2_SHAPES:
        c = shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, generator=g, device=dev) * 2 + 1).to(dtype)
            scale = torch.rand(c, generator=g, device=dev) + 0.5
            bias = torch.randn(c, generator=g, device=dev)
            rows[("instance_norm", shape, dtype)] = check_kernel(
                f"K2 instance_norm {shape}", k2.instance_norm_act, k2.plain_instance_norm_act,
                lambda x, s, b: F.instance_norm(x, weight=s, bias=b, eps=1e-5),
                (x, scale, bias), dtype, nbytes=2 * x.numel() * x.element_size(),
                ops=8 * x.numel(), iters=10)
            del x
    for dtype in (torch.float32, torch.bfloat16):        # every activation K2 fuses
        x = (torch.randn((2, 16, 24, 20, 36), generator=g, device=dev) * 2 + 1).to(dtype)
        for act in ACTS:
            out = k2.instance_norm_act(x, act=act)
            ref = k2.plain_instance_norm_act(x, act=act)
            err = (out.float() - ref.float()).abs().max().item()
            if err > tolerance(ref):
                raise AssertionError(f"K2 act={act} {dtype}: err {err} > {tolerance(ref)}")
        log(f"K2 activations {ACTS} {str(dtype).replace('torch.', '')}: within tolerance")
    return rows


def seeded_models(dev):
    """Full-width TranSeg and DOSE-PYFER, weights drawn on the card from seeds,
    norm affines and BatchNorm statistics off 1/0 so those paths count."""
    from dose_prediction_tpu_torch.models import DosePyfer, TranSeg
    from dose_prediction_tpu_torch.nn.init import init_params

    g = torch.Generator(dev).manual_seed(SEED + 1)
    seg = init_params(TranSeg(out_ch=8, device=dev), g)
    dose = init_params(DosePyfer(device=dev), g)
    with torch.no_grad():
        for m in list(seg.modules()) + list(dose.modules()):
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.uniform_(-0.2, 0.2, generator=g)
                m.running_var.uniform_(0.8, 1.3, generator=g)
            if isinstance(m, (torch.nn.InstanceNorm3d, torch.nn.BatchNorm3d,
                              torch.nn.LayerNorm)) and m.weight is not None:
                m.weight.uniform_(0.7, 1.3, generator=g)
                m.bias.uniform_(-0.2, 0.2, generator=g)
    return seg, dose


def seeded_volumes(dev, dtype):
    """A 128³ CT, PTV and possible-dose mask, NDHWC, drawn on the card."""
    g = torch.Generator(dev).manual_seed(SEED + 2)
    shape = (1, 128, 128, 128, 1)
    ct = torch.randn(shape, generator=g, device=dev)
    ptv = (torch.rand(shape, generator=g, device=dev) < 0.05).float()
    mask = (torch.rand(shape, generator=g, device=dev) < 0.6).float()
    return ct.to(dtype), ptv.to(dtype), mask.to(dtype)


def phase_parity(dev, seg, dose, stage1, stage2, k1, k2):
    ct, ptv, mask = seeded_volumes(dev, torch.float32)
    seg_vars, dose_vars = seg.state_dict(), dose.state_dict()
    k1.fused_attention.launches = k2.instance_norm_act.launches = 0
    struct_k = stage1(seg_vars, ct, ptv)
    dose_k = stage2(dose_vars, struct_k, mask)
    torch.cuda.synchronize()
    launches = (k1.fused_attention.launches, k2.instance_norm_act.launches)
    with plain_kernels(k1, k2):
        struct_p = stage1(seg_vars, ct, ptv)
        dose_p = stage2(dose_vars, struct_k, mask)      # the same structures as dose_k
    torch.cuda.synchronize()
    agree = torch.all(struct_k[..., 1:8] == struct_p[..., 1:8], dim=-1).float().mean().item()
    diff = (dose_k - dose_p).abs().max().item()
    tol = DOSE_TOL_OF_SCALE * 70.0
    oars = struct_k[..., 1:8]
    labels = torch.unique(torch.where(oars.amax(-1) > 0, oars.argmax(-1) + 1, 0))
    log(f"cascade f32 (TF32 off): dose max abs diff kernels vs plain {diff:.4g} Gy "
        f"(tol {tol:.3g} Gy), dose max {dose_k.max().item():.4g} Gy; seg labels agree "
        f"{agree * 100:.4f}% (min {LABEL_AGREEMENT_MIN * 100:.1f}%), {labels.numel()} labels "
        f"present; launches K1 {launches[0]} K2 {launches[1]}")
    if not (diff <= tol and agree >= LABEL_AGREEMENT_MIN and min(launches) > 0
            and bool(torch.isfinite(dose_k).all())):
        raise AssertionError("f32 cascade parity failed")
    return {"dose_max_abs_diff_gy": diff, "label_agreement": agree,
            "launches": dict(zip(("attention", "instance_norm"), launches))}


def phase_serve(dev, seg, dose, stage1, stage2, k1, k2):
    ct, ptv, mask = seeded_volumes(dev, torch.bfloat16)
    seg_vars, dose_vars = seg.state_dict(), dose.state_dict()

    def request():
        out = stage2(dose_vars, stage1(seg_vars, ct, ptv), mask)
        torch.cuda.synchronize()
        return out

    request()                                           # warm-up
    k1.fused_attention.launches = k2.instance_norm_act.launches = 0
    times, out = [], None
    for _ in range(3):
        t0 = time.perf_counter()
        out = request()
        times.append(time.perf_counter() - t0)
    launches = {"attention": k1.fused_attention.launches,
                "instance_norm": k2.instance_norm_act.launches}
    ok = (out.shape == (1, 128, 128, 128, 1) and bool(torch.isfinite(out).all())
          and bool((out[mask < 1] == 0).all()) and bool((out >= 0).all()))
    p50 = sorted(times)[1]
    log(f"serve bf16: request seconds {times}, p50 {p50} s; output shape {tuple(out.shape)}, "
        f"finite, 0 outside the mask, >= 0: {ok}; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    if not ok or min(launches.values()) == 0:
        raise AssertionError(f"serve check failed (launches {launches})")
    return {"p50_s": p50, "times_s": times, "launches": launches}


# kernel-name fragments by group, first match wins (cuDNN's convolutions are
# implicit GEMMs, so they are matched before the matmul fragments)
KERNEL_GROUPS = (("K1 attention", ("attention_fwd_kernel",)),
                 ("K2 instance norm", ("stats_kernel", "apply_kernel")),
                 ("cuDNN layout transform", ("nchwtonhwc", "nhwctonchw")),
                 ("convolution", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "implicit")),
                 ("matmul", ("gemm", "nvjet", "cublas", "cutlass")))


def phase_profile(dev, seg, dose, stage1, stage2):
    """One more bf16 request under torch.profiler: device time by kernel
    group and the device's idle share of the request's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ct, ptv, mask = seeded_volumes(dev, torch.bfloat16)
    seg_vars, dose_vars = seg.state_dict(), dose.state_dict()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stage2(dose_vars, stage1(seg_vars, ct, ptv), mask)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if getattr(evt, "device_type", None) == DeviceType.CUDA and us > 0:
            kernels.append((us, evt.count, evt.key))
    busy_us = sum(us for us, _, _ in kernels)
    if busy_us <= 0:
        log("profile: the profiler reported no device time; not measured")
        return None
    groups = {}
    for us, count, name in kernels:
        low = name.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")
        tot = groups.setdefault(group, [0.0, 0])
        tot[0] += us
        tot[1] += count
    log(f"profile bf16 request: wall {wall_us / 1e3:.2f} ms under the profiler, device busy "
        f"{busy_us / 1e3:.2f} ms, idle share {1 - busy_us / wall_us:.3f}")
    for group, (us, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"profile group {group}: {us / 1e3:.3f} ms in {count} launches "
            f"({us / busy_us * 100:.1f}% of device time)")
    for us, count, name in sorted(kernels, reverse=True)[:12]:
        log(f"profile kernel {us / 1e3:.3f} ms x{count}: {name[:110]}")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
            "groups_ms": {g: v[0] / 1e3 for g, v in groups.items()}}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from dose_prediction_tpu_torch.infer.cascade import make_cascade_stages
        from dose_prediction_tpu_torch.kernels import attention as k1
        from dose_prediction_tpu_torch.kernels import cuda_lib
        from dose_prediction_tpu_torch.kernels import instance_norm as k2
    except ImportError as e:
        log(f"cannot import the port (run from a checkout of the repository): {e}")
        return 1
    # float32 parity runs with TF32 off for both cuDNN convolutions and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    results = {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            results[name] = fn()
        except Exception:
            traceback.print_exc()
            log(f"phase {name}: FAILED after {time.perf_counter() - t0:.1f} s")
            raise
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s "
            f"(total {time.perf_counter() - t_start:.1f} s)")

    try:
        run("device", lambda: {"smi": nvidia_smi(), "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()})
        print(results["device"]["smi"], flush=True)
        run("build", lambda: (cuda_lib.library(), str(cuda_lib.build()))[1])
        run("kernels", lambda: phase_kernels(dev))
        models = {}
        run("models", lambda: models.update(zip(("seg", "dose"), seeded_models(dev))))
        stage1, stage2 = make_cascade_stages(models["seg"], models["dose"],
                                             roi_size=(96, 96, 96), sw_batch_size=8,
                                             overlap=0.25, dose_scale=70.0)
        args = (dev, models["seg"], models["dose"], stage1, stage2, k1, k2)
        run("parity", lambda: phase_parity(*args))
        run("serve", lambda: phase_serve(*args))
        run("profile", lambda: phase_profile(*args[:5]))
    except Exception:
        return 1

    smi = results["device"]["smi"]
    log(f"serve p50 {results['serve']['p50_s']} s on {smi}")
    kernels = []
    for name, source, replaces, shape in (
            ("attention", "dose_prediction_tpu_torch/csrc/attention.cu",
             "dose_prediction_tpu/kernels/attention.py:26", K1_SHAPES[0]),
            ("instance_norm", "dose_prediction_tpu_torch/csrc/instance_norm.cu",
             "dose_prediction_tpu/kernels/instance_norm.py:32", K2_SHAPES[1])):
        row = results["kernels"][(name, shape, torch.bfloat16)]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": results["serve"]["launches"][name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "shape": list(shape), "dtype": "bfloat16"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": results["device"]["kind"],
                                             "count": results["device"]["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
