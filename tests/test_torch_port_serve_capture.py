"""The port's captured serve path and its start-up, on the CPU: what can be
held without a card.

StreamingCascade (infer/pipeline.py) against the JAX package's on three
seeded 48³ patients, sliding (32³ windows, sw batch 4) and dense (the seg
model's 2³ token grid resized to the volume's 3³), with the small models
of tests/test_pipeline_serve.py (two ViT layers of 24, feature size 2)
holding the same seeded weights: each dose map within 1e-3 of the 70 Gy
scale of the JAX one (the bar of tests/test_torch_port_serve.py), run_one
equal to run_stream bit for bit.

The doctor (cli/doctor.py): check_data_pattern equal to the JAX one on the
same directory trees; collect_report and render with no card (a [warn],
exit 1 under --strict); the subprocess probe's success, hang and failure
paths; ``python -m dose_prediction_tpu_torch doctor --json`` end to end,
writing nothing. core/bootstrap.py: configure_compile_cache builds into
DPT_CACHE_DIR (by default the package's _build), with the build itself
mocked (no nvcc here), and doctor reports that directory; the CLI calls
it before dispatch on
``--device cuda`` only. infer/aot.py: the capture key moves with every
input shape and dtype, each routing flag and a swapped variable; every
captured entry point refuses CPU tensors. The captures themselves are held
on the card (tests/test_torch_port_cuda.py, chip_smoke.py's captured phase).
"""

import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu import models as jmodels  # noqa: E402
from dose_prediction_tpu.cli import doctor as JD  # noqa: E402
from dose_prediction_tpu.core import torch_import as TI  # noqa: E402
from dose_prediction_tpu.infer.pipeline import StreamingCascade as JStreamingCascade  # noqa: E402

from dose_prediction_tpu_torch.cli import doctor as D  # noqa: E402
from dose_prediction_tpu_torch.cli import main as CLI  # noqa: E402
from dose_prediction_tpu_torch.core import bootstrap as B  # noqa: E402
from dose_prediction_tpu_torch.core.config import FLAGS  # noqa: E402
from dose_prediction_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from dose_prediction_tpu_torch.infer import aot as A  # noqa: E402
from dose_prediction_tpu_torch.infer.cascade import make_cascade_fn  # noqa: E402
from dose_prediction_tpu_torch.infer.pipeline import StreamingCascade  # noqa: E402
from dose_prediction_tpu_torch.kernels import cuda_lib  # noqa: E402
from dose_prediction_tpu_torch.models import DosePyfer, TranSeg  # noqa: E402

import test_torch_port_models as M  # noqa: E402  (seeded weights, JAX import)

REPO = Path(__file__).resolve().parent.parent
ROI, VOL, SW, SCALE, TOL = 32, 48, 4, 70.0, 1e-3
VIT = dict(feature_size=2, hidden_size=24, mlp_dim=48, num_layers=2, num_heads=2)
LIST_CH = (-1, 2, 4, 8, 16, 32)


def patients(size, n=3):
    rng = np.random.default_rng(0)
    shape = (1, size, size, size, 1)
    return [(rng.standard_normal(shape).astype(np.float32),
             (rng.random(shape) > 0.7).astype(np.float32),
             (rng.random(shape) > 0.3).astype(np.float32)) for _ in range(n)]


def model_pair(seg_mode, size):
    """The port's seeded small TranSeg and DOSE-PYFER and the JAX package's
    models and variables holding the same weights."""
    grid = (ROI // 16,) * 3 if seg_mode == "dense" else None
    seg = M.seeded(TranSeg(out_ch=8, img_size=ROI, trained_grid=grid, device="cpu", **VIT), 0)
    dose = M.seeded(DosePyfer(list_ch_A=LIST_CH, img_size=size, device="cpu", **VIT), 1)
    jseg = jmodels.TranSeg(out_ch=8, trained_grid=grid, **VIT)
    jdose = jmodels.DosePyfer(out_ch=1, list_ch_A=LIST_CH, **VIT)
    seg_vars, _ = M.to_jax(seg, jseg, TI.import_transeg, (1, ROI, ROI, ROI, 1))
    dose_vars, _ = M.to_jax(dose, jdose, TI.import_pyfer, (1, size, size, size, 9))
    return seg, dose, jseg, jdose, seg_vars, dose_vars


@pytest.mark.parametrize("seg_mode", ["sliding", "dense"])
def test_streaming_cascade_matches_jax(seg_mode):
    size = VOL
    seg, dose, jseg, jdose, seg_vars, dose_vars = model_pair(seg_mode, size)
    vols = patients(size)
    devs = jax.devices()
    want = [np.asarray(d) for d in JStreamingCascade(
        jseg, seg_vars, jdose, dose_vars, seg_device=devs[0], dose_device=devs[1],
        roi_size=(ROI,) * 3, sw_batch_size=SW, seg_mode=seg_mode).run_stream(vols)]
    pipe = StreamingCascade(seg, seg.state_dict(), dose, dose.state_dict(), seg_device="cpu",
                            dose_device="cpu", roi_size=(ROI,) * 3, sw_batch_size=SW,
                            seg_mode=seg_mode)
    got = list(pipe.run_stream([tuple(map(torch.from_numpy, v)) for v in vols]))
    assert len(got) == len(want) == 3
    for (_, _, mask), g, w in zip(vols, got, want):
        assert g.shape == w.shape == (1, size, size, size, 1) and g.dtype == torch.float32
        assert np.count_nonzero(w) > 0 and bool((g[torch.from_numpy(mask) < 1] == 0).all())
        assert np.abs(g.numpy() - w).max() / SCALE <= TOL
    assert torch.equal(pipe.run_one(*map(torch.from_numpy, vols[0])), got[0])


def test_streaming_cascade_defaults_to_the_card():
    """seg_device and dose_device default to the cards, and a missing card
    raises (no CPU fall-back)."""
    seg = TranSeg(out_ch=8, img_size=ROI, device="meta", **VIT)
    dose = DosePyfer(list_ch_A=LIST_CH, img_size=ROI, device="meta", **VIT)
    with mock.patch.object(torch.cuda, "is_available", lambda: False), \
            pytest.raises(RuntimeError, match="cuda:0"):
        StreamingCascade(seg, {}, dose, {})


def test_check_data_pattern_matches_jax(tmp_path):
    good = make_synthetic_dataset(tmp_path / "data", n_patients=2)
    (tmp_path / "bad" / "pt_9").mkdir(parents=True)
    bare = tmp_path / "bare" / "pt_1"
    bare.mkdir(parents=True)
    for name in ("CT", "dose", "possible_dose_mask"):
        (bare / f"{name}.nii.gz").write_bytes(b"")
    patterns = [good, str(tmp_path / "bad" / "pt_*"), str(tmp_path / "bare" / "pt_*"),
                str(tmp_path / "nothing*")]
    for pattern in patterns:
        assert D.check_data_pattern(pattern) == JD.check_data_pattern(pattern), pattern
    assert D.check_data_pattern(patterns[0]) == {"pattern": good, "patients": 2, "issues": []}
    assert "pt_9: missing CT" in D.check_data_pattern(patterns[1])["issues"][0]
    assert "no PTV or OAR" in D.check_data_pattern(patterns[2])["issues"][0]


CARD = {"cuda": True, "device_count": 1, "device_name": "NVIDIA H100 80GB HBM3",
        "capability": [9, 0], "power": "NVIDIA H100 80GB HBM3, 700.00 W"}


def _report(backend, **overrides):
    report = {"versions": {"python": "3.12", "torch": "2", "nvcc": "release 12",
                           "cutlass": "x", "triton": "3"},
              "backend": backend,
              "native_io": {"built": True, "lib": "libdose_io.so", "toolchain_gxx": True},
              "kernel_build": {"dir": "d", "lib": "libdpt_kernels_0.so", "built": True,
                               "sources": 4, "other_sources": [], "fresh_dir_per_run": False},
              "serve_capture": {"disabled": False},
              "train_capture": {"ported": True, "disabled": False,
                                "quickstarts": list(D.TRAIN_QUICKSTARTS)}}
    report.update(overrides)
    return report


def test_render_warns_for_each_missing_precondition():
    lines, warns = D.render(_report({**CARD, "k1_s": 0.01, "k1_max_abs_err": 0.0}))
    assert warns == 0 and lines[-1] == "doctor: 0 warning(s)"
    assert any(ln.startswith("[ok]   backend: 1 x NVIDIA H100") and "9.0" in ln for ln in lines)
    assert any(ln.startswith("[ok]   train capture: on; the step of train pyfer") for ln in lines)
    cases = [
        _report({"cuda": False, "device_count": 0}),
        _report({**CARD, "capability": [8, 0]}),
        _report({**CARD, "k1_s": None}),
        _report(CARD, versions={"python": "3.12", "nvcc": "missing"}),
        _report(CARD, native_io={"built": False, "lib": "x", "toolchain_gxx": False}),
        _report(CARD, kernel_build={"dir": "d", "lib": "l", "built": False, "sources": 4,
                                    "other_sources": ["old.so"], "fresh_dir_per_run": True}),
        _report(CARD, serve_capture={"disabled": True}),
        _report(CARD, train_capture={"ported": True, "disabled": True,
                                     "quickstarts": list(D.TRAIN_QUICKSTARTS)}),
        _report(CARD, data={"pattern": "p*", "patients": 0, "issues": []}),
        _report({"probe_error": "card unresponsive", "cuda": False, "device_count": 0}),
    ]
    for report in cases:
        lines, warns = D.render(report)
        assert warns == 1 and sum(ln.startswith("[warn]") for ln in lines) == 1, lines


def test_collect_report_without_a_card(tmp_path, monkeypatch):
    """No card here: the report says so as a warning and --strict exits 1;
    the report writes nothing, not even the build directory it reports on."""
    monkeypatch.setenv("DPT_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("DPT_NO_AOT", raising=False)
    report = D.collect_report(data=str(tmp_path / "none*"))
    assert report["backend"] == {"cuda": False, "device_count": 0}
    assert report["kernel_build"]["dir"] == str(tmp_path / "cache")
    assert report["kernel_build"]["built"] is False
    assert report["runtime"]["kernel_sources"] == cuda_lib.source_hash()
    assert report["versions"]["torch"] == torch.__version__
    lines, warns = D.render(report)
    assert any("no CUDA card" in ln and ln.startswith("[warn]") for ln in lines)
    json.dumps(report)
    assert not (tmp_path / "cache").exists()
    args = CLI.build_parser().parse_args(["doctor", "--strict"])
    assert D.run(args) == 1 and D.run(CLI.build_parser().parse_args(["doctor"])) == 0


def test_subprocess_probe_paths(monkeypatch):
    """The probe's success path on a machine with no card, then a probe that
    outlives its budget ('unresponsive') and one whose process fails."""
    rec = D._subprocess_probe(timeout_s=300.0)
    assert rec["cuda"] is False and rec["device_count"] == 0 and rec["probe_s"] > 0
    rec = D._subprocess_probe(timeout_s=0.05)
    assert "unresponsive" in rec["probe_error"]
    b = D._backend(True, probe_timeout=0.05)
    assert b["cuda"] is False and b["device_count"] == 0
    lines, warns = D.render(_report(b))
    assert any("probe FAILED" in ln for ln in lines) and warns == 1
    monkeypatch.setattr(D.sys, "executable", "/bin/false")
    assert "not a hang" in D._subprocess_probe(timeout_s=60.0)["probe_error"]


def test_cli_doctor_json_end_to_end(tmp_path):
    env = dict(os.environ, DPT_CACHE_DIR=str(tmp_path / "cache"))
    out = subprocess.run([sys.executable, "-m", "dose_prediction_tpu_torch", "doctor", "--json"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    report = json.loads(out.stdout)
    assert report["backend"]["cuda"] is False and report["train_capture"]["ported"] is True
    assert set(report) >= {"versions", "native_io", "kernel_build", "serve_capture", "runtime"}
    assert not (tmp_path / "cache").exists()


@pytest.fixture
def mocked_build(monkeypatch):
    """cuda_lib.library (build and load) mocked."""
    library = mock.MagicMock()
    monkeypatch.setattr(cuda_lib, "library", library)
    return library


def test_configure_compile_cache_builds_into_the_cache_dir(tmp_path, monkeypatch, mocked_build):
    monkeypatch.setenv("DPT_CACHE_DIR", str(tmp_path / "live"))
    stats = B.configure_compile_cache()
    assert mocked_build.call_count == 1
    assert cuda_lib.library_path().parent == tmp_path / "live"
    assert {k: stats[k] for k in ("sources", "built", "reused")} == {
        "sources": len(cuda_lib.sources()), "built": True, "reused": False}
    cuda_lib.library_path().parent.mkdir(parents=True)
    cuda_lib.library_path().write_bytes(b"")
    stats = B.configure_compile_cache()
    assert (stats["built"], stats["reused"]) == (False, True) and stats["seconds"] >= 0


def test_cache_dir_defaults_to_the_package_build_dir(tmp_path, monkeypatch, mocked_build):
    """Without DPT_CACHE_DIR the library goes to dose_prediction_tpu_torch/_build
    (git-ignored); doctor reports whichever directory is in force, with the
    libraries of other sources found there."""
    monkeypatch.delenv("DPT_CACHE_DIR", raising=False)
    assert B.cache_dir() == B.DEFAULT_CACHE_DIR == REPO / "dose_prediction_tpu_torch" / "_build"
    assert cuda_lib.library_path().parent == B.DEFAULT_CACHE_DIR
    monkeypatch.setenv("DPT_CACHE_DIR", str(tmp_path / "live"))
    (tmp_path / "live").mkdir()
    (tmp_path / "live" / "libdpt_kernels_0123456789abcdef.so").write_bytes(b"")
    k = D._kernel_build()
    assert (k["dir"], k["built"]) == (str(tmp_path / "live"), False)
    assert k["other_sources"] == ["libdpt_kernels_0123456789abcdef.so"]
    assert k["lib"] == cuda_lib.library_path().name
    mocked_build.assert_not_called()


def test_cli_configures_the_build_before_dispatch_on_cuda_only(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(B, "configure_compile_cache", lambda: calls.append("build") or {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(D, "run", lambda args: 0)
    # eval fails on an empty data glob after the bootstrap
    empty = ["--data", str(tmp_path / "nothing_*"), "--ckpt", str(tmp_path / "ck")]
    with pytest.raises(FileNotFoundError):
        CLI.main(["eval", *empty])
    assert calls == ["build"]
    calls.clear()
    with pytest.raises(FileNotFoundError):
        CLI.main(["--device", "cpu", "eval", *empty])
    assert CLI.main(["score", "--pred-dir", str(tmp_path), "--gt-dir", str(tmp_path)]) == 1
    assert CLI.main(["doctor"]) == 0
    assert calls == []


def _key(variables, x, **flags):
    with mock.patch.multiple(FLAGS, **flags) if flags else contextlib.nullcontext():
        return A.capture_key((variables, x))


def test_capture_key_moves_with_what_a_graph_bakes_in():
    w = {"w": torch.ones(3), "b": torch.zeros(3)}
    x = torch.zeros(1, 4, 4, 4, 1)
    base = _key(w, x)
    assert base == _key(dict(w), x.clone())       # same addresses, same shapes: one graph
    moved = [_key(w, torch.zeros(1, 8, 4, 4, 1)), _key(w, x.bfloat16()),
             _key(w, x, use_k1_attention=not FLAGS.use_k1_attention),
             _key(w, x, use_k2_instance_norm="0" if FLAGS.k2_instance_norm() else "1"),
             _key(w, x, use_k3_conv3d="0" if FLAGS.use_k3_conv3d == "1" else "1"),
             _key({**w, "w": torch.ones(3)}, x)]
    assert len({base, *moved}) == 1 + len(moved)


def test_captured_entry_points_refuse_cpu_tensors(monkeypatch):
    x = torch.zeros(2)
    stage = A.LazyAOTStage("stage1", lambda v, t: t)
    for env in ("0", "1"):
        monkeypatch.setenv("DPT_NO_AOT", env)
        with pytest.raises(ValueError, match="'stage1'.*cpu"):
            stage({"w": torch.ones(1)}, x)
    assert stage.used_aot is None
    seg = TranSeg(out_ch=8, img_size=16, device="cpu", **VIT)
    dose = DosePyfer(list_ch_A=LIST_CH, img_size=16, device="cpu", **VIT)
    vol = torch.zeros(1, 16, 16, 16, 1)
    for name in ("stage1", "stage1_dense"):
        run = make_cascade_fn(seg, seg.state_dict(), dose, dose.state_dict(),
                              roi_size=(16, 16, 16), aot=True,
                              seg_mode="dense" if name == "stage1_dense" else "sliding")
        assert [s.name for s in run.stages][0] == name
        with pytest.raises(ValueError, match=f"'{name}'.*cpu"):
            run(vol, vol, vol)
