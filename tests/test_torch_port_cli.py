"""The port's command line (cli/main.py, python -m dose_prediction_tpu_torch)
on the CPU at ``--model-size small``.

The parser covers the ported subcommands and refuses, before any device
work and by name, what the port does not have (the message names the
ROADMAP item; the re-pointed cases name the DoseGAN, ViT-GAN and exp models
and their imports, which the port does not have). train → eval → predict →
score on a synthetic 16³ cohort:
eval's device metrics against its host metrics (dose score rel 1e-4, DVH
score rel 1e-3, IVS rtol 1e-4 atol 1e-5 where the host's is defined: the
bars of tests/test_losses_metrics.py:252-254) and score's dose score against
eval's host one (rel 1e-4). import-torch of a replica of the reference
C3D cascade, then eval. The eval/serve guard refuses ``--act relu`` over a
mish checkpoint. infer writes the NIfTI that make_cascade_fn gives from the
same restored weights, bit for bit. In subprocesses where importing jax or
the JAX package fails: ``--help``, one train run of DOSE-PYFER and one of
HD-UNet, and a linked-eval; and a train run that
gets SIGTERM stops gracefully, exits 0 with a 'last' slot, and a rerun
resumes from it.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dose_prediction_tpu_torch.cli import main as CLI  # noqa: E402
from dose_prediction_tpu_torch.core.checkpoint import CheckpointManager, restore_checkpoint  # noqa: E402,E501
from dose_prediction_tpu_torch.data.nifti import read_nifti  # noqa: E402
from dose_prediction_tpu_torch.data.openkbp import load_patient  # noqa: E402
from dose_prediction_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from dose_prediction_tpu_torch.infer.cascade import make_cascade_fn  # noqa: E402

from test_torch_import import _torch_cascade  # noqa: E402  (the reference C3D replica)

REPO = Path(__file__).resolve().parents[1]
SIZE = 16


def run_cli(argv, capsys):
    """main(argv) in this process: (return code, parsed JSON of stdout if any)."""
    rc = CLI.main(argv)
    out = capsys.readouterr().out
    start = out.find("{")
    return rc, (json.loads(out[start:]) if start >= 0 and out.rstrip().endswith("}") else None)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    pattern = make_synthetic_dataset(root / "data", n_patients=2, shape=(SIZE,) * 3, seed=3)
    return root, pattern


def small(*argv):
    return ["--device", "cpu", *argv, "--model-size", "small"]


@pytest.fixture(scope="module")
def trained(cohort):
    """A small DOSE-PYFER trained for two epochs (adam8bit, the packed feed)
    and a small TranSeg for one, through the CLI."""
    root, pattern = cohort
    assert CLI.main(small("train", "pyfer", "--data", pattern, "--val-data", pattern,
                          "--epochs", "2", "--check-val", "1", "--feed-dtype", "packed",
                          "--ckpt-dir", str(root / "ck"), "--log-dir", str(root / "log"))) == 0
    assert CLI.main(small("train", "transeg", "--data", pattern, "--epochs", "1",
                          "--roi", str(SIZE), "--batch-size", "2",
                          "--ckpt-dir", str(root / "seg"), "--log-dir", str(root / "slog"))) == 0
    return root


@pytest.mark.parametrize("argv,item", [
    (["train", "vitgan", "--data", "x"], "the vitgan model"),
    (["train", "dosegan", "--data", "x"], "item 6"),
    (["eval", "--model", "vitgan", "--data", "x", "--ckpt", "c"], "item 6"),
    (["predict", "--model", "exp", "--data", "x", "--ckpt", "c", "--out-dir", "o"], "item 6"),
    (["train", "exp", "--data", "x"], "the exp model"),
    (["eval", "--model", "dosegan", "--data", "x", "--ckpt", "c"], "the dosegan model"),
    (["predict", "--model", "dosegan", "--data", "x", "--ckpt", "c", "--out-dir", "o"],
     "the dosegan model"),
    (["import-torch", "--kind", "resnet10", "--src", "a", "--dest", "b"], "kind resnet10"),
    (["import-torch", "--kind", "dosegan-g", "--src", "a", "--dest", "b"], "kind dosegan-g"),
    (["import-torch", "--kind", "dosegan-d", "--src", "a", "--dest", "b"], "kind dosegan-d"),
    (["import-torch", "--kind", "vitgan-g", "--src", "a", "--dest", "b"], "kind vitgan-g"),
    (["train", "pyfer", "--data", "x", "--mesh", "data=4"], "item 7"),
    (["import-torch", "--kind", "exp-gen", "--src", "a", "--dest", "b"], "kind exp-gen"),
    (["tune"], "train/tune.py"),
    (["kfold"], "train/kfold.py"),
    (["bench"], "bench_gpu.py"),
    (["doctor"], "item 7"),
])
def test_unported_choices_are_refused_by_name(argv, item):
    # the default device (cuda) is never reached: refusals come first
    with pytest.raises(SystemExit, match=item) as e:
        CLI.main(argv)
    assert "not ported" in str(e.value) and "ROADMAP" in str(e.value)


def test_parser_covers_the_ported_subcommands():
    parser = CLI.build_parser()
    sub = next(a for a in parser._actions if a.dest == "cmd")
    assert {"train", "eval", "seg-eval", "predict", "infer", "score", "openkbp-prepare",
            "import-torch"} <= set(sub.choices)
    args = parser.parse_args(["train", "c3d", "--data", "x", "--scheduler", "cosine",
                              "--lr-encoder", "1e-3", "--t-max", "4"])
    assert (args.device, args.scheduler, args.t_max) == ("cuda", "cosine", 4)
    assert CLI.resolve_optimizer(None, "pyfer") == "adam8bit"
    assert CLI.resolve_optimizer(None, "c3d") == "adamw"
    assert CLI.resolve_optimizer("adamw", "pyfer") == "adamw"


def test_train_eval_predict_score(trained, cohort, capsys):
    root, pattern = cohort
    slots = sorted(p.name for p in (root / "ck").iterdir())
    assert slots == ["last.pt", "monitored", "run_config.json"]
    assert json.loads((root / "ck" / "run_config.json").read_text())["optimizer"] == "adam8bit"
    best = str(CheckpointManager(root / "ck", monitor="mean_dose_score").step_path(
        CheckpointManager(root / "ck", monitor="mean_dose_score").best_step()))
    evaluate = small("eval", "--data", pattern, "--ckpt", best)
    rc, host = run_cli(evaluate, capsys)
    assert rc == 0 and np.isfinite(host["mean_dose_score"]) and len(host["ivs"]) == 101
    rc, device = run_cli(evaluate + ["--device-metrics"], capsys)
    assert rc == 0
    assert abs(device["mean_dose_score"] - host["mean_dose_score"]) <= \
        1e-4 * abs(host["mean_dose_score"])
    assert abs(device["mean_dvh_score"] - host["mean_dvh_score"]) <= \
        1e-3 * abs(host["mean_dvh_score"])
    # a level no voxel of either volume reaches: NaN on the host (0/0), 0 on
    # the device (a weighted sum stays finite), in both packages
    ivs_host, ivs_device = np.asarray(host["ivs"]), np.asarray(device["ivs"])
    defined = np.isfinite(ivs_host)
    assert defined[:10].all() and not ivs_device[~defined].any()
    np.testing.assert_allclose(ivs_device[defined], ivs_host[defined], rtol=1e-4, atol=1e-5)
    assert CLI.main(small("predict", "--data", pattern, "--ckpt", best,
                          "--out-dir", str(root / "pred"))) == 0
    capsys.readouterr()
    rc, scored = run_cli(["score", "--pred-dir", str(root / "pred"),
                          "--gt-dir", str(root / "data")], capsys)
    assert rc == 0
    assert abs(scored["dose_score"] - host["mean_dose_score"]) <= \
        1e-4 * abs(host["mean_dose_score"])


def test_eval_refuses_another_act_over_a_mish_checkpoint(trained, cohort, monkeypatch):
    root, pattern = cohort
    argv = small("eval", "--data", pattern, "--ckpt", str(root / "ck" / "last.pt"),
                 "--act", "relu")
    with pytest.raises(SystemExit, match="act: trained 'mish' vs now 'relu'"):
        CLI.main(argv)
    monkeypatch.setenv("DPT_SKIP_CONFIG_CHECK", "1")
    assert CLI.main(argv) == 0


def test_import_torch_then_eval(tmp_path, cohort, capsys):
    _, pattern = cohort
    torch.manual_seed(0)
    replica = _torch_cascade(CLI.SMALL_LIST_CH)
    src = tmp_path / "ref.pkl"
    torch.save({"network_state_dict": {f"module.{k}": v for k, v in
                                       replica.state_dict().items()}}, src)
    dest = tmp_path / "imported.pt"
    assert CLI.main(small("import-torch", "--kind", "c3d", "--src", str(src),
                          "--dest", str(dest), "--strict")) == 0
    imported = restore_checkpoint(dest)
    assert all(torch.equal(imported[k], v) for k, v in replica.state_dict().items())
    capsys.readouterr()
    rc, res = run_cli(small("eval", "--model", "c3d", "--data", pattern, "--ckpt", str(dest),
                            "--ckpt-dir", str(tmp_path / "ck"), "--log-dir",
                            str(tmp_path / "log")), capsys)
    assert rc == 0 and np.isfinite(res["mean_dose_score"])
    assert CLI.main(small("import-torch", "--kind", "c3d", "--src", str(src),
                          "--dest", str(tmp_path / "x.pt"), "--volume-size", "16")) == 0


@pytest.mark.parametrize("seg_mode,dtype", [("sliding", "bfloat16"), ("dense", "float32")])
def test_infer_writes_what_make_cascade_fn_gives(trained, cohort, tmp_path, seg_mode, dtype):
    root, _ = cohort
    out = tmp_path / "dose.nii.gz"
    patient = root / "data" / "pt_0"
    assert CLI.main(small("infer", "--patient", str(patient), "--seg-ckpt",
                          str(root / "seg" / "last.pt"), "--dose-ckpt",
                          str(root / "ck" / "last.pt"), "--roi", str(SIZE), "--out", str(out),
                          "--seg-mode", seg_mode, "--serve-dtype", dtype)) == 0
    p = load_patient(str(patient))
    grid = (SIZE // 16,) * 3 if seg_mode == "dense" else None
    seg = CLI.default_seg_model(small=True, img_size=(SIZE,) * 3, trained_grid=grid,
                                device="cpu")
    dose = CLI.default_flagship_model(small=True, img_size=p.ct.shape, device="cpu")
    seg.load_state_dict(restore_checkpoint(root / "seg" / "last.pt")["model"])
    dose.load_state_dict(restore_checkpoint(root / "ck" / "last.pt")["model"])
    bf16 = dtype == "bfloat16"
    run = make_cascade_fn(seg, seg.state_dict(), dose, dose.state_dict(),
                          roi_size=(SIZE,) * 3, seg_mode=seg_mode,
                          sw_batch_size=8 if bf16 else 4,
                          input_dtype=torch.bfloat16 if bf16 else None)
    vol = lambda a: torch.from_numpy(a[None, ..., None])  # noqa: E731
    want = run(vol(p.ct), vol(p.ptv), vol(p.dose_mask)).float().numpy()[0, ..., 0]
    assert np.array_equal(read_nifti(out).data, want)


def without_jax(tmp_path) -> dict:
    """An environment in which ``import jax`` and ``import dose_prediction_tpu``
    fail: shadow packages that raise, ahead of the repository on the path."""
    shadow = tmp_path / "shadow"
    for name in ("jax", "dose_prediction_tpu"):
        (shadow / name).mkdir(parents=True, exist_ok=True)
        (shadow / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not importable here')\n")
    return {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "PYTHONPATH": f"{shadow}{os.pathsep}{REPO}", "HOME": str(tmp_path)}


def test_cli_runs_where_jax_cannot_be_imported(tmp_path, cohort, trained):
    root, pattern = cohort
    env = without_jax(tmp_path)
    proc = subprocess.run([sys.executable, "-c", "import jax"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0 and "not importable" in proc.stderr
    help_ = subprocess.run([sys.executable, "-m", "dose_prediction_tpu_torch", "--help"],
                           cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert help_.returncode == 0 and "--device" in help_.stdout, help_.stderr[-2000:]
    train = subprocess.run(
        [sys.executable, "-m", "dose_prediction_tpu_torch", *small(
            "train", "pyfer", "--data", pattern, "--epochs", "1", "--max-steps", "1",
            "--ckpt-dir", str(tmp_path / "ck"), "--log-dir", str(tmp_path / "log"))],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert train.returncode == 0, train.stderr[-2000:]
    assert (tmp_path / "ck" / "last.pt").exists()
    hdunet = subprocess.run(
        [sys.executable, "-m", "dose_prediction_tpu_torch", *small(
            "train", "hdunet", "--data", pattern, "--epochs", "1", "--max-steps", "1",
            "--ckpt-dir", str(tmp_path / "hd"), "--log-dir", str(tmp_path / "hl"))],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert hdunet.returncode == 0, hdunet.stderr[-2000:]
    linked = subprocess.run(
        [sys.executable, "-m", "dose_prediction_tpu_torch", *small(
            "linked-eval", "--data", pattern, "--seg-ckpt", str(root / "seg" / "last.pt"),
            "--dose-ckpt", str(root / "ck" / "last.pt"), "--roi", str(SIZE), "--no-ivs",
            "--log-dir", str(tmp_path / "ll"))],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert linked.returncode == 0, linked.stderr[-2000:]
    assert np.isfinite(json.loads(linked.stdout[linked.stdout.rfind("\n{\n") + 1:])[
        "mean_dose_score"])


def test_sigterm_stops_gracefully_and_the_rerun_resumes(tmp_path, cohort):
    """One step an epoch (--samples-per-epoch 1): once the first epoch's slot
    exists, SIGTERM; the run finishes its step, saves 'last' and exits 0
    (the handler installs in the main thread only, as in JAX); the rerun
    resumes from that slot with the step count carried on."""
    _, pattern = cohort
    argv = [sys.executable, "-m", "dose_prediction_tpu_torch", *small(
        "train", "pyfer", "--data", pattern, "--epochs", "100000", "--check-val", "100000",
        "--samples-per-epoch", "1", "--ckpt-dir", str(tmp_path / "ck"),
        "--log-dir", str(tmp_path / "log"))]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(argv, cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    last = tmp_path / "ck" / "last.pt"
    try:
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline and not last.exists() and proc.poll() is None:
            time.sleep(0.2)
        assert last.exists(), proc.stdout.read() if proc.poll() is not None else "no slot"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    assert "SIGTERM received" in out
    stopped = restore_checkpoint(last)
    assert stopped["step"] >= 1 and stopped["step"] == stopped["epoch"] + 1
    rerun = subprocess.run(argv[:argv.index("100000")] + [str(stopped["epoch"] + 2)]
                           + argv[argv.index("100000") + 1:], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=300)
    assert rerun.returncode == 0, rerun.stderr[-2000:]
    assert f"resumed from epoch {stopped['epoch']}" in rerun.stdout
    assert restore_checkpoint(last)["step"] == stopped["step"] + 1
