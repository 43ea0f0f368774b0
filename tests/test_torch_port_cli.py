"""The port's command line (cli/main.py, python -m dose_prediction_tpu_torch)
on the CPU at ``--model-size small``.

The parser covers the ported subcommands and refuses, before any device
work and by name, what the port does not have (the message names the
ROADMAP item: meshes and bench). ViT-GAN and the exp model (on
the 16³ cohort, two one-step epochs each; ViT-GAN's critic from a seeded
MedicalNet-layout pickle, unfreezing at epoch 1): train (both optimizers
restarted at the unfreeze epoch), eval (host and device metrics, by the
bars below), predict, an explicit --lr as both ViT-GAN rates, the
eval guard on --act, and import-torch --kind resnet10|vitgan-g|exp-gen
of reference-layout files, each slot bit-equal to the JAX CLI's import of
the same file (dose_prediction_tpu.cli, carried by weights.jax_to_torch)
on every entry the file holds. train → eval → predict →
score on a synthetic 16³ cohort:
eval's device metrics against its host metrics (dose score rel 1e-4, DVH
score rel 1e-3, IVS rtol 1e-4 atol 1e-5 where the host's is defined: the
bars of tests/test_losses_metrics.py:252-254) and score's dose score against
eval's host one (rel 1e-4). import-torch of a replica of the reference
C3D cascade, then eval. The eval/serve guard refuses ``--act relu`` over a
mish checkpoint. infer writes the NIfTI that make_cascade_fn gives from the
same restored weights, bit for bit. tune runs its trials in their own
directories, journals them, resumes with one more trial, and refuses a
resume under another shared setting; kfold prints each fold's score.
DoseGAN (ngf = ndf = 4 on a 32³ cohort): train, then a resumed third
epoch, eval (device metrics against host metrics by the bars above),
predict, an explicit --lr as the GAN's rate, and import-torch --kind
dosegan-g|dosegan-d of a combined netG./netD. checkpoint (the slots equal
the state dicts) and of the reference torch replicas of
tests/test_golden_hdunet_dosegan.py (strict). In subprocesses where
importing jax or the JAX package fails: ``--help``, one train run of
DOSE-PYFER, one of HD-UNet and one of DoseGAN, a linked-eval, a tune and a
kfold; and a train run that
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

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu_torch.cli import main as CLI  # noqa: E402
from dose_prediction_tpu_torch.core.checkpoint import CheckpointManager, restore_checkpoint  # noqa: E402,E501
from dose_prediction_tpu_torch.data.nifti import read_nifti  # noqa: E402
from dose_prediction_tpu_torch.data.openkbp import load_patient  # noqa: E402
from dose_prediction_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from dose_prediction_tpu_torch.infer.cascade import make_cascade_fn  # noqa: E402

from test_golden_hdunet_dosegan import _torch_dosegan_d, _torch_dosegan_g  # noqa: E402
from test_torch_import import _torch_cascade  # noqa: E402  (the reference C3D replica)

REPO = Path(__file__).resolve().parents[1]
SIZE = 16
GAN_SIZE = 32        # DoseGAN's five levels need 32³


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
    (["train", "dosegan", "--data", "x", "--mesh", "data=4"], "item 7"),
    (["train", "pyfer", "--data", "x", "--mesh", "data=4"], "item 7"),
    (["train", "vitgan", "--data", "x", "--mesh", "data=4"], "item 7"),
    (["tune", "--data", "x", "--mesh", "data=4"], "item 7"),
    (["kfold", "--data", "x", "--mesh", "data=2"], "item 7"),
    (["bench"], "bench_gpu.py"),
    (["train", "c3d", "--data", "x", "--mesh", "data=2"], "item 7"),
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
            "import-torch", "tune", "kfold"} <= set(sub.choices)
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


def tune_argv(pattern, root, *extra):
    return small("tune", "--data", pattern, "--epochs", "2", "--check-val", "1",
                 "--sampler", "random", "--ckpt-dir", str(root / "tck"), "--log-dir",
                 str(root / "tlog"), *extra)


def test_tune_journals_resumes_and_guards_its_settings(tmp_path, cohort, capsys):
    _, pattern = cohort
    rc, res = run_cli(tune_argv(pattern, tmp_path, "--num-samples", "2"), capsys)
    assert rc == 0 and set(res["best_config"]) == {"act", "multiS_conv", "lr", "weight_decay"}
    journal = tmp_path / "tlog" / "trials.jsonl"
    trials = [json.loads(line) for line in journal.read_text().splitlines()]
    assert [t["trial_id"] for t in trials] == [0, 1]
    assert res["best_value"] == min(t["last_value"] for t in trials)
    for n in (0, 1):   # each trial's own slots and log; ASHA may stop it after round 1
        assert (tmp_path / "tck" / f"trial_{n}" / "monitored").is_dir()
        assert (tmp_path / "tlog" / f"trial_{n}" / "metrics.jsonl").exists()
        rounds = [e for e, _ in trials[n]["report_log"]]
        assert rounds == ([1] if trials[n]["stopped"] else [1, 2])
        assert (tmp_path / "tck" / f"trial_{n}" / "last.pt").exists() == (rounds == [1, 2])
    settings = json.loads((tmp_path / "tlog" / "tune_config.json").read_text())
    assert settings == {"optimizer": "adam8bit", "model_size": "small", "feed_dtype": "float32"}
    rc, _ = run_cli(tune_argv(pattern, tmp_path, "--num-samples", "3", "--resume"), capsys)
    assert rc == 0
    assert [json.loads(line)["trial_id"] for line in journal.read_text().splitlines()] == [0, 1, 2]
    assert (tmp_path / "tlog" / "trial_2" / "metrics.jsonl").exists()   # not trial_0's
    with pytest.raises(SystemExit, match="tune --resume"):
        CLI.main(tune_argv(pattern, tmp_path, "--num-samples", "4", "--resume",
                           "--optimizer", "adamw"))
    assert len(journal.read_text().splitlines()) == 3


def test_kfold_prints_each_folds_score(tmp_path, cohort, capsys):
    _, pattern = cohort
    rc, res = run_cli(small("kfold", "--data", pattern, "--folds", "2", "--epochs", "1",
                            "--check-val", "1", "--ckpt-dir", str(tmp_path / "k"),
                            "--log-dir", str(tmp_path / "kl")), capsys)
    assert rc == 0 and sorted(res) == ["0", "1"]
    assert all(np.isfinite(r["mean_dose_score"]) for r in res.values())
    assert all((tmp_path / "k" / f"fold_{f}" / "last.pt").exists() for f in (0, 1))


@pytest.fixture(scope="module")
def gan_cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("gan")
    return root, make_synthetic_dataset(root / "data", n_patients=2, shape=(GAN_SIZE,) * 3,
                                        seed=4)


def gan_train(pattern, root, epochs, *extra):
    return small("train", "dosegan", "--data", pattern, "--val-data", pattern, "--epochs",
                 str(epochs), "--check-val", "1", "--samples-per-epoch", "1",
                 "--ckpt-dir", str(root / "gck"), "--log-dir", str(root / "glog"), *extra)


def test_dosegan_train_resume_eval_predict(gan_cohort, capsys):
    root, pattern = gan_cohort
    assert CLI.main(gan_train(pattern, root, 2)) == 0
    assert CLI.main(gan_train(pattern, root, 3)) == 0
    assert "resumed from epoch 1" in capsys.readouterr().out
    last = restore_checkpoint(root / "gck" / "last.pt")
    assert set(last) == {"g", "d", "epoch"} and last["epoch"] == 2
    assert last["g"]["step"] == last["d"]["step"] == 3
    assert last["g"]["optimizer"]["param_groups"][0]["lr"] == 2e-4     # the GAN's own rate
    evaluate = small("eval", "--model", "dosegan", "--data", pattern, "--ckpt",
                     str(root / "gck" / "last.pt"))
    rc, host = run_cli(evaluate, capsys)
    rc2, device = run_cli(evaluate + ["--device-metrics"], capsys)
    assert rc == rc2 == 0 and np.isfinite(host["mean_dose_score"])
    assert abs(device["mean_dose_score"] - host["mean_dose_score"]) <= \
        1e-4 * abs(host["mean_dose_score"])
    assert abs(device["mean_dvh_score"] - host["mean_dvh_score"]) <= \
        1e-3 * abs(host["mean_dvh_score"])
    assert CLI.main(small("predict", "--model", "dosegan", "--data", pattern, "--ckpt",
                          str(root / "gck" / "last.pt"), "--out-dir", str(root / "gpred"))) == 0
    assert sorted(p.name for p in (root / "gpred").iterdir()) == ["pt_0", "pt_1"]
    assert CLI.main(small("train", "dosegan", "--data", pattern, "--epochs", "1",
                          "--samples-per-epoch", "1", "--lr", "1e-3", "--ckpt-dir",
                          str(root / "lr"), "--log-dir", str(root / "lrl"))) == 0
    assert restore_checkpoint(root / "lr" / "last.pt")["d"]["optimizer"]["param_groups"][0][
        "lr"] == 1e-3


@pytest.mark.parametrize("kind", ["dosegan-g", "dosegan-d"])
def test_import_dosegan_nets(tmp_path, gan_cohort, kind):
    """A combined netG./netD. checkpoint (what a Lightning GAN saves) of
    trained nets, and a bare reference-layout replica, each strictly."""
    root, pattern = gan_cohort
    if not (root / "gck" / "last.pt").exists():
        assert CLI.main(gan_train(pattern, root, 1)) == 0
    slot = restore_checkpoint(root / "gck" / "last.pt")
    src = tmp_path / "gan.ckpt"
    torch.save({"state_dict": {**{f"netG.{k}": v for k, v in slot["g"]["model"].items()},
                               **{f"netD.{k}": v for k, v in slot["d"]["model"].items()}}}, src)
    dest = tmp_path / "net.pt"
    assert CLI.main(small("import-torch", "--kind", kind, "--src", str(src),
                          "--dest", str(dest))) == 0
    want = slot["g" if kind == "dosegan-g" else "d"]["model"]
    got = restore_checkpoint(dest)
    assert set(got) == set(want) and all(torch.equal(got[k], v) for k, v in want.items())
    torch.manual_seed(0)
    replica = _torch_dosegan_g(ngf=4) if kind == "dosegan-g" else _torch_dosegan_d(ndf=4)
    bare = tmp_path / "replica.pth"
    torch.save(replica.state_dict(), bare)
    assert CLI.main(small("import-torch", "--kind", kind, "--src", str(bare),
                          "--dest", str(dest))) == 0
    got = restore_checkpoint(dest)
    assert all(torch.equal(got[k], v) for k, v in replica.state_dict().items())


def without_jax(tmp_path) -> dict:
    """An environment in which ``import jax`` and ``import dose_prediction_tpu``
    fail: shadow packages that raise, ahead of the repository on the path."""
    shadow = tmp_path / "shadow"
    for name in ("jax", "dose_prediction_tpu"):
        (shadow / name).mkdir(parents=True, exist_ok=True)
        (shadow / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not importable here')\n")
    return {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "PYTHONPATH": f"{shadow}{os.pathsep}{REPO}", "HOME": str(tmp_path),
            "OMP_NUM_THREADS": "1"}


def test_cli_runs_where_jax_cannot_be_imported(tmp_path, cohort, trained,
                                               gan_cohort):
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
    _, gan_pattern = gan_cohort
    for name, argv in (
            ("tune", tune_argv(pattern, tmp_path, "--num-samples", "1", "--epochs", "1")),
            ("kfold", small("kfold", "--data", pattern, "--folds", "2", "--epochs", "1",
                            "--max-steps", "1", "--ckpt-dir", str(tmp_path / "kf"),
                            "--log-dir", str(tmp_path / "kfl"))),
            ("dosegan", small("train", "dosegan", "--data", gan_pattern, "--epochs", "1",
                              "--max-steps", "1", "--ckpt-dir", str(tmp_path / "gan"),
                              "--log-dir", str(tmp_path / "ganl")))):
        proc = subprocess.run([sys.executable, "-m", "dose_prediction_tpu_torch", *argv],
                              cwd=tmp_path, env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, (name, proc.stderr[-2000:])
    assert (tmp_path / "tlog" / "trials.jsonl").exists()
    assert (tmp_path / "gan" / "last.pt").exists()


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
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
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


# -- ViT-GAN and the exp model ---------------------------------------------------

def medicalnet_pickle(path, widths=(64, 128, 256, 512), seed=5):
    """A MedicalNet-layout resnet_10 pickle: a seeded ResNet-10 without fc,
    under DataParallel's 'module.' prefix. Returns its entries."""
    from dose_prediction_tpu_torch.models.experiments import resnet10

    torch.manual_seed(seed)
    sd = {k: v for k, v in resnet10(widths=widths, device="cpu").state_dict().items()
          if not k.startswith("fc.")}
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    return sd


@pytest.fixture(scope="module")
def zoo_trained(cohort, tmp_path_factory):
    """ViT-GAN (critic from a pickle, unfreezing at epoch 1) and the exp
    model, each trained for two one-step epochs through the CLI."""
    _, pattern = cohort
    root = tmp_path_factory.mktemp("zoo")
    medicalnet_pickle(root / "resnet_10.pth")
    common = ("--data", pattern, "--val-data", pattern, "--epochs", "2", "--check-val", "1",
              "--samples-per-epoch", "1")
    assert CLI.main(small("train", "vitgan", *common, "--pretrained-critic",
                          str(root / "resnet_10.pth"), "--unfreeze-epoch", "1",
                          "--ckpt-dir", str(root / "vg"), "--log-dir", str(root / "vgl"))) == 0
    assert CLI.main(small("train", "exp", *common, "--ckpt-dir", str(root / "ex"),
                          "--log-dir", str(root / "exl"))) == 0
    return root, pattern


def jax_cli_import(kind, src, dest, port_model):
    """The JAX CLI's import-torch of ``src`` at the small width, as the
    port model's state dict."""
    from dose_prediction_tpu.cli import main as JCLI
    from dose_prediction_tpu.core.checkpoint import restore_checkpoint as jax_restore

    from dose_prediction_tpu_torch import weights

    assert JCLI.main(["--platform", "cpu", "import-torch", "--kind", kind, "--src", str(src),
                      "--dest", str(dest), "--model-size", "small",
                      "--volume-size", str(SIZE)]) == 0
    variables = jax_restore(dest)
    return weights.jax_to_torch({"params": variables["params"],
                                 "batch_stats": variables.get("batch_stats") or {}},
                                port_model)


ZOO_CASES = ["train-vitgan", "train-exp", "eval-vitgan", "eval-exp", "predict-vitgan",
             "predict-exp", "vitgan-lr", "exp-act-guard", "import-resnet10",
             "import-vitgan-g", "import-exp-gen"]


@pytest.mark.parametrize("case", ZOO_CASES)
def test_vitgan_and_exp_commands_run(case, zoo_trained, tmp_path, capsys):
    root, pattern = zoo_trained
    slot = {"vitgan": root / "vg" / "last.pt", "exp": root / "ex" / "last.pt"}
    kind = case.split("-", 1)[1]
    if case == "train-vitgan":
        last = restore_checkpoint(slot["vitgan"])
        assert set(last) == {"g", "d", "epoch"} and last["epoch"] == 1
        assert (last["g"]["step"], last["d"]["step"]) == (2, 2)
        # both optimizers restarted at epoch 1: one update counted since
        assert (last["g"]["optimizer"]["count"], last["d"]["optimizer"]["count"]) == (1, 1)
        assert "critic unfrozen, optimizers restarted" in (root / "vgl" / "log.txt").read_text()
    elif case == "train-exp":
        last = restore_checkpoint(slot["exp"])
        assert last["epoch"] == 1 and last["step"] == 2
        assert sorted(p.name for p in (root / "ex").iterdir()) == \
            ["last.pt", "monitored", "run_config.json"]
    elif case.startswith("eval-"):
        evaluate = small("eval", "--model", kind, "--data", pattern, "--ckpt", str(slot[kind]),
                         "--ckpt-dir", str(tmp_path / "c"), "--log-dir", str(tmp_path / "l"))
        rc, host = run_cli(evaluate, capsys)
        rc2, device = run_cli(evaluate + ["--device-metrics"], capsys)
        assert rc == rc2 == 0 and np.isfinite(host["mean_dose_score"])
        assert abs(device["mean_dose_score"] - host["mean_dose_score"]) <= \
            1e-4 * abs(host["mean_dose_score"])
        assert abs(device["mean_dvh_score"] - host["mean_dvh_score"]) <= \
            1e-3 * abs(host["mean_dvh_score"])
    elif case.startswith("predict-"):
        out = tmp_path / "pred"
        assert CLI.main(small("predict", "--model", kind, "--data", pattern, "--ckpt",
                              str(slot[kind]), "--out-dir", str(out), "--ckpt-dir",
                              str(tmp_path / "c"), "--log-dir", str(tmp_path / "l"))) == 0
        assert sorted(p.name for p in out.iterdir()) == ["pt_0", "pt_1"]
        vol = read_nifti(out / "pt_0" / "dose.nii.gz").data
        assert vol.shape == (SIZE,) * 3 and np.isfinite(vol).all() and vol.min() >= 0
    elif case == "vitgan-lr":
        assert CLI.main(small("train", "vitgan", "--data", pattern, "--epochs", "1",
                              "--samples-per-epoch", "1", "--lr", "1e-3", "--ckpt-dir",
                              str(tmp_path / "lr"), "--log-dir", str(tmp_path / "lrl"))) == 0
        last = restore_checkpoint(tmp_path / "lr" / "last.pt")
        assert last["g"]["optimizer"]["param_groups"][0]["lr"] == \
            last["d"]["optimizer"]["param_groups"][0]["lr"] == 1e-3
        # no pretrained critic: it waits for the unfreeze epoch whole
        assert last["d"]["step"] == 0 and last["g"]["step"] == 1
    elif case == "exp-act-guard":
        argv = small("eval", "--model", "exp", "--data", pattern, "--ckpt", str(slot["exp"]),
                     "--act", "relu")
        with pytest.raises(SystemExit, match="act: trained 'mish' vs now 'relu'"):
            CLI.main(argv)
    else:
        from dose_prediction_tpu_torch.models import experiments as E

        kind = case[len("import-"):]
        src = tmp_path / "ref.ckpt"
        if kind == "resnet10":
            want = medicalnet_pickle(src, widths=(4, 8, 16, 32))
            model = E.resnet10(widths=(4, 8, 16, 32), device="cpu")
        elif kind == "vitgan-g":
            last = restore_checkpoint(slot["vitgan"])
            want = last["g"]["model"]
            torch.save({"state_dict": {**{f"generator.{k}": v for k, v in want.items()},
                                       **{f"discriminator.{k}": v
                                          for k, v in last["d"]["model"].items()}}}, src)
            model = E.vitgan_generator(small=True, img_size=SIZE, device="cpu")
        else:
            want = restore_checkpoint(slot["exp"])["model"]
            torch.save({"state_dict": {**{f"model_.{k}": v for k, v in want.items()},
                                       "model_.out.0.weight": torch.zeros(1, 2, 1, 1, 1),
                                       "model_.out.0.bias": torch.zeros(1)}}, src)
            model = E.exp_generator(small=True, img_size=SIZE, device="cpu")
        dest = tmp_path / "imported.pt"
        assert CLI.main(small("import-torch", "--kind", kind, "--src", str(src), "--dest",
                              str(dest), "--volume-size", str(SIZE))) == 0
        got = restore_checkpoint(dest)
        jax_sd = jax_cli_import(kind, src, tmp_path / "jax_imported", model)
        entries = [k for k in want if not k.endswith("num_batches_tracked")]
        assert entries and all(torch.equal(got[k], want[k]) for k in entries)
        assert all(torch.equal(got[k], jax_sd[k]) for k in entries)
        if kind != "resnet10":                    # strict: every entry from the file
            assert set(got) == set(want)
