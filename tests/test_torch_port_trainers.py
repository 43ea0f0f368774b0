"""The port's trainers (train/trainers.py) against the JAX package's on the
CPU, from the same weights on the same cohort.

Two synthetic patients, written by the port's make_synthetic_dataset and
loaded by each package; both train on them and validate on them: 16³ for
DOSE-PYFER, 32³ for the C3D cascade and TranSeg (at 16³ the C3D U-Net's
fifth level is one voxel and TranSeg's ViT sees one token, where a norm's
gradient is pure rounding). The models are the CLIs' ``small`` ones; the
JAX trainer's initial weights go to the port through weights.jax_to_torch.
float32, two epochs of two steps, ``check_val=1``. Both packages draw the
same batches from ``seed + epoch`` (bit for bit:
tests/test_torch_port_data_feed.py).

Bars. Where no update has compounded rounding, rel 1e-5: the validation
(and ``test()``, rel 1e-4) of the two trainers before training, the first
epoch's train loss (one update in), and the port's evaluation of the JAX
trainer's final weights against the JAX trainer's last epoch record (and
``test()``, rel 1e-4). The trajectory after that is held by the noise-run
rule of the step tests (tests/test_torch_port_train_c3d.py), with two
seeded noise runs of the port in which each InstanceNorm and Linear output
carries a relative noise as large as the packages' own forward gap from
the initial weights (measured in each test, at least 1e-6): a later
epoch's train loss within max(1e-5, 2 × the runs' largest relative gap);
each parameter leaf's move from its initial value within max(1e-3, 2 ×
noise) × the JAX move's max |Δ|, with a floor of 2e-6 × the largest move
(noise: the worst leaf's relative gap in either run).

Outside that rule, for one reason (Adam's first updates are about
lr·sign(g)): the conv biases that feed a norm have a zero gradient in exact
arithmetic, so both packages move them by about the learning rate with a
sign set by rounding; they must have moved by no more than 2 × lr a step
in both. Eval-mode BatchNorm sees those moves, so the validation metrics
after updates wander (the DOSE-PYFER noise runs move the second epoch's
mean_dose_score by up to 6e-4 relative; the packages differ by 1.5e-3):
they are printed (``-s``), and the evaluation itself is held at the JAX
weights as above. adam8bit adds its quantizer: its int8 and uint8 codes may
differ by one step in one value in a thousand between the packages
(tests/test_torch_port_train_optim.py), a difference no output noise
models; after three updates the packages' losses differ by 6.3e-4 and a
1e-5 noise run moves the loss by up to 1.2e-3, so after its first update
the adam8bit trajectory is held by the second epoch's train loss within
2e-3 only.

The port's CPU work runs in one torch thread (``one_torch_thread``): beside
the JAX package's thread pool and five other test workers, more threads
only contend. The thread count moves no bar: a bar that a reduction's
order could move is a noise-run bar.

The tests are split by trainer, so that ``--dist loadfile`` spreads them
over workers: DOSE-PYFER here; the C3D cascade and TranSeg in
tests/test_torch_port_trainers_seg_c3d.py; the port against itself (an
interrupted and resumed fit ends bit for bit where an uninterrupted one
ends, the resume guard refuses a changed ``act``, a mesh is refused) in
tests/test_torch_port_trainers_resume.py. Those files take this file's
helpers and fixtures.
"""
import contextlib
import json
import re
from unittest import mock

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu.cli import main as JCLI  # noqa: E402
from dose_prediction_tpu.data import native as JN  # noqa: E402
from dose_prediction_tpu.data.openkbp import OpenKBPDataset as JDataset  # noqa: E402
from dose_prediction_tpu.train import trainers as JT  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.cli import main as CLI  # noqa: E402
from dose_prediction_tpu_torch.data.openkbp import OpenKBPDataset  # noqa: E402
from dose_prediction_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from dose_prediction_tpu_torch.nn.layers import InstanceNorm3d, Linear  # noqa: E402
from dose_prediction_tpu_torch.train import trainers as T  # noqa: E402

SIZE, SIZE32 = 16, 32
SHAPE, SHAPE32 = (1, SIZE, SIZE, SIZE, 9), (1, SIZE32, SIZE32, SIZE32, 9)
REL_EPOCH, REL_TEST = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def jax_without_native():
    with mock.patch.object(JN, "get_lib", lambda: None):   # the JAX reader's numpy path
        yield


def make_cohort(root, size):
    pattern = make_synthetic_dataset(root, n_patients=2, shape=(size,) * 3, seed=7)
    with mock.patch.object(JN, "get_lib", lambda: None):
        jds = JDataset(pattern, keep_structures=True, num_workers=1)
    return OpenKBPDataset(pattern, keep_structures=True, num_workers=1), jds


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return make_cohort(tmp_path_factory.mktemp("cohort"), SIZE)


@pytest.fixture(scope="module")
def cohort32(tmp_path_factory):
    """32³: the C3D U-Net's fifth level is 2³ and TranSeg's ViT sees 2³
    tokens a window. At 16³ both are one voxel or one token, where a norm's
    gradient is pure rounding (test_torch_port_train_c3d.py's reason)."""
    return make_cohort(tmp_path_factory.mktemp("cohort32"), SIZE32)


def records(log_dir):
    """{metric: [values by epoch]} of a metrics.jsonl."""
    out = {}
    for line in open(f"{log_dir}/metrics.jsonl"):
        rec = json.loads(line)
        for k, v in rec.items():
            if k not in ("step", "time", "run"):
                out.setdefault(k, []).append(v)
    return out


def rel_close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and bool(np.all(np.abs(a - b) <= rel * np.abs(b)))


def variables_of(jstate):
    return jax.tree_util.tree_map(np.asarray, {"params": jstate.params,
                                               "batch_stats": jstate.batch_stats})


def configs(tmp_path, tag, **kw):
    common = dict(max_epochs=2, check_val=1, seed=0, **kw)
    return (JT.TrainConfig(ckpt_dir=str(tmp_path / f"{tag}_jck"),
                           log_dir=str(tmp_path / f"{tag}_jlog"), **common),
            T.TrainConfig(ckpt_dir=str(tmp_path / f"{tag}_ck"),
                          log_dir=str(tmp_path / f"{tag}_log"), device="cpu", **common))


@contextlib.contextmanager
def noisy_outputs(seed, amplitude):
    """Each InstanceNorm and Linear output × (1 + amplitude·u), u seeded
    uniform in [-1, 1], kept out of the gradient: rounding-sized noise in
    the convolutional and the ViT paths."""
    g = torch.Generator().manual_seed(seed)

    def noisy(forward):
        def run(self, inp):
            out = forward(self, inp)
            u = torch.rand(out.shape, generator=g) * 2 - 1
            return out + (out * (amplitude * u)).detach()
        return run

    with mock.patch.object(InstanceNorm3d, "forward", noisy(InstanceNorm3d.forward)), \
            mock.patch.object(Linear, "forward", noisy(Linear.forward)):
        yield


def noise_amplitude(port_out, jax_out) -> float:
    """The noise runs' amplitude: the packages' own forward gap from the
    initial weights, max |port − jax| / max |jax| of one output, floored at
    the step tests' 1e-6."""
    jax_out = np.asarray(jax_out, np.float64)
    gap = float(np.abs(np.asarray(port_out, np.float64) - jax_out).max() / np.abs(jax_out).max())
    print(f"forward gap {gap:.3g}")
    return max(1e-6, gap)


def state_numpy(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def jax_state_numpy(jstate, model):
    return {k: v.numpy() for k, v in weights.jax_to_torch(variables_of(jstate), model).items()}


def assert_params_by_noise_rule(init, port, noisy_runs, jax_final, zero_grad, lr, updates,
                                exclude=()):
    """The final parameters, leaf by leaf, by the module docstring's rule;
    the leaves matching ``zero_grad`` (conv biases that feed a norm) moved
    by at most 2·lr per update in both packages."""
    names = [n for n in init if not n.endswith("num_batches_tracked")
             and not any(n.startswith(e) for e in exclude)]
    zero = [n for n in names if zero_grad.search(n)]
    for n in zero:
        for final in (port, jax_final):
            assert np.abs(final[n] - init[n]).max() <= 2 * lr * updates, n
    move = {n: float(np.abs(jax_final[n] - init[n]).max()) for n in names if n not in zero}
    names = [n for n in move if move[n] > 0]
    largest = max(move.values())
    noise = max(float(np.abs(noisy[n] - port[n]).max()) / move[n]
                for noisy in noisy_runs for n in names)
    rel = {n: float(np.abs(port[n] - jax_final[n]).max()) / move[n] for n in names}
    print(f"worst leaf |port - jax| / its move {max(rel.values()):.3g}, noise run "
          f"{noise:.3g}; {sum(r > 1e-3 for r in rel.values())} of {len(names)} over 1e-3; "
          f"{len(zero)} zero-gradient biases")
    for n in names:
        err = rel[n] * move[n]
        assert err <= max(max(1e-3, 2 * noise) * move[n], 2e-6 * largest), (n, rel[n], noise)
    assert len(names) > 20 and zero


def noise_runs(make, fit, amplitude):
    """The port's final states of two noise runs (seeds 0 and 1) and their
    metric records: ``make(tag)`` builds a trainer from the initial weights,
    ``fit(trainer)`` trains it."""
    runs = []
    for seed in (0, 1):
        twin = make(f"noise{seed}")
        with noisy_outputs(seed, amplitude):
            fit(twin)
        runs.append((state_numpy(twin.model), records(twin.cfg.log_dir)))
    return runs


def check_epochs(port, ref, runs, loss_key, shown, strict_first=True):
    """The first epoch's train loss within rel 1e-5; each later epoch's
    within max(1e-5, 2 × the noise runs' largest relative gap); the
    validation metrics after updates printed (module docstring). Without
    ``strict_first`` the first epoch too is held by the noise rule: where
    a first epoch of several steps holds losses after an update that the
    order of a reduction moves (the C3D trainer's, in its test)."""
    if strict_first:
        assert rel_close(port[loss_key][0], ref[loss_key][0], REL_EPOCH), (port, ref)
    for e in range(1 if strict_first else 0, len(ref[loss_key])):
        noise = max(abs(r[loss_key][e] - port[loss_key][e]) for _, r in runs)
        limit = max(REL_EPOCH, 2 * noise / abs(port[loss_key][e]))
        gap = abs(port[loss_key][e] - ref[loss_key][e]) / abs(ref[loss_key][e])
        print(f"{loss_key} epoch {e + 1}: |port - jax| rel {gap:.3g}, limit {limit:.3g}")
        assert gap <= limit, (loss_key, e, port[loss_key], ref[loss_key], limit)
    for k in shown:
        print(f"{k}: port {port[k]}, noise runs {[r[k] for _, r in runs]}, jax {ref[k]}")


def assert_close_dict(got, want, keys, rel):
    for k in keys:
        assert rel_close(got[k], want[k], rel), (k, got[k], want[k])


# conv biases that feed an InstanceNorm or a train-mode BatchNorm: the
# seg-family Conv31 blocks' k3 and k7 branch convs and fuse conv; the C3D
# SingleConv and UpConv convs (tests/test_torch_port_train{,_c3d}.py)
ZERO_GRAD_CONV31 = re.compile(r"conv_block\.cov_\.(conv_[37]\.0\.conv\.[03]|conv\.0)\.bias$")
ZERO_GRAD_C3D = re.compile(r"single_conv\.0\.bias$|upconv_\d\.conv\.0\.bias$")
SCORES = ("mean_dose_score", "std_dose_score", "mean_dvh_score")


@pytest.mark.parametrize("kind", ["adamw", "adam8bit"])
def test_pyfer_trainer_matches_jax(tmp_path, cohort, kind):
    ds, jds = cohort
    jcfg, cfg = configs(tmp_path, "a", optimizer=kind)
    jtr = JT.PyferTrainer(jcfg, model=JCLI.default_flagship_model(small=True),
                          example_shape=SHAPE)
    start = variables_of(jtr.state)

    def make(tag):
        model = CLI.default_flagship_model(small=True, img_size=(SIZE,) * 3, device="cpu")
        model.load_state_dict(weights.jax_to_torch(start, model), strict=True)
        return T.PyferTrainer(configs(tmp_path, tag, optimizer=kind)[1], model=model,
                              example_shape=SHAPE)

    tr = make("a")
    init = state_numpy(tr.model)
    batch = next(jax_val_batches(jds))
    amplitude = noise_amplitude(
        tr.eval_step({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        ["prediction"], jtr.eval_step(jtr.state, batch)["prediction"])
    # before any update the two trainers validate and test alike
    assert_close_dict(tr.validate(ds), jtr_validate(jtr, jds), ("mean_dose_score", "val_loss"),
                      REL_EPOCH)
    assert_close_dict(tr.test(ds), jtr.test(jds), SCORES, REL_TEST)
    jtr.fit(jds, jds, resume=False)
    tr.fit(ds, ds, resume=False)
    assert tr.state.step == int(jtr.state.step) == 4
    port, ref = records(cfg.log_dir), records(jcfg.log_dir)
    if kind == "adamw":
        runs = noise_runs(make, lambda t: t.fit(ds, ds, resume=False), amplitude)
        check_epochs(port, ref, runs, "train_mean_loss", ("mean_dose_score", "val_loss"))
        assert_params_by_noise_rule(init, state_numpy(tr.model), [r for r, _ in runs],
                                    jax_state_numpy(jtr.state, tr.model), ZERO_GRAD_CONV31,
                                    cfg.learning_rate, 4, exclude=("net_A.", "conv_out_A."))
    else:   # the quantizer's codes (module docstring)
        assert rel_close(port["train_mean_loss"][0], ref["train_mean_loss"][0], REL_EPOCH)
        assert rel_close(port["train_mean_loss"][1], ref["train_mean_loss"][1], 2e-3)
    # net_A stays frozen
    assert all(np.array_equal(init[k], v) for k, v in state_numpy(tr.model).items()
               if k.startswith(("net_A.", "conv_out_A.")))
    # the device half scores the port's predictions as the host half does
    got, on_device = tr.test(ds), tr.test(ds, device_metrics=True)
    assert rel_close(on_device["mean_dose_score"], got["mean_dose_score"], 1e-4)
    assert rel_close(on_device["mean_dvh_score"], got["mean_dvh_score"], 1e-3)
    defined = np.isfinite(got["ivs"])     # NaN on the host is 0 on the device
    assert np.allclose(np.asarray(on_device["ivs"])[defined], np.asarray(got["ivs"])[defined],
                       rtol=1e-4, atol=1e-5)
    # the port's evaluation of the JAX trainer's final weights
    tr.model.load_state_dict(weights.jax_to_torch(variables_of(jtr.state), tr.model))
    assert_close_dict(tr.validate(ds), {"mean_dose_score": ref["mean_dose_score"][-1],
                                        "val_loss": ref["val_loss"][-1]},
                      ("mean_dose_score", "val_loss"), REL_EPOCH)
    assert_close_dict(tr.test(ds), jtr.test(jds), SCORES, REL_TEST)


def jax_val_batches(jds):
    from dose_prediction_tpu.data.pipeline import dose_batches

    return dose_batches(jds, batch_size=1, shuffle=False, augment=False)


def jtr_validate(jtr, jds):
    """The JAX PyferTrainer's batch-1 validation sweep (trainers.py:613-621)."""
    scores, vlosses = [], []
    for batch in jax_val_batches(jds):
        out = jtr.eval_step(jtr.state, batch)
        scores.append(float(out["dose_score"]))
        vlosses.append(float(out["val_loss"]))
    return {"mean_dose_score": -float(np.mean(scores)), "val_loss": float(np.mean(vlosses))}
