"""The port's DoseGAN (models/dosegan.py, train/steps.py::make_dosegan_train_steps,
train/trainers.py::DoseGANTrainer) against the JAX package's on the CPU, at
ngf = ndf = 4 on 32³ (the least size for the generator's five levels),
float32, from the port's seeded weights carried into JAX by the JAX
package's own reference importers (core/torch_import.py::import_dosegan_g
and import_dosegan_d of the port's ``state_dict()``, which must use every
entry and fill every leaf).

Bars:
- forward of the generator and the critic, in eval and in train mode:
  within 1e-3 of the JAX output's largest |value| (the bar of
  tests/test_golden_pyfer.py); the running statistics after a train-mode
  call within 1e-5 (BatchNorm buffers: a running mean within 1e-5 of
  max(|mean|, √var) of its channel, the scale its batch values have; a
  running variance within 1e-5 of itself);
- one ``make_dosegan_train_steps`` call from the same states and batch:
  ``d_loss`` and ``g_loss`` within rel 1e-5; both nets' BatchNorm buffers
  (the critic's updated twice, the generator's once, the throw-aways
  thrown away) within 1e-5 as above; each gradient leaf of both nets
  within max(1e-3, 2 × that leaf's largest departure in three noise runs)
  × its own max |g| (a floor of 2e-6 × the net's largest |g|), the rule of
  tests/test_torch_port_zoo_train.py. A noise run adds to each BatchNorm
  output 1e-6 × u × its channel's largest |value| (u seeded uniform in
  [-1, 1], kept out of the gradient): rounding in the norm's subtraction
  is of that size, and in the ReLUs after it moves the values near 0
  across 0; the packages' float32 gradients differ by up to 3 % of some
  deep generator leaves' scale, within what these runs move the port.
  Conv biases that feed a train-mode BatchNorm have a zero gradient in
  exact arithmetic: below 1e-4 of the net's largest |g| in both;
- DoseGANTrainer for two epochs of one step: validation and test() before
  any update at rel 1e-5 and 1e-4; ``disc_loss`` and ``gan_loss`` of the
  first epoch at rel 1e-5; the rest of ``gan_loss``, ``disc_loss``,
  ``mean_dose_score`` and ``val_loss`` by the noise rule of
  tests/test_torch_port_trainers.py::check_epochs (the first validation
  follows an update), and both nets' final state by its parameter rule,
  with three noise runs as above scaled by the forward gap; the port's
  evaluation of the JAX trainer's final weights at rel 1e-5 / 1e-4;
- the port against itself: an interrupted and resumed fit ends bit for bit
  where an uninterrupted one ends; the packed feed's step equals the
  float32 feed's from the unpacked batch.
"""

import contextlib
import re
from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

torch = pytest.importorskip("torch")

from dose_prediction_tpu.core import torch_import as TI  # noqa: E402
from dose_prediction_tpu.models.dosegan import NLayerDiscriminator as JD  # noqa: E402
from dose_prediction_tpu.models.dosegan import UnetGenerator3D as JG  # noqa: E402
from dose_prediction_tpu.train import state as JS  # noqa: E402
from dose_prediction_tpu.train import steps as JSTEP  # noqa: E402
from dose_prediction_tpu.train import trainers as JT  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.core.checkpoint import restore_checkpoint  # noqa: E402
from dose_prediction_tpu_torch.data import packed as PK  # noqa: E402
from dose_prediction_tpu_torch.models import NLayerDiscriminator, UnetGenerator3D  # noqa: E402
from dose_prediction_tpu_torch.nn.layers import BatchNorm3d  # noqa: E402
from dose_prediction_tpu_torch.train import state as S  # noqa: E402
from dose_prediction_tpu_torch.train import steps  # noqa: E402
from dose_prediction_tpu_torch.train import trainers as T  # noqa: E402

import test_torch_port_trainers as TR  # noqa: E402
from test_torch_port_trainers import cohort32, jax_without_native  # noqa: E402,F401
from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_port_zoo_train import initialized  # noqa: E402

SIZE, WIDTH, LR, L1_WEIGHT = 32, 4, 2e-4, 10.0
NOISE_RUNS = 3
# conv biases that feed a train-mode BatchNorm (zero gradient in exact arithmetic)
ZERO_GRAD = re.compile(r"^(g\.initial_block\.0|d\.model\.[06]|.*\.(downsample|pooling)\.0"
                       r"|.*\.intermediate\.1)\.bias$")


def port_nets(device="cpu"):
    return (T.seeded(0, lambda: UnetGenerator3D(ngf=WIDTH, device=device)),
            T.seeded(1, lambda: NLayerDiscriminator(ndf=WIDTH, device=device)))


def jax_nets():
    return JG(out_ch=1, ngf=WIDTH), JD(ndf=WIDTH)


def numpy_state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def to_jax(model, jax_model, in_ch, importer):
    """JAX variables of ``model``'s weights through the JAX importer, and
    its counts."""
    target = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, SIZE, in_ch)), False))
    variables, stats = importer(numpy_state(model), target, verbose=False)
    return jax.tree_util.tree_map(np.asarray, variables), stats


@pytest.fixture(scope="module")
def nets():
    g, d = port_nets()
    jg, jd = jax_nets()
    gv, gstats = to_jax(g, jg, 9, TI.import_dosegan_g)
    dv, dstats = to_jax(d, jd, 1, TI.import_dosegan_d)
    return {"g": (g, jg, gv, gstats), "d": (d, jd, dv, dstats)}


def seeded_batch(seed=0):
    """A float32 NDHWC batch: a 9-channel input, and the dose (in [0, 1],
    zero outside the mask) and possible-dose mask."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, SIZE, SIZE, SIZE, 9)).astype(np.float32)
    mask = (rng.uniform(size=(1, SIZE, SIZE, SIZE, 1)) > 0.3).astype(np.float32)
    dose = rng.uniform(size=mask.shape).astype(np.float32) * mask
    return {"input": x, "gt": np.concatenate([dose, mask], axis=-1)}


def close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) <= rel * float(np.abs(want).max())


def buffers_close(port_sd, want_sd, rel=1e-5):
    """Every BatchNorm buffer of ``port_sd`` against ``want_sd`` by the
    module docstring's rule; returns the worst ratio to its bar."""
    worst = 0.0
    for k, want in want_sd.items():
        if k.endswith("running_mean"):
            var = want_sd[k.replace("running_mean", "running_var")]
            bar = rel * np.maximum(np.abs(want), np.sqrt(np.maximum(var, 0)))
        elif k.endswith("running_var"):
            bar = rel * np.abs(want)
        else:
            continue
        worst = max(worst, float((np.abs(np.asarray(port_sd[k]) - want) / bar).max()))
    return worst


def jax_state_dict(variables, model):
    return {k: v.numpy() for k, v in weights.jax_to_torch(variables, model).items()}


@pytest.mark.parametrize("net", ["g", "d"])
def test_jax_importers_take_the_port_state_dict(nets, net):
    model, _, variables, stats = nets[net]
    assert stats["missing"] == 0 and stats["unused"] == 0
    assert stats["copied"] == stats["inside"] == sum(
        not k.endswith("num_batches_tracked") for k in model.state_dict())
    back = weights.jax_to_torch(variables, model)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("net", ["g", "d"])
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(nets, net, train):
    model, jax_model, variables, _ = nets[net]
    x = seeded_batch(1)["input"][..., :9 if net == "g" else 1]
    twin = port_nets()[0 if net == "g" else 1]
    twin.load_state_dict(model.state_dict())
    want, updated = jax_model.apply(variables, jnp.asarray(x), train=train,
                                    mutable=["batch_stats"])
    with torch.no_grad():
        got = twin.train(train)(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 4, 1, 2, 3))))
    assert close(got.numpy(), np.asarray(want).transpose(0, 4, 1, 2, 3), 1e-3)
    stats = jax_state_dict({"params": variables["params"], "batch_stats": updated["batch_stats"]},
                           twin)
    assert buffers_close(numpy_state(twin), stats) <= 1.0
    if not train:
        assert all(np.array_equal(numpy_state(twin)[k], v) for k, v in numpy_state(model).items())


def recording(tx):
    """``tx`` whose state also keeps the last gradients."""
    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(
        init=lambda params: (jax.tree_util.tree_map(jnp.zeros_like, params), tx.init(params)),
        update=update)


@contextlib.contextmanager
def channel_scaled_noise(seed, amplitude):
    """Each BatchNorm3d output plus amplitude · u · its channel's largest
    |value| (module docstring)."""
    g = torch.Generator().manual_seed(seed)
    forward = BatchNorm3d.forward

    def noisy(self, inp):
        out = forward(self, inp)
        u = torch.rand(out.shape, generator=g) * 2 - 1
        scale = out.detach().abs().amax(dim=(0, 2, 3, 4), keepdim=True)
        return out + (scale * (amplitude * u)).detach()

    with mock.patch.object(BatchNorm3d, "forward", noisy):
        yield


def port_step(batch, packed=False, noise=contextlib.nullcontext()):
    """One port step from the seeded weights: (g_loss, d_loss, {'g.'/'d.'
    name: gradient}, {'g.'/'d.' name: state after})."""
    g, d = port_nets()
    g_opt = S.make_optimizer(g, learning_rate=LR, b1=0.5)
    d_opt = S.make_optimizer(d, learning_rate=LR, b1=0.5)
    step = steps.make_dosegan_train_steps(g, d, g_opt, d_opt, l1_weight=L1_WEIGHT, packed=packed)
    with noise:
        g_state, d_state, info = step(S.TrainState(g, g_opt), S.TrainState(d, d_opt), batch)
    assert g_state.step == d_state.step == 1
    grads = {f"{tag}.{n}": p.grad.detach().clone() for tag, net in (("g", g), ("d", d))
             for n, p in net.named_parameters()}
    after = {f"{tag}.{k}": v for tag, net in (("g", g), ("d", d))
             for k, v in numpy_state(net).items()}
    return float(info["g_loss"]), float(info["d_loss"]), grads, after


@pytest.fixture(scope="module")
def gan_step(nets):
    """One step in each package from the same weights and batch, and the
    port's noise runs."""
    batch = seeded_batch()
    g, jg, gv, _ = nets["g"]
    d, jd, dv, _ = nets["d"]
    g_tx, d_tx = (recording(JS.make_optimizer(learning_rate=LR, b1=0.5)) for _ in range(2))
    jstep = JSTEP.make_dosegan_train_steps(jg, jd, g_tx, d_tx, l1_weight=L1_WEIGHT)
    jg_state, jd_state, info = jstep(JS.create_train_state(gv, g_tx),
                                     JS.create_train_state(dv, d_tx),
                                     {k: jnp.asarray(v) for k, v in batch.items()})
    want_grads, want_after = {}, {}
    for tag, model, st in (("g", g, jg_state), ("d", d, jd_state)):
        np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        grads = weights.jax_to_torch({"params": np_tree(st.opt_state[0]),
                                      "batch_stats": np_tree(st.batch_stats)}, model)
        want_grads.update({f"{tag}.{n}": grads[n] for n, _ in model.named_parameters()})
        want_after.update({f"{tag}.{k}": v for k, v in jax_state_dict(
            {"params": np_tree(st.params), "batch_stats": np_tree(st.batch_stats)},
            model).items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    port = port_step(tbatch)
    noisy = [port_step(tbatch, noise=channel_scaled_noise(seed, 1e-6))[2]
             for seed in range(NOISE_RUNS)]
    return port, (float(info["g_loss"]), float(info["d_loss"]), want_grads, want_after), noisy


@pytest.mark.parametrize("loss", ["g_loss", "d_loss"])
def test_step_losses_match_jax(gan_step, loss):
    port, want, _ = gan_step
    i = ("g_loss", "d_loss").index(loss)
    print(f"{loss}: port {port[i]!r} jax {want[i]!r}")
    assert abs(port[i] - want[i]) <= 1e-5 * abs(want[i])


@pytest.mark.parametrize("net", ["g", "d"])
def test_step_gradients_match_jax_leaf_by_leaf(gan_step, net):
    (_, _, grads, _), (_, _, want, _), noisy = gan_step
    names = [n for n in grads if n.startswith(f"{net}.")]
    zero = [n for n in names if ZERO_GRAD.search(n)]
    leaves = [n for n in names if n not in zero]
    g_max = max(float(want[n].abs().max()) for n in names)
    scale = {n: float(want[n].abs().max()) for n in leaves}
    noise = {n: max(float((run[n] - grads[n]).abs().max()) for run in noisy) / scale[n]
             for n in leaves}
    rel = {n: float((grads[n] - want[n]).abs().max()) / scale[n] for n in leaves}
    limit = {n: max(max(1e-3, 2 * noise[n]) * scale[n], 2e-6 * g_max) for n in leaves}
    ratio = {n: rel[n] * scale[n] / limit[n] for n in leaves}
    worst = max(ratio, key=ratio.get)
    print(f"{net}: worst leaf err / its max|g| {max(rel.values()):.3g}; worst err / its limit "
          f"{ratio[worst]:.3g} ({worst}); {sum(r > 1e-3 for r in rel.values())} of "
          f"{len(leaves)} over 1e-3; {len(zero)} zero-gradient biases")
    assert len(leaves) > 20 and zero
    assert all(ratio[n] <= 1.0 for n in leaves), [n for n in leaves if ratio[n] > 1.0][:5]
    for n in zero:
        assert max(float(grads[n].abs().max()), float(want[n].abs().max())) <= 1e-4 * g_max, n


@pytest.mark.parametrize("net", ["g", "d"])
def test_step_batchnorm_buffers_match_jax(gan_step, net):
    """The critic's statistics updated twice (real, then fake) and the
    generator's once: the throw-away updates of the step are thrown away."""
    (_, _, _, after), (_, _, _, want), _ = gan_step
    keys = [k for k in want if k.startswith(f"{net}.")]
    assert buffers_close(after, {k: want[k] for k in keys}) <= 1.0
    tracked = {k: int(v) for k, v in after.items()
               if k.startswith(f"{net}.") and k.endswith("num_batches_tracked")}
    assert set(tracked.values()) == {1 if net == "g" else 2}


def test_packed_step_equals_the_unpacked_step(cohort32):  # noqa: F811
    ds, _ = cohort32
    packed = next(iter(PK.packed_dose_batches(ds, seed=0)))
    unpacked = PK.unpack_dose_batch(packed)
    a, b = port_step(packed, packed=True), port_step(unpacked)
    assert a[:2] == b[:2]
    assert all(torch.equal(a[2][n], b[2][n]) for n in a[2])
    assert all(np.array_equal(a[3][k], b[3][k]) for k in a[3])


# -- the trainer --------------------------------------------------------------

def both_state(trainer):
    return {f"{tag}.{k}": v for tag, net in (("g", trainer.gen), ("d", trainer.disc))
            for k, v in numpy_state(net).items()}


def jax_both_state(jtr, trainer):
    return {f"{tag}.{k}": v for tag, st, net in (("g", jtr.g_state, trainer.gen),
                                                 ("d", jtr.d_state, trainer.disc))
            for k, v in jax_state_dict(TR.variables_of(st), net).items()}


def one_step_epochs(tmp_path, tag):
    """TR.configs with two epochs of one step, validated after each."""
    return TR.configs(tmp_path, tag, samples_per_epoch=1)


def test_dosegan_trainer_matches_jax(tmp_path, nets, cohort32):  # noqa: F811
    ds, jds = cohort32
    jcfg, cfg = one_step_epochs(tmp_path, "gan")
    (_, _, gv, _), (_, _, dv, _) = nets["g"], nets["d"]
    with mock.patch.object(JT, "UnetGenerator3D", lambda out_ch, ngf: initialized(
            JG, gv, out_ch=out_ch, ngf=ngf)), \
            mock.patch.object(JT, "NLayerDiscriminator", lambda ndf: initialized(
                JD, dv, ndf=ndf)):
        jtr = JT.DoseGANTrainer(jcfg, ngf=WIDTH, ndf=WIDTH, example_shape=TR.SHAPE32)

    def make(tag):
        g, d = port_nets()
        return T.DoseGANTrainer(one_step_epochs(tmp_path, tag)[1], generator=g,
                                discriminator=d, example_shape=TR.SHAPE32)

    tr = make("gan")
    init = both_state(tr)
    assert all(np.array_equal(init[k], v) for k, v in jax_both_state(jtr, tr).items())
    batch = next(TR.jax_val_batches(jds))
    amplitude = TR.noise_amplitude(
        tr.eval_step({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        ["prediction"], jtr.eval_step(jtr.g_state.params, jtr.g_state.batch_stats, batch)[2])
    keys = ("mean_dose_score", "val_loss")
    TR.assert_close_dict(tr.validate(ds), jtr.validate(jds), keys, TR.REL_EPOCH)
    scores = ("mean_dose_score", "mean_dvh_score")
    TR.assert_close_dict(tr.test(ds), jtr.test(jds), scores, TR.REL_TEST)
    jtr.fit(jds, jds, resume=False)
    tr.fit(ds, ds, resume=False)
    assert tr.g_state.step == tr.d_state.step == int(jtr.g_state.step) == 2
    runs = []
    for seed in range(NOISE_RUNS):
        twin = make(f"noise{seed}")
        with channel_scaled_noise(seed, amplitude):
            twin.fit(ds, ds, resume=False)
        runs.append((both_state(twin), TR.records(twin.cfg.log_dir)))
    port, ref = TR.records(cfg.log_dir), TR.records(jcfg.log_dir)
    for key in ("disc_loss", "gan_loss"):
        TR.check_epochs(port, ref, runs, key, ())
    for key in keys:
        TR.check_epochs(port, ref, runs, key, (), strict_first=False)
    TR.assert_params_by_noise_rule(init, both_state(tr), [r for r, _ in runs],
                                   jax_both_state(jtr, tr), ZERO_GRAD, LR, 2)
    tr.gen.load_state_dict(weights.jax_to_torch(TR.variables_of(jtr.g_state), tr.gen))
    TR.assert_close_dict(tr.validate(ds), {k: ref[k][-1] for k in keys}, keys, TR.REL_EPOCH)
    TR.assert_close_dict(tr.test(ds), jtr.test(jds), scores, TR.REL_TEST)
    # the device half scores the predictions as the host half does
    host, on_device = tr.test(ds), tr.test(ds, device_metrics=True)
    assert TR.rel_close(on_device["mean_dose_score"], host["mean_dose_score"], 1e-4)


def test_interrupted_fit_resumes_bit_for_bit(tmp_path, cohort32):  # noqa: F811
    ds, _ = cohort32

    def trainer(tag, **kw):
        g, d = port_nets()
        cfg = T.TrainConfig(max_epochs=3, check_val=1, samples_per_epoch=1, device="cpu",
                            feed_dtype="packed", ckpt_dir=str(tmp_path / tag),
                            log_dir=str(tmp_path / f"{tag}_log"), **kw)
        return T.DoseGANTrainer(cfg, generator=g, discriminator=d, example_shape=TR.SHAPE32)

    whole = trainer("w")
    whole.fit(ds, ds)
    first = trainer("r", max_steps=2)
    first.fit(ds, ds)
    assert first.g_state.step == first.d_state.step == 2
    slot = restore_checkpoint(tmp_path / "r" / "last.pt")
    assert set(slot) == {"g", "d", "epoch"} and slot["epoch"] == 1
    resumed = trainer("r")
    with torch.no_grad():                      # the slot, not these weights, must count
        for p in resumed.gen.parameters():
            p.add_(1.0)
    resumed.fit(ds, ds)
    assert resumed.g_state.step == whole.g_state.step == 3
    assert resumed.d_state.moving_loss == whole.d_state.moving_loss
    a, b = both_state(resumed), both_state(whole)
    assert all(np.array_equal(a[k], b[k]) for k in b)
    assert TR.records(tmp_path / "r_log")["gan_loss"] == TR.records(tmp_path / "w_log")["gan_loss"]
    assert resumed.ckpt.best_step() == whole.ckpt.best_step()


def test_resume_guard_refuses_another_width(tmp_path, cohort32):  # noqa: F811
    ds, _ = cohort32
    cfg = T.TrainConfig(max_epochs=1, check_val=5, samples_per_epoch=1, device="cpu",
                        ckpt_dir=str(tmp_path / "g"), log_dir=str(tmp_path / "gl"))
    T.DoseGANTrainer(cfg, ngf=WIDTH, ndf=WIDTH, example_shape=TR.SHAPE32).fit(ds)
    wider = T.DoseGANTrainer(T.TrainConfig(**{**cfg.__dict__, "max_epochs": 2}), ngf=WIDTH,
                             ndf=2 * WIDTH, example_shape=TR.SHAPE32)
    with pytest.raises(RuntimeError, match="ndf"):
        wider.fit(ds)


def test_mesh_shape_is_refused():
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        T.DoseGANTrainer(T.TrainConfig(mesh_shape={"data": 2}, device="cpu"), ngf=WIDTH,
                         ndf=WIDTH, example_shape=TR.SHAPE32)
