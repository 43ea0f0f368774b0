"""The port's packed feed into its train steps (train/steps.py, ``packed=True``)
against the JAX package's packed steps on the CPU.

A synthetic cohort of two 32³ patients, written by the port's
``make_synthetic_dataset`` and loaded by each package; each package builds
its own packed batch from one seed (bit-identical: tests/
test_torch_port_data_feed.py), with a seed whose sample is flipped and
rotated. The reduced models of tests/test_torch_port_models.py carry the
port's seeded weights into JAX (core/torch_import.py), and the JAX gradients
come back through weights.jax_to_torch. The JAX side runs its real packed
step (``make_pyfer_train_step`` / ``make_cascade_c3d_train_step`` with
``packed=True``) with an optax transformation that keeps the gradients as
its state and moves no parameter.

Bars, float32: the loss to a relative 1e-5, BatchNorm statistics 1e-5
(tests/test_torch_port_train.py), and each gradient leaf by the noise-run
rule of tests/test_torch_port_train_c3d.py and chip_smoke.py's train_parity:
within max(1e-3, 2 × noise) × its own max |g|, with a floor of 2e-6 × the
largest |g|, where ``noise`` is the worst leaf-relative move of the port's
own step when each InstanceNorm output carries a seeded relative noise of
1e-6. On this cohort's input (binary masks, a dose that is zero outside its
mask) the DOSE-PYFER step is as ill-conditioned as the C3D cascade: the
noise run moves its worst leaves by over ten times 1e-3 of their scale,
about as far as the two packages differ there (``-s`` prints both), where
on the random input of tests/test_torch_port_train.py both stay under
1e-3. The conv biases that feed a norm must be noise below 1e-5
(DOSE-PYFER) and 1e-4 (C3D) of the largest |g| in both packages. The packed
step's loss against the float32 feed's from the same seed and weights:
2e-3, the bar of tests/test_packed_feed.py. With
``dtype=torch.bfloat16`` the packed step's model computes in bf16: its loss
equals, bit for bit, the plain step fed the unpacked input cast to bf16.
"""

from unittest import mock

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dose_prediction_tpu.core import torch_import as TI  # noqa: E402
from dose_prediction_tpu.data import native as JN  # noqa: E402
from dose_prediction_tpu.data import openkbp as JO  # noqa: E402
from dose_prediction_tpu.data import packed as JPK  # noqa: E402
from dose_prediction_tpu.train import state as JS  # noqa: E402
from dose_prediction_tpu.train import steps as JSTEP  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.data import openkbp as O  # noqa: E402
from dose_prediction_tpu_torch.data import packed as PK  # noqa: E402
from dose_prediction_tpu_torch.data import pipeline as PL  # noqa: E402
from dose_prediction_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from dose_prediction_tpu_torch.nn.layers import InstanceNorm3d  # noqa: E402
from dose_prediction_tpu_torch.train import losses as L  # noqa: E402
from dose_prediction_tpu_torch.train import state as S  # noqa: E402
from dose_prediction_tpu_torch.train import steps  # noqa: E402

import test_torch_port_models as M  # noqa: E402  (seeded reduced models, JAX import)
import test_torch_port_train as TT  # noqa: E402  (the DOSE-PYFER step's bars)
import test_torch_port_train_c3d as TC  # noqa: E402  (the C3D step's bars, noise run)

SIZE = M.SIZE


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """(port dataset, JAX dataset, seed): the seed's first packed sample is
    flipped and rotated."""
    pattern = make_synthetic_dataset(tmp_path_factory.mktemp("packed_step"), n_patients=2,
                                     shape=(SIZE, SIZE, SIZE), seed=21)
    with mock.patch.object(JN, "get_lib", lambda: None):   # JAX reader: numpy path
        jax_ds = JO.OpenKBPDataset(pattern, num_workers=1)
    port_ds = O.OpenKBPDataset(pattern, num_workers=1)
    seed = next(s for s in range(200)
                if (lambda b: int(b["rot_k"][0]) and int(b["flip"][0]) and float(b["shift"][0]))(
                    next(iter(PK.packed_dose_batches(port_ds, seed=s)))))
    return port_ds, jax_ds, seed


def batches(cohort):
    """The port's and the JAX package's first packed batch of the seed."""
    port_ds, jax_ds, seed = cohort
    pb = next(iter(PK.packed_dose_batches(port_ds, seed=seed)))
    jb = next(iter(JPK.packed_dose_batches(jax_ds, seed=seed)))
    return pb, {k: jnp.asarray(v) for k, v in jb.items()}


def keep_gradients():
    """An optax transformation whose state is the last gradients and whose
    updates are zero."""
    return optax.GradientTransformation(
        init=lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        update=lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


def pyfer_noise_run(x: torch.Tensor, gt: torch.Tensor):
    """The port's DOSE-PYFER gradients from the same weights, each
    InstanceNorm output multiplied by 1 + 1e-6·u (u uniform in [-1, 1],
    seeded, kept out of the gradient)."""
    g = torch.Generator().manual_seed(0)
    forward = InstanceNorm3d.forward

    def noisy(self, inp):
        out = forward(self, inp)
        u = torch.rand(out.shape, generator=g) * 2 - 1
        return out + (out * (1e-6 * u)).detach()

    twin = M.port_dose().train()
    with mock.patch.object(InstanceNorm3d, "forward", noisy):
        preds = twin(steps.to_ncdhw(x), stop_gradient_a=True)
        L.gen_loss(preds, steps.to_ncdhw(gt), delta1=10.0, delta2=8.0, cascade=True,
                   freeze=True).backward()
    return {n: p.grad for n, p in twin.named_parameters() if p.grad is not None}


def assert_leaves_by_noise_rule(grads, want, noisy, zero, zero_bar):
    """Every leaf of ``grads`` against ``want`` by the noise-run rule (module
    docstring); the leaves in ``zero`` are noise below ``zero_bar`` × the
    largest |g| in both."""
    g_max = max(float(np.abs(want[n].numpy()).max()) for n in grads)
    leaves = [n for n in grads if n not in zero]
    scale = {n: float(np.abs(want[n].numpy()).max()) for n in leaves}
    noise = max(float((noisy[n] - grads[n]).abs().max()) / scale[n] for n in leaves)
    rel = {n: float(np.abs(grads[n].numpy() - want[n].numpy()).max()) / scale[n] for n in leaves}
    print(f"worst leaf err / its max|g| {max(rel.values()):.3g}, noise run {noise:.3g}; "
          f"{sum(r > 1e-3 for r in rel.values())} of {len(leaves)} leaves over 1e-3")
    for name in leaves:
        err = float(np.abs(grads[name].numpy() - want[name].numpy()).max())
        assert err <= max(max(1e-3, 2 * noise) * scale[name], 2e-6 * g_max), (name, err, noise)
    for name in zero:
        got, ref = grads[name].numpy(), want[name].numpy()
        assert max(np.abs(got).max(), np.abs(ref).max()) <= zero_bar * g_max, name
    assert len(leaves) > 100


@pytest.fixture(scope="module")
def pyfer_step(cohort):
    pb, jb = batches(cohort)
    model = M.port_dose()
    variables, _ = M.to_jax(model, M.jax_dose(), TI.import_pyfer, (1, SIZE, SIZE, SIZE, 9))
    jstep = JSTEP.make_pyfer_train_step(M.jax_dose(), keep_gradients(), delta1=10.0,
                                        delta2=8.0, freeze=True, donate=False, packed=True)
    jstate, jloss = jstep(JS.create_train_state(variables, keep_gradients()), jb)
    want = weights.jax_to_torch(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.opt_state, "batch_stats": jstate.batch_stats}), model)
    opt = S.make_optimizer(model, learning_rate=TT.LR, weight_decay=TT.WD,
                           freeze_labels=S.cascade_freeze_labels(model))
    step = steps.make_pyfer_train_step(model, opt, delta1=10.0, delta2=8.0, freeze=True,
                                       packed=True)
    state, loss = step(S.TrainState(model, opt), pb)
    unpacked = PK.unpack_dose_batch(pb)
    return dict(model=model, state=state, loss=float(loss), jloss=float(jloss), want=want,
                noisy=pyfer_noise_run(unpacked["input"], unpacked["gt"]))


def test_packed_pyfer_step_loss_matches_jax(pyfer_step):
    assert np.isfinite(pyfer_step["loss"]) and pyfer_step["state"].step == 1
    assert abs(pyfer_step["loss"] - pyfer_step["jloss"]) <= 1e-5 * abs(pyfer_step["jloss"])


def test_packed_pyfer_step_gradients_match_jax_leaf_by_leaf(pyfer_step):
    model, want = pyfer_step["model"], pyfer_step["want"]
    grads = {n: p.grad for n, p in model.named_parameters()
             if not n.startswith(("net_A.", "conv_out_A."))}
    for name, p in model.named_parameters():
        if name.startswith(("net_A.", "conv_out_A.")):
            assert p.grad is None and not np.any(want[name].numpy()), name
    zero = [n for n in grads if TT.ZERO_GRAD_BIAS.search(n)]
    assert len(zero) == 4 * 5
    assert_leaves_by_noise_rule(grads, want, pyfer_step["noisy"], zero, 1e-5)
    checked = 0
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=0, atol=TT.TOL,
                                       err_msg=name)
            checked += 1
    assert checked == 4 * 2 * 2


def test_packed_c3d_step_matches_jax(cohort):
    """One C3D cascade step on the packed feed: the loss, and every leaf by
    the noise-run rule of tests/test_torch_port_train_c3d.py."""
    pb, jb = batches(cohort)
    model = TC.port_c3d(seed=1)
    params, _ = TC.import_params(model)
    jstep = JSTEP.make_cascade_c3d_train_step(TC.jax_c3d(), keep_gradients(), packed=True)
    jstate, jloss = jstep(JS.create_train_state({"params": params}, keep_gradients()), jb)
    want = weights.jax_to_torch(
        {"params": jax.tree_util.tree_map(np.asarray, jstate.opt_state)}, model)
    opt = S.make_split_lr_optimizer(model, lr_encoder=S.cosine_schedule(1e-3, 10),
                                    lr_decoder=2e-3, weight_decay=TC.WD)
    state, loss = steps.make_cascade_c3d_train_step(model, opt, packed=True)(
        S.TrainState(model, opt), pb)
    assert state.step == 1 and abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    unpacked = PK.unpack_dose_batch(pb)
    noisy = TC.noise_run_gradients(model, params, unpacked["input"].numpy(),
                                   unpacked["gt"].numpy(), False)
    zero = [n for n in grads if TC.ZERO_GRAD_BIAS.search(n)]
    assert len(zero) == 2 * (10 + 11)
    assert_leaves_by_noise_rule(grads, want, noisy, zero, 1e-4)


@pytest.mark.parametrize("kind", ["pyfer", "c3d"])
def test_packed_loss_matches_the_float32_feed(cohort, kind):
    """The packed step and the float32-feed step from one seed and the same
    weights: the same augmentation, the losses within bf16 feed resolution."""
    port_ds, _, seed = cohort
    losses = []
    for packed in (False, True):
        model = M.port_dose() if kind == "pyfer" else TC.port_c3d(seed=1)
        opt = S.make_optimizer(model, learning_rate=1e-3)
        make = steps.make_pyfer_train_step if kind == "pyfer" else \
            steps.make_cascade_c3d_train_step
        feed = PK.packed_dose_batches if packed else PL.dose_batches
        _, loss = make(model, opt, packed=packed)(S.TrainState(model, opt),
                                                  next(iter(feed(port_ds, seed=seed))))
        losses.append(float(loss))
    assert abs(losses[0] - losses[1]) <= 2e-3, losses


def test_packed_step_computes_in_its_dtype(cohort):
    """``dtype=torch.bfloat16``: unpacked in float32, cast once, the model in
    bf16; bit for bit the plain step on the unpacked input cast by hand, and
    not the float32 loss."""
    port_ds, _, seed = cohort
    pb = next(iter(PK.packed_dose_batches(port_ds, seed=seed)))
    unpacked = PK.unpack_dose_batch(pb)
    losses = {}
    for name, kwargs, batch in (
            ("packed_bf16", dict(packed=True, dtype=torch.bfloat16), pb),
            ("by_hand", {}, {"input": unpacked["input"].to(torch.bfloat16),
                             "gt": unpacked["gt"]}),
            ("packed_f32", dict(packed=True), pb)):
        model = TC.port_c3d(seed=1)
        opt = S.make_optimizer(model, learning_rate=1e-3)
        _, loss = steps.make_cascade_c3d_train_step(model, opt, **kwargs)(
            S.TrainState(model, opt), batch)
        losses[name] = float(loss)
    assert losses["packed_bf16"] == losses["by_hand"] != losses["packed_f32"]
