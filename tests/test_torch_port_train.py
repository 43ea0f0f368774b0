"""The PyTorch port's DOSE-PYFER training (train/{losses,state,steps}.py,
ops.downsample_pyramid) against the JAX package on the CPU.

Reduced configuration of tests/test_torch_port_models.py (LIST_CH
(-1, 2, 4, 8, 16, 32), 32³, a 4-layer ViT-24): the port's seeded weights go
into the JAX model through core/torch_import.import_pyfer, and the JAX
gradients come back through weights.jax_to_torch. Inputs are made with numpy
from a seed; float32. Tolerances: losses and pyramids 1e-5 (one op order
apart); one train step's loss to a relative 1e-5 and each gradient leaf to
a max abs of 1e-3 × that leaf's max |g| (the 1e-3 bar of
test_golden_pyfer.py, relative to the leaf's scale; two floors, stated at
the test); BatchNorm statistics
1e-5; optimizer updates on fixed gradients 1e-6.
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu.core import torch_import as TI  # noqa: E402
from dose_prediction_tpu.ops.resize import downsample_pyramid as j_pyramid  # noqa: E402
from dose_prediction_tpu.train import losses as JL  # noqa: E402
from dose_prediction_tpu.train import state as JS  # noqa: E402
from dose_prediction_tpu.train import steps as JSTEP  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.ops import downsample_pyramid  # noqa: E402
from dose_prediction_tpu_torch.train import losses as L  # noqa: E402
from dose_prediction_tpu_torch.train import state as S  # noqa: E402
from dose_prediction_tpu_torch.train import steps  # noqa: E402

import test_torch_port_models as M  # noqa: E402  (seeded reduced models, JAX import)

SIZE = M.SIZE
LR, WD = 6.130697604327541e-4, 1.6303111017674179e-4   # train/trainers.py:56-57
TOL = 1e-5
# conv biases of the Conv31 blocks that feed a norm: k3 and k7 branch convs, fuse conv
ZERO_GRAD_BIAS = re.compile(r"conv_block\.cov_\.(conv_[37]\.0\.conv\.[03]|conv\.0)\.bias$")


def ncdhw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 4, 1, 2, 3)))


def batch(seed=0, size=SIZE):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, size, size, size, 9)).astype(np.float32)
    dose = rng.random((1, size, size, size, 1)).astype(np.float32)
    mask = (rng.random((1, size, size, size, 1)) < 0.6).astype(np.float32)
    return x, np.concatenate([dose, mask], axis=-1)


def test_downsample_pyramid_matches_jax(rng):
    vol = rng.random((1, 16, 24, 32, 1)).astype(np.float32)
    mask = (rng.random((1, 16, 24, 32, 1)) < 0.5).astype(np.float32)
    jv, jm = j_pyramid(jnp.asarray(vol), jnp.asarray(mask))
    tv, tm = downsample_pyramid(ncdhw(vol), ncdhw(mask))
    assert len(tv) == len(jv) == 3
    for a, b in zip(tv + tm, jv + jm):
        np.testing.assert_allclose(a.numpy().transpose(0, 2, 3, 4, 1), np.asarray(b),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("kwargs", [dict(cascade=True, freeze=True, delta2=8.0),
                                    dict(cascade=True, freeze=False, delta2=8.0),
                                    dict(cascade=False, huber=True),
                                    dict(mode="val", huber=True)])
def test_gen_loss_matches_jax(rng, kwargs):
    n, s = 2, 16
    gt = np.concatenate([rng.random((n, s, s, s, 1)),
                         (rng.random((n, s, s, s, 1)) < 0.6)], axis=-1).astype(np.float32)
    preds = [rng.standard_normal((n, s >> i, s >> i, s >> i, 1)).astype(np.float32)
             for i in range(4)]
    pred_a = rng.standard_normal((n, s, s, s, 1)).astype(np.float32)
    if kwargs.get("mode") == "val":
        jp, tp = jnp.asarray(preds[0]), ncdhw(preds[0])
    elif kwargs.get("cascade"):
        jp = (jnp.asarray(pred_a), [jnp.asarray(p) for p in preds])
        tp = (ncdhw(pred_a), [ncdhw(p) for p in preds])
    else:
        jp, tp = [jnp.asarray(p) for p in preds], [ncdhw(p) for p in preds]
    want = float(JL.gen_loss(jp, jnp.asarray(gt), **kwargs))
    got = L.gen_loss(tp, ncdhw(gt), **kwargs)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= TOL * max(1.0, abs(want))
    want_c = float(JL.cascade_l1_loss(jnp.asarray(pred_a), jnp.asarray(preds[0]),
                                      jnp.asarray(gt), freeze=False))
    got_c = float(L.cascade_l1_loss(ncdhw(pred_a), ncdhw(preds[0]), ncdhw(gt), freeze=False))
    assert abs(got_c - want_c) <= TOL


@pytest.fixture(scope="module")
def one_step():
    """One port train step and the JAX loss, gradients and BatchNorm
    statistics of the same step, from the same weights and batch."""
    model = M.port_dose()
    variables, _ = M.to_jax(model, M.jax_dose(), TI.import_pyfer, (1, SIZE, SIZE, SIZE, 9))
    x, gt = batch()
    jm = M.jax_dose()

    def loss_fn(params, batch_stats, x, gt):       # train/steps.py:61-67
        (pred_a, preds_b), updates = jm.apply(
            {"params": params, "batch_stats": batch_stats}, x, train=True,
            mutable=["batch_stats"], stop_gradient_a=True)
        loss = JL.gen_loss((pred_a, preds_b), gt, delta1=10.0, delta2=8.0, cascade=True,
                           freeze=True)
        return loss, updates["batch_stats"]

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], x, gt)
    want = weights.jax_to_torch(
        jax.tree_util.tree_map(np.asarray, {"params": jgrads, "batch_stats": jstats}), model)

    opt = S.make_optimizer(model, learning_rate=LR, weight_decay=WD,
                           freeze_labels=S.cascade_freeze_labels(model))
    step = steps.make_pyfer_train_step(model, opt, delta1=10.0, delta2=8.0, freeze=True)
    state, loss = step(S.TrainState(model, opt), {"input": torch.from_numpy(x),
                                                  "gt": torch.from_numpy(gt)})
    return dict(model=model, state=state, loss=float(loss), jloss=float(jloss), want=want)


def test_train_step_loss_matches_jax(one_step):
    assert np.isfinite(one_step["loss"])
    assert abs(one_step["loss"] - one_step["jloss"]) <= 1e-5 * abs(one_step["jloss"])
    assert one_step["state"].step == 1 and one_step["state"].moving_loss == one_step["loss"]


def test_train_step_gradients_match_jax_leaf_by_leaf(one_step):
    """Each trainable leaf within 1e-3 × its own max |g|, with a floor of
    2e-6 × the model's largest |g|: a leaf whose gradient cancels to far
    below the others (a BatchNorm scale, 1e-3 of the largest) keeps the
    float32 noise of the per-voxel gradients summed over the volume
    (measured up to 8.3e-7 of the largest). Conv biases that feed an
    InstanceNorm or a train-mode BatchNorm have a zero gradient in exact
    arithmetic (the norm subtracts the channel mean): both packages must
    give noise below 1e-5 of the largest there."""
    model, want = one_step["model"], one_step["want"]
    trainable = [(n, p) for n, p in model.named_parameters()
                 if not n.startswith(("net_A.", "conv_out_A."))]
    g_max = max(float(np.abs(want[n].numpy()).max()) for n, _ in trainable)
    for name, p in model.named_parameters():
        if name.startswith(("net_A.", "conv_out_A.")):
            # frozen: no gradient in the port, a stopped one in JAX
            assert p.grad is None and not p.requires_grad, name
            assert not np.any(want[name].numpy()), name
    zero = [n for n, _ in trainable if ZERO_GRAD_BIAS.search(n)]
    assert len(zero) == 4 * 5                # 4 decoders × 5 convs that feed a norm
    for name, p in trainable:
        got, ref = p.grad.numpy(), want[name].numpy()
        if name in zero:
            assert np.abs(got).max() <= 1e-5 * g_max and np.abs(ref).max() <= 1e-5 * g_max, name
            continue
        err = float(np.abs(got - ref).max())
        bound = max(1e-3 * float(np.abs(ref).max()), 2e-6 * g_max)
        assert err <= bound, f"{name}: max abs err {err} > {bound}"
    assert len(trainable) > 100


def test_train_step_batch_norm_statistics_match_jax(one_step):
    checked = 0
    for name, buf in one_step["model"].named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), one_step["want"][name].numpy(),
                                       rtol=0, atol=TOL, err_msg=name)
            checked += 1
    assert checked == 4 * 2 * 2          # 4 decoders × 2 BatchNorms × (mean, var)


class _Toy(torch.nn.Module):
    """Parameter names under net_A, conv_out_A and net_B, as in DOSE-PYFER."""

    def __init__(self):
        super().__init__()
        self.net_A = torch.nn.Linear(3, 4)
        self.conv_out_A = torch.nn.Linear(4, 1)
        self.net_B = torch.nn.Sequential(torch.nn.Linear(5, 6), torch.nn.Linear(6, 2))


def _tree(named):
    tree = {}
    for name, value in named:
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(value)
    return tree


@pytest.mark.parametrize("kind,wd,clip,labelled", [
    pytest.param("adamw", WD, 0.5, True, id=f"adamw-{WD}-0.5"),
    pytest.param("adamw", WD, 100.0, True, id=f"adamw-{WD}-100.0"),
    pytest.param("adam", 0.0, None, True, id="adam-0.0-None"),
    pytest.param("adamw", 0.01, 0.5, False, id="adamw-0.01-0.5-no-labels-grad-less-leaves")])
def test_optimizer_update_matches_optax(kind, wd, clip, labelled):
    """Three updates on fixed gradients; clip 0.5 clips every step, 100 none.
    With freeze labels, the frozen leaves (net_A, conv_out_A) stay put in
    both. Without them, net_A and conv_out_A get no gradient (``grad=None``)
    in steps 1 and 3 and zeros go to optax there: both decay the leaves,
    and the bias corrections follow one step count."""
    rng = np.random.default_rng(7)
    model = _Toy()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    params = _tree((n, p.detach().numpy().copy()) for n, p in model.named_parameters())
    tx = JS.make_optimizer(learning_rate=0.05, weight_decay=wd, grad_clip_norm=clip,
                           freeze_labels=JS.cascade_freeze_labels(params) if labelled else None)
    opt_state = tx.init(params)
    opt = S.make_optimizer(model, learning_rate=0.05, weight_decay=wd, grad_clip_norm=clip,
                           freeze_labels=S.cascade_freeze_labels(model) if labelled else None,
                           kind=kind)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i in range(3):
        grads = {n: rng.standard_normal(p.shape).astype(np.float32)
                 for n, p in model.named_parameters()}
        gradless = {n for n in grads if not labelled and i != 1
                    and n.split(".")[0] in ("net_A", "conv_out_A")}
        for n in gradless:
            grads[n] = np.zeros_like(grads[n])
        updates, opt_state = tx.update(_tree(grads.items()), opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for n, p in model.named_parameters():
            p.grad = (torch.from_numpy(grads[n]) if p.requires_grad and n not in gradless
                      else None)
        opt.step()
    flat = {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), flat[n], rtol=0, atol=1e-6, err_msg=n)
    if labelled:
        assert not model.net_A.weight.requires_grad and model.net_B[0].weight.requires_grad
        assert torch.equal(model.net_A.weight, start["net_A.weight"])
    else:
        assert all(p.requires_grad for p in model.parameters())


def test_three_steps_lower_the_loss():
    model = M.port_dose(seed=2)
    opt = S.make_optimizer(model, learning_rate=LR, weight_decay=WD,
                           freeze_labels=S.cascade_freeze_labels(model))
    step = steps.make_pyfer_train_step(model, opt)
    x, gt = batch(seed=1)
    b = {"input": torch.from_numpy(x), "gt": torch.from_numpy(gt)}
    state, losses = S.TrainState(model, opt), []
    for _ in range(3):
        state, loss = step(state, b)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[2] < losses[1] < losses[0]
    assert state.step == 3


def test_eval_step_matches_jax(one_step):
    """make_pyfer_eval_step against the JAX eval step on the trained model:
    val loss, dose score and the post-processed prediction (to the models'
    1e-3, ×70 for Gy)."""
    model = one_step["model"]
    variables, _ = M.to_jax(model, M.jax_dose(), TI.import_pyfer, (1, SIZE, SIZE, SIZE, 9))
    x, gt = batch(seed=3)
    jstate = JS.TrainState(step=0, params=variables["params"],
                           batch_stats=variables["batch_stats"], opt_state=None,
                           moving_loss=0.0)
    want = JSTEP.make_pyfer_eval_step(M.jax_dose())(jstate, {"input": x, "gt": gt})
    got = steps.make_pyfer_eval_step(model)({"input": torch.from_numpy(x),
                                             "gt": torch.from_numpy(gt)})
    assert abs(float(got["val_loss"]) - float(want["val_loss"])) <= 1e-4
    assert abs(float(got["dose_score"]) - float(want["dose_score"])) <= 70 * 1e-4
    np.testing.assert_allclose(got["prediction"].numpy(), np.asarray(want["prediction"]),
                               rtol=0, atol=70 * 1e-3)
