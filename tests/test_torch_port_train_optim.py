"""The PyTorch port's optimizer family (train/state.py, train/adam8bit.py)
against the JAX package's optax optimizers on the CPU.

Fixed numpy-seeded gradients go to both optimizers from the same
parameters; float32. Tolerances:

- Adam, AdamW, the split learning rate, ``grad_accum`` and the plateau
  optimizer: parameters within 1e-6 absolute after the last update, the
  bar of tests/test_torch_port_train.py's optax test (parameters of order
  1, updates of order lr; the packages differ in reduction order only, in
  the clip's norm);
- schedules: multistep equal to float32 (both multiply a float32 rate by a
  float32 gamma); cosine within ½(base − eta_min) · ulp(cos) + ulp(rate):
  one float32 ulp of the cosine carried through ``1 + cos``, plus the
  rate's own rounding (the port's cos is correctly rounded; XLA's may be a
  last bit off);
- ``grad_accum``: parameters between emits equal, bit for bit, to those
  before (MultiSteps emits zeros, and p + 0 is p);
- adam8bit: parameters within 1e-6 absolute after 5 updates; the int8 and
  uint8 codes may differ only where a value lies within float32 error of a
  rounding boundary (a float32 log or exp a last bit apart): at most one
  code in 1000, each by one step; scales and log bounds within a relative
  1e-6; ``state_nbytes`` equal.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

torch = pytest.importorskip("torch")

from dose_prediction_tpu.core import torch_import as TI  # noqa: E402
from dose_prediction_tpu.train import state as JS  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.train import state as S  # noqa: E402

import test_torch_port_models as M  # noqa: E402  (seeded reduced models, JAX import)
from test_torch_port_train import _Toy, _tree  # noqa: E402  (DOSE-PYFER's names)

JA = importlib.import_module("dose_prediction_tpu.train.adam8bit")
A8 = importlib.import_module("dose_prediction_tpu_torch.train.adam8bit")

LR, WD = 6.130697604327541e-4, 1.6303111017674179e-4   # train/trainers.py:56-57
TOL = 1e-6


def _flat(tree):
    return {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def seeded(model, rng):
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    return model


def run_both(model, tx, opt, rng, calls, gradless=lambda i, n: False, scale=1.0,
             after_call=None):
    """``calls`` updates of ``tx`` (optax) and ``opt`` (the port) on the same
    numpy-seeded gradients; a leaf for which ``gradless(call, name)`` holds
    gets no ``.grad`` in the port and zeros in optax. Returns the optax
    parameters by name."""
    params = _tree((n, p.detach().numpy().copy()) for n, p in model.named_parameters())
    opt_state = tx.init(params)
    for i in range(calls):
        grads = {n: (scale * rng.standard_normal(p.shape)).astype(np.float32)
                 for n, p in model.named_parameters()}
        none = {n for n in grads if gradless(i, n)}
        for n in none:
            grads[n] = np.zeros_like(grads[n])
        updates, opt_state = tx.update(_tree(grads.items()), opt_state, params)
        params = optax.apply_updates(params, updates)
        for n, p in model.named_parameters():
            p.grad = (torch.from_numpy(grads[n]) if p.requires_grad and n not in none else None)
        opt.step()
        if after_call is not None:
            after_call(i, opt_state)
    return _flat(params), opt_state


def assert_params(model, want, tol=TOL):
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=tol, err_msg=n)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def test_multistep_schedule_matches_optax_piecewise_constant():
    """Counts 0..t_max+2 around each milestone (a milestone applies from its
    own count on, optax's ``count >= boundary``), with a repeated one."""
    base, milestones, gamma = 3e-4, (3, 7, 7, 10), 0.3
    want = JS.multistep_schedule(base, milestones, gamma)
    got = S.multistep_schedule(base, milestones, gamma)
    for count in range(0, 13):
        w = np.float32(want(jnp.asarray(count, jnp.int32)))
        g = got(count)
        assert g.dtype == torch.float32 and float(g) == float(w), count


@pytest.mark.parametrize("t_max,eta_min", [(10, 0.0), (7, 1e-5)])
def test_cosine_schedule_matches_jax_in_float32(t_max, eta_min):
    base = 6.130697604327541e-4
    want = JS.cosine_schedule(base, t_max, eta_min)
    got = S.cosine_schedule(base, t_max, eta_min)
    for count in range(0, t_max + 3):
        w = np.float32(want(jnp.asarray(count, jnp.int32)))
        g = got(count)
        assert g.dtype == torch.float32
        cos = np.cos(np.float32(np.float32(np.pi) * np.float32(min(count, t_max))) / t_max)
        tol = 0.5 * (base - eta_min) * float(np.spacing(np.float32(abs(cos)))) + float(
            np.spacing(w))
        assert abs(float(g) - float(w)) <= tol, (count, float(g), float(w))
    assert float(got(t_max + 2)) == float(got(t_max))     # clipped at t_max


# ---------------------------------------------------------------------------
# multi-tensor Adam, with schedules, accumulation, split rates, plateau
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "multistep"])
@pytest.mark.parametrize("kind,wd,clip", [("adamw", WD, 0.5), ("adam", 0.0, None)])
def test_scheduled_adam_matches_optax(schedule, kind, wd, clip):
    """Four updates with the rate read from a schedule at optax's count
    (0 at the first update), freeze labels on."""
    rng = np.random.default_rng(11)
    model = seeded(_Toy(), rng)
    lr = {"cosine": lambda mod: mod.cosine_schedule(0.05, 3, 1e-3),
          "multistep": lambda mod: mod.multistep_schedule(0.05, (1, 3), 0.5)}[schedule]
    params = _tree((n, p.detach().numpy()) for n, p in model.named_parameters())
    tx = JS.make_optimizer(learning_rate=lr(JS), weight_decay=wd, grad_clip_norm=clip,
                           freeze_labels=JS.cascade_freeze_labels(params))
    opt = S.make_optimizer(model, learning_rate=lr(S), weight_decay=wd, grad_clip_norm=clip,
                           freeze_labels=S.cascade_freeze_labels(model), kind=kind)
    want, _ = run_both(model, tx, opt, rng, 4)
    assert_params(model, want)
    assert opt.count == 4


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("labelled", [True, False])
def test_grad_accum_matches_optax_multisteps(k, labelled):
    """Six calls through optax.MultiSteps(every k) and the port's
    ``grad_accum=k``: AdamW, clip 0.5, a cosine schedule that advances on
    emits only. Without labels net_A gets no gradient in calls 0 and 4
    (zeros in optax). Between emits the parameters stay bit for bit."""
    rng = np.random.default_rng(5)
    model = seeded(_Toy(), rng)
    params = _tree((n, p.detach().numpy()) for n, p in model.named_parameters())
    kw = dict(weight_decay=WD, grad_clip_norm=0.5, grad_accum=k)
    tx = JS.make_optimizer(learning_rate=JS.cosine_schedule(0.05, 2), **kw,
                           freeze_labels=JS.cascade_freeze_labels(params) if labelled else None)
    opt = S.make_optimizer(model, learning_rate=S.cosine_schedule(0.05, 2), **kw,
                           freeze_labels=S.cascade_freeze_labels(model) if labelled else None)
    before = {}

    def after_call(i, opt_state):
        now = {n: p.detach().clone() for n, p in model.named_parameters()}
        if (i + 1) % k:                        # no emit: nothing moves
            assert all(torch.equal(now[n], before[n]) for n in now), i
            assert opt.count == (i + 1) // k
        before.update(now)

    before.update({n: p.detach().clone() for n, p in model.named_parameters()})
    want, opt_state = run_both(model, tx, opt, rng, 6,
                               gradless=lambda i, n: not labelled and i in (0, 4)
                               and n.startswith("net_A"), after_call=after_call)
    assert_params(model, want)
    assert opt.count == 6 // k == int(opt_state.gradient_step)


def _jax_labels(port_model, jax_model, importer, in_shape, label_fn):
    """The JAX package's labels of ``jax_model``'s parameters, carried onto
    the port's parameter names through weights.jax_to_torch (1.0 where the
    label is 'enc' / 'frozen')."""
    variables, _ = M.to_jax(port_model, jax_model, importer, in_shape)
    labels = label_fn(variables["params"])
    marks = jax.tree_util.tree_map(
        lambda lab, p: np.full(p.shape, lab in ("enc", "frozen"), np.float32),
        labels, variables["params"])
    tree = {"params": marks, "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                   variables["batch_stats"])}
    sd = weights.jax_to_torch(tree, port_model)
    out = {}
    for n, _ in port_model.named_parameters():
        v = sd[n].numpy()
        assert v.min() == v.max(), n
        out[n] = bool(v.max())
    return out


def _split_label_fn(params):
    """make_split_lr_optimizer's labels (state.py:128-137)."""
    tree = JS.label_params_by_path(params, lambda keys: any("encoder" in k for k in keys))
    return jax.tree.map(lambda lab: "enc" if lab == "frozen" else "dec", tree)


SPLIT_MODELS = {
    "dose_pyfer": lambda: (M.port_dose(), M.jax_dose(), TI.import_pyfer, (1, 32, 32, 32, 9)),
    "transeg": lambda: (M.port_seg(), M.jax_seg(), TI.import_transeg, (1, 32, 32, 32, 1)),
}


@pytest.mark.parametrize("name", sorted(SPLIT_MODELS))
def test_split_lr_labels_match_jax_leaf_by_leaf(name):
    """The encoder/decoder label of every parameter, and the freeze label,
    against the JAX package's labels of the flax leaf it imports into."""
    port, jax_model, importer, shape = SPLIT_MODELS[name]()
    want = _jax_labels(port, jax_model, importer, shape, _split_label_fn)
    got = S.encoder_labels(port)
    assert {n: lab == "enc" for n, lab in got.items()} == want
    assert 0 < sum(want.values()) < len(want)
    frozen = _jax_labels(port, jax_model, importer, shape, JS.cascade_freeze_labels)
    assert {n: lab == "frozen" for n, lab in S.cascade_freeze_labels(port).items()} == frozen


def test_split_lr_updates_match_jax():
    """Three AdamW updates of the reduced DOSE-PYFER with cosine encoder and
    constant decoder rates, against make_split_lr_optimizer on the JAX
    parameters the port's weights import into; gradients carried by
    weights.jax_to_torch."""
    port, jax_model, importer, shape = SPLIT_MODELS["dose_pyfer"]()
    variables, _ = M.to_jax(port, jax_model, importer, shape)
    params = variables["params"]
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    tx = JS.make_split_lr_optimizer(lr_encoder=JS.cosine_schedule(1e-2, 2), lr_decoder=3e-3,
                                    weight_decay=WD)
    opt = S.make_split_lr_optimizer(port, lr_encoder=S.cosine_schedule(1e-2, 2),
                                    lr_decoder=3e-3, weight_decay=WD)
    assert [len(g["params"]) for g in opt.param_groups] == [
        sum(v == "enc" for v in S.encoder_labels(port).values()),
        sum(v == "dec" for v in S.encoder_labels(port).values())]
    opt_state = tx.init(params)
    update = jax.jit(tx.update)              # one program for the three updates
    rng = np.random.default_rng(3)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        carried = weights.jax_to_torch({"params": grads, "batch_stats": stats}, port)
        for n, p in port.named_parameters():
            p.grad = carried[n]
        opt.step()
    want = weights.jax_to_torch({"params": jax.tree_util.tree_map(np.asarray, params),
                                 "batch_stats": stats}, port)
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0, atol=TOL,
                                   err_msg=n)


def test_plateau_optimizer_matches_injected_learning_rate():
    """make_plateau_optimizer with the rate rewritten by set_learning_rate
    after the second update, against optax.inject_hyperparams; the rate
    reads back as float32 in both."""
    rng = np.random.default_rng(9)
    model = seeded(_Toy(), rng)
    tx = JS.make_plateau_optimizer(base_lr=0.05, weight_decay=WD)
    opt = S.make_plateau_optimizer(model, base_lr=0.05, weight_decay=WD)
    assert S.get_learning_rate(opt) == float(np.float32(0.05))
    new_lr = 0.0123
    params = _tree((n, p.detach().numpy().copy()) for n, p in model.named_parameters())
    opt_state = tx.init(params)
    for i in range(4):
        grads = {n: rng.standard_normal(p.shape).astype(np.float32)
                 for n, p in model.named_parameters()}
        updates, opt_state = tx.update(_tree(grads.items()), opt_state, params)
        params = optax.apply_updates(params, updates)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        if i == 1:
            opt_state = JS.set_learning_rate(opt_state, new_lr)
            S.set_learning_rate(opt, new_lr)
    assert_params(model, _flat(params))
    assert S.get_learning_rate(opt) == JS.get_learning_rate(opt_state)


def test_set_learning_rate_refuses_a_fixed_rate():
    model = _Toy()
    params = _tree((n, p.detach().numpy()) for n, p in model.named_parameters())
    tx = JS.make_optimizer(learning_rate=1e-3, weight_decay=WD)
    with pytest.raises(ValueError, match="learning_rate"):
        JS.set_learning_rate(tx.init(params), 1e-4)
    for opt in (S.make_optimizer(model, learning_rate=1e-3, weight_decay=WD),
                S.make_split_lr_optimizer(model, lr_encoder=1e-3, lr_decoder=1e-3)):
        with pytest.raises(ValueError, match="learning rate"):
            S.set_learning_rate(opt, 1e-4)
        assert S.get_learning_rate(opt) is None
    assert JS.get_learning_rate(tx.init(params)) is None


@pytest.mark.parametrize("kwargs", [dict(), dict(factor=0.3, patience=2, min_lr=2e-4),
                                    dict(mode="max", patience=1)])
def test_reduce_lr_on_plateau_matches_jax(kwargs):
    values = [1.0, 0.9, 0.95, 0.95, 0.97, 0.8, 0.85, 0.86, 0.9, 0.91, 0.92, 0.93, 0.7] * 2
    want = JS.ReduceLROnPlateau(base_lr=1e-3, **kwargs)
    got = S.ReduceLROnPlateau(base_lr=1e-3, **kwargs)
    assert [got.step(v) for v in values] == [want.step(v) for v in values]
    assert (got.best, got.bad_epochs) == (want.best, want.bad_epochs)


# ---------------------------------------------------------------------------
# adam8bit
# ---------------------------------------------------------------------------

class _Toy8(torch.nn.Module):
    """Leaves above min_quantize_size (4096): ``a`` 5120 elements (3 blocks,
    the last 1024 lanes of padding: the tail block), ``b`` exactly 2
    blocks; below it: ``c`` and ``d``."""

    def __init__(self):
        super().__init__()
        for name, shape in (("a", (64, 80)), ("b", (4096,)), ("c", (100,)), ("d", (3000,))):
            self.register_parameter(name, torch.nn.Parameter(torch.zeros(shape)))


@pytest.mark.parametrize("wd,clip,sched,frozen", [(0.0, None, False, ()),
                                                  (1e-2, 1.0, False, ()),
                                                  (WD, None, True, ()),
                                                  (WD, 1.0, False, ("a", "c"))])
def test_adam8bit_matches_jax(wd, clip, sched, frozen):
    """Five updates; gradients spread over four decades so the blocks' log
    grids span them. With ``sched`` the rate is a cosine schedule, read at
    the update's count as adam8bit.py:141 reads it; ``frozen`` leaves are
    labelled 'frozen' (optax.set_to_zero in JAX) and hold no state."""
    rng = np.random.default_rng(21)
    model = seeded(_Toy8(), rng)
    params = _tree((n, p.detach().numpy().copy()) for n, p in model.named_parameters())
    lr = (lambda mod: mod.cosine_schedule(1e-2, 4)) if sched else (lambda mod: 1e-2)
    labels = {n: "frozen" if n in frozen else "trainable" for n, _ in model.named_parameters()}
    tx = JS.make_optimizer(learning_rate=lr(JS), weight_decay=wd, grad_clip_norm=clip,
                           kind="adam8bit", freeze_labels=dict(labels) if frozen else None)
    opt = S.make_optimizer(model, learning_rate=lr(S), weight_decay=wd, grad_clip_norm=clip,
                           kind="adam8bit", freeze_labels=labels if frozen else None)
    opt_state = tx.init(params)
    for _ in range(5):
        grads = {n: (rng.standard_normal(p.shape) * 10.0 ** rng.uniform(-3, 1, p.shape))
                 .astype(np.float32) for n, p in model.named_parameters()}
        updates, opt_state = tx.update(_tree(grads.items()), opt_state, params)
        params = optax.apply_updates(params, updates)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
    assert_params(model, _flat(params))
    if frozen:
        state = opt_state.inner_states["trainable"].inner_state[-1]
    else:
        state = opt_state[-1] if isinstance(opt_state, tuple) else opt_state
    assert A8.state_nbytes(opt) == JA.state_nbytes(state) > 0
    codes = mismatched = 0
    names = sorted(n for n, _ in model.named_parameters() if n not in frozen)  # JAX order
    for i, name in enumerate(names):
        got = opt.moments(getattr(model, name))
        jm, jv = state.mu[i], state.nu[i]
        if not isinstance(jm, JA.Quantized):
            assert got[0].dtype == torch.float32 and getattr(model, name).numel() < 4096
            np.testing.assert_allclose(got[0].numpy(), np.asarray(jm), rtol=0, atol=TOL)
            np.testing.assert_allclose(got[1].numpy(), np.asarray(jv), rtol=1e-5, atol=0)
            continue
        assert got[0].values.dtype == torch.int8 and got[1].values.dtype == torch.uint8
        for g, w in ((got[0].values, jm.values), (got[1].values, jv.values)):
            diff = g.numpy().astype(np.int32) - np.asarray(w).astype(np.int32)
            assert g.shape == w.shape and np.abs(diff).max() <= 1, name
            codes += diff.size
            mismatched += int(np.count_nonzero(diff))
        for g, w in ((got[0].scales, jm.scales), (got[1].lo, jv.lo), (got[1].scale, jv.scale)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0, err_msg=name)
    print(f"adam8bit codes differing by one step: {mismatched} of {codes}")
    assert codes == 2 * ((0 if "a" in frozen else 3) + 2) * 2048
    assert mismatched <= codes // 1000


def test_adam8bit_tail_block_keeps_pad_lanes_out_of_its_log_bounds():
    """One leaf of 4097 elements: its third block holds one real lane. That
    lane's log bounds are its own (lo == hi), not log(1e-30) from the pad
    lanes, so its v is carried at float32 precision."""
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.zeros(4097))
    opt = S.make_optimizer(model, learning_rate=1e-3, kind="adam8bit")
    model.w.grad = torch.full((4097,), 0.5)
    opt.step()
    _, nu = opt.moments(model.w)
    assert nu.values.shape == (3, 2048)
    v_tail = float(torch.exp(nu.lo[2]) - A8.LOG_TINY)
    assert abs(v_tail - 0.001 * 0.25) <= 1e-6 * 0.001 * 0.25
    assert float(nu.lo[2]) > -20.0                       # log(1e-30) ≈ -69
