"""The PyTorch port's C3D cascade (models/c3d.py::CascadeC3D) and its train
step (train/steps.py::make_cascade_c3d_train_step) against the JAX package
on the CPU.

Reduced widths (list_ch (-1, 2, 4, 8, 16, 32) for both U-Nets, 32³, so the
fifth level is 2³), seeded weights carried into JAX by
core/torch_import.py::import_c3d_cascade, which must report no missing and
no unused leaves, and back by weights.jax_to_torch. float32. Tolerances:
the forward ≤ 1e-3 (the bar of test_torch_port_models.py); one step's loss
to a relative 1e-5. Gradients leaf by leaf by chip_smoke.py's
train_parity rule: a leaf within max(1e-3, 2 × noise) × its own max |g|,
with a floor of 2e-6 × the model's largest |g|, where ``noise`` is the
worst leaf-relative deviation of the port's own step when each
InstanceNorm output carries a seeded relative noise of 1e-6. Two stacked
U-Nets with 42 InstanceNorms, the deepest over 2³ voxels, amplify float32
rounding: that noise moves some leaves by over 10 % of their scale, and
the two packages' float32 steps (whose forward outputs differ by ~1e-4)
differ by 1-10 % in most leaves. The conv biases that feed an
InstanceNorm have a zero gradient in exact arithmetic and must be noise
below 1e-4 of the largest in both packages (JAX's own reaches 2.7e-5 at
the full-resolution two-channel planes, a float32 sum of 32768 terms). The step's update (the split
learning rate with a cosine schedule, as CascadeC3DTrainer builds it) on
the port's own gradients within 1e-6.
"""

import re
from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dose_prediction_tpu import models as jmodels  # noqa: E402
from dose_prediction_tpu.core import torch_import as TI  # noqa: E402
from dose_prediction_tpu.train import losses as JL  # noqa: E402
from dose_prediction_tpu.train import state as JS  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.models import CascadeC3D  # noqa: E402
from dose_prediction_tpu_torch.nn.layers import InstanceNorm3d  # noqa: E402
from dose_prediction_tpu_torch.train import losses as L  # noqa: E402
from dose_prediction_tpu_torch.train import state as S  # noqa: E402
from dose_prediction_tpu_torch.train import steps  # noqa: E402

import test_torch_port_models as M  # noqa: E402  (seeded reduced models, JAX import)

LIST_CH = M.LIST_CH
SIZE = M.SIZE
WD = 1.6303111017674179e-4   # train/trainers.py:58
# the SingleConv convs: each feeds an InstanceNorm
ZERO_GRAD_BIAS = re.compile(r"single_conv\.0\.bias$|upconv_\d\.conv\.0\.bias$")


def port_c3d(seed=0):
    return M.seeded(CascadeC3D(list_ch_A=LIST_CH, list_ch_B=LIST_CH, device="cpu"), seed)


def jax_c3d():
    return jmodels.CascadeC3D(out_ch=1, list_ch_A=LIST_CH, list_ch_B=LIST_CH)


def import_params(model):
    """The port's weights as JAX parameters, through import_c3d_cascade."""
    target = jax.eval_shape(jax_c3d().init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, SIZE, SIZE, SIZE, 9), jnp.float32))
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    return TI.import_c3d_cascade(sd, target["params"], verbose=False)


def batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, SIZE, SIZE, SIZE, 9)).astype(np.float32)
    dose = rng.random((1, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    mask = (rng.random((1, SIZE, SIZE, SIZE, 1)) < 0.6).astype(np.float32)
    return x, np.concatenate([dose, mask], axis=-1)


@pytest.fixture(scope="module")
def pair():
    model = port_c3d()
    params, stats = import_params(model)
    return model, params, stats


def test_port_state_dict_imports_into_jax_with_no_missing_or_unused_leaves(pair):
    _, _, stats = pair
    assert stats["missing"] == 0 and stats["unused"] == 0
    assert stats["copied"] == stats["inside"] > 0


def test_jax_to_torch_round_trips_the_cascade(pair):
    model, params, _ = pair
    sd = weights.jax_to_torch({"params": jax.tree_util.tree_map(np.asarray, params)},
                              CascadeC3D(list_ch_A=LIST_CH, list_ch_B=LIST_CH, device="cpu"))
    fresh = CascadeC3D(list_ch_A=LIST_CH, list_ch_B=LIST_CH, device="cpu")
    result = fresh.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    for key, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key


def test_cascade_c3d_forward_matches_jax(pair):
    model, params, _ = pair
    x, _ = batch(seed=1)
    ja, jb = jax.jit(jax_c3d().apply)({"params": params}, x)
    with torch.no_grad():
        ta, tb = model(M.ncdhw(x))
    assert ta.shape == tb.shape == (1, 1, SIZE, SIZE, SIZE)
    assert M.max_err(ja, ta) <= M.TOL and M.max_err(jb, tb) <= M.TOL


def test_default_widths_are_the_reference_cascade():
    """The full-width C3D (list_ch (-1, 32, 64, 128, 256, 512)) has the
    JAX model's leaves, shape for shape (no weights are drawn)."""
    with torch.device("meta"):
        model = CascadeC3D(device="cpu")
    target = jax.eval_shape(jmodels.CascadeC3D().init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 32, 32, 32, 9), jnp.float32))
    want = {"/".join(str(k.key) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_leaves_with_path(target["params"])}
    got = {}
    for key, ref in model.state_dict().items():
        module_key, leaf = key.rsplit(".", 1)
        path = weights.c3d_key_map(module_key)
        flax_leaf = ("kernel" if ref.ndim > 1 else "scale") if leaf == "weight" else leaf
        shape = tuple(ref.shape)
        got["/".join(path + (flax_leaf,))] = shape[2:] + shape[1::-1] if ref.ndim == 5 else shape
    assert got == want


def noise_run_gradients(model, params, x, gt, freeze):
    """The port's gradients of the same step from the same weights, each
    InstanceNorm output multiplied by 1 + 1e-6·u (u uniform in [-1, 1],
    seeded; kept out of the gradient): a run that differs from the plain
    one by rounding-sized noise only."""
    g = torch.Generator().manual_seed(0)
    forward = InstanceNorm3d.forward

    def noisy(self, inp):
        out = forward(self, inp)
        u = torch.rand(out.shape, generator=g) * 2 - 1
        return out + (out * (1e-6 * u)).detach()

    twin = port_c3d(seed=1)
    twin.load_state_dict(weights.jax_to_torch(
        {"params": jax.tree_util.tree_map(np.asarray, params)}, twin))
    with mock.patch.object(InstanceNorm3d, "forward", noisy):
        pred_a, pred_b = twin(M.ncdhw(x))
        L.cascade_l1_loss(pred_a, pred_b, M.ncdhw(gt), freeze=freeze).backward()
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in twin.named_parameters()}


@pytest.mark.parametrize("freeze", [False, True])
def test_cascade_c3d_train_step_matches_jax(freeze):
    """One step: loss, every gradient leaf, and the parameters after the
    split-rate AdamW update (encoder 1e-3 on a cosine over 10, decoder
    2e-3), against value_and_grad of the JAX step's loss and
    make_split_lr_optimizer."""
    model = port_c3d(seed=1)
    params, _ = import_params(model)
    x, gt = batch(seed=2)
    jm = jax_c3d()

    def loss_fn(params, batch):                       # train/steps.py:126-128
        pred_a, pred_b = jm.apply({"params": params}, batch["input"])
        return JL.cascade_l1_loss(pred_a, pred_b, batch["gt"], freeze=freeze)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params, {"input": x, "gt": gt})
    want = weights.jax_to_torch({"params": jax.tree_util.tree_map(np.asarray, jgrads)}, model)

    opt = S.make_split_lr_optimizer(model, lr_encoder=S.cosine_schedule(1e-3, 10),
                                    lr_decoder=2e-3, weight_decay=WD)
    step = steps.make_cascade_c3d_train_step(model, opt, freeze=freeze)
    state, loss = step(S.TrainState(model, opt), {"input": torch.from_numpy(x),
                                                  "gt": torch.from_numpy(gt)})
    assert state.step == 1 and abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    # with freeze, conv_out_A is out of the loss: no gradient (zeros in JAX)
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in model.named_parameters()}
    assert all((p.grad is None) == (freeze and n.startswith("conv_out_A"))
               for n, p in model.named_parameters())
    g_max = max(float(np.abs(want[n].numpy()).max()) for n in grads)
    zero = [n for n in grads if ZERO_GRAD_BIAS.search(n)]
    assert len(zero) == 2 * (10 + 11)      # two U-Nets × (10 encoder + 11 decoder convs)
    noisy = noise_run_gradients(model, params, x, gt, freeze)
    leaves = [n for n in grads if n not in zero]
    leaves = [n for n in leaves if not (freeze and n.startswith("conv_out_A"))]
    scale = {n: float(np.abs(want[n].numpy()).max()) for n in leaves}
    noise = max(float((noisy[n] - grads[n]).abs().max()) / scale[n] for n in leaves)
    rel = {n: float(np.abs(grads[n].numpy() - want[n].numpy()).max()) / scale[n] for n in leaves}
    print(f"C3D step (freeze={freeze}): worst leaf err / its max|g| {max(rel.values()):.3g}, "
          f"noise run {noise:.3g}; {sum(r > 1e-3 for r in rel.values())} of {len(leaves)} "
          f"leaves over 1e-3")
    for name in leaves:
        assert rel[name] * scale[name] <= max(max(1e-3, 2 * noise) * scale[name],
                                              2e-6 * g_max), (name, rel[name], noise)
    for name in zero:
        got, ref = grads[name].numpy(), want[name].numpy()
        assert max(np.abs(got).max(), np.abs(ref).max()) <= 1e-4 * g_max, name
    if freeze:   # net_A still learns through net_B's input; only its head is out of the loss
        assert not want["conv_out_A.weight"].numpy().any()
        assert grads["net_A.encoder.encoder_1.0.single_conv.0.weight"].any()
    # the step's update: make_split_lr_optimizer on the port's own gradients
    # (Adam's first update is about lr · sign(g), so the packages' gradients,
    # which differ in rounding, would move a near-zero element by 2 lr)
    port_grads, stats = TI.import_c3d_cascade({n: g.numpy() for n, g in grads.items()},
                                              params, verbose=False)
    assert stats["missing"] == 0 and stats["unused"] == 0
    tx = JS.make_split_lr_optimizer(lr_encoder=JS.cosine_schedule(1e-3, 10), lr_decoder=2e-3,
                                    weight_decay=WD)
    updates, _ = tx.update(port_grads, tx.init(params), params)
    want_new = weights.jax_to_torch(
        {"params": jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), params, updates)},
        model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_new[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
