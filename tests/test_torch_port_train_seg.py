"""One OAR-TranSeg train step of the PyTorch port
(train/steps.py::make_transeg_train_step) against the JAX step on the CPU.

The reduced configuration of tests/test_torch_port_models.py (``CFG``: a
4-layer ViT-24 with 2 heads, feature size 2, 32³ crops, 8 classes), the
port's seeded weights carried into JAX by core/torch_import.import_transeg
and the JAX gradients and BatchNorm statistics back by
weights.jax_to_torch. Inputs from numpy seeds; float32. Tolerances, the
bars of tests/test_torch_port_train.py: the loss to a relative 1e-5; each
gradient leaf to 1e-3 × its own max |g| with a floor of 2e-6 × the model's
largest |g|; the conv biases that feed a norm (the seg family's k3, k7 and
fuse convs) must be noise below 1e-5 of the largest in both packages; the
BatchNorm running statistics to 1e-5. No bfloat16 leaf-by-leaf test: such
a bar is met or missed by chance where a leaf's bf16 gradient has few
significant bits (CHANGES.md, PR 11).
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dose_prediction_tpu.core import torch_import as TI  # noqa: E402
from dose_prediction_tpu.train import losses as JL  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.train import state as S  # noqa: E402
from dose_prediction_tpu_torch.train import steps  # noqa: E402

import test_torch_port_models as M  # noqa: E402  (seeded reduced models, JAX import)

SIZE = M.SIZE
LR, WD = 6.130697604327541e-4, 1.6303111017674179e-4   # train/trainers.py:56-57
ZERO_GRAD_BIAS = re.compile(r"conv_block\.cov_\.(conv_[37]\.0\.conv\.[03]|conv\.0)\.bias$")


def seg_batch(seed=0, n=1, size=SIZE):
    rng = np.random.default_rng(seed)
    ct = rng.standard_normal((n, size, size, size, 1)).astype(np.float32)
    labels = rng.integers(0, 8, (n, size, size, size)).astype(np.uint8)
    return ct, labels


def jax_seg_step_grads(model, ct, labels):
    """The JAX step's loss, gradients and new BatchNorm statistics
    (steps.py:178-185) from the port model's weights, as port state dicts."""
    variables, stats = M.to_jax(model, M.jax_seg(), TI.import_transeg, (1, SIZE, SIZE, SIZE, 1))
    assert stats["missing"] == 0 and stats["unused"] == 0
    jm = M.jax_seg()

    def loss_fn(params, batch_stats, ct, labels):
        logits, updates = jm.apply({"params": params, "batch_stats": batch_stats}, ct,
                                   train=True, mutable=["batch_stats"])
        return JL.dice_ce_loss(logits, labels.astype(jnp.int32)), updates["batch_stats"]

    (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], ct, labels)
    want = weights.jax_to_torch(
        jax.tree_util.tree_map(np.asarray, {"params": grads, "batch_stats": new_stats}), model)
    return float(loss), want


@pytest.fixture(scope="module")
def one_step():
    model = M.port_seg(out_ch=8)
    ct, labels = seg_batch()
    jloss, want = jax_seg_step_grads(model, ct, labels)
    opt = S.make_optimizer(model, learning_rate=LR, weight_decay=WD)
    step = steps.make_transeg_train_step(model, opt)
    state, loss = step(S.TrainState(model, opt), {"ct": torch.from_numpy(ct),
                                                  "labels": torch.from_numpy(labels)})
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return dict(model=model, state=state, loss=float(loss), jloss=jloss, want=want,
                grads=grads)


def test_transeg_step_loss_matches_jax(one_step):
    assert np.isfinite(one_step["loss"])
    assert abs(one_step["loss"] - one_step["jloss"]) <= 1e-5 * abs(one_step["jloss"])
    assert one_step["state"].step == 1 and one_step["state"].moving_loss == one_step["loss"]


def test_transeg_step_gradients_match_jax_leaf_by_leaf(one_step):
    grads, want = one_step["grads"], one_step["want"]
    g_max = max(float(np.abs(want[n].numpy()).max()) for n in grads)
    zero = [n for n in grads if ZERO_GRAD_BIAS.search(n)]
    assert len(zero) == 4 * 5                # 4 decoders × 5 convs that feed a norm
    worst = 0.0
    for name, got in grads.items():
        ref = want[name].numpy()
        if name in zero:
            assert max(np.abs(got.numpy()).max(), np.abs(ref).max()) <= 1e-5 * g_max, name
            continue
        err = float(np.abs(got.numpy() - ref).max())
        worst = max(worst, err / max(float(np.abs(ref).max()), 1e-30))
        bound = max(1e-3 * float(np.abs(ref).max()), 2e-6 * g_max)
        assert err <= bound, f"{name}: max abs err {err} > {bound}"
    print(f"TranSeg step: worst leaf err / its max|g| {worst:.3g} over {len(grads)} leaves")
    assert len(grads) > 100


def test_transeg_step_batch_norm_statistics_match_jax(one_step):
    """The 8 BatchNorms of the k7 branches (4 decoders × 2) update once."""
    checked = 0
    for name, buf in one_step["model"].named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), one_step["want"][name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
            checked += 1
        if name.endswith("num_batches_tracked"):
            assert int(buf) == 1, name
    assert checked == 4 * 2 * 2


def test_transeg_step_widens_uint8_labels():
    """uint8 and int64 labels give the same loss (the step widens them)."""
    model = M.port_seg(out_ch=8, seed=3)
    ct, labels = seg_batch(seed=1)
    losses = []
    for lab in (torch.from_numpy(labels), torch.from_numpy(labels.astype(np.int64))):
        m = M.port_seg(out_ch=8, seed=3)
        m.load_state_dict(model.state_dict())
        opt = S.make_optimizer(m, learning_rate=LR)
        _, loss = steps.make_transeg_train_step(m, opt)(
            S.TrainState(m, opt), {"ct": torch.from_numpy(ct), "labels": lab})
        losses.append(float(loss))
    assert losses[0] == losses[1] and np.isfinite(losses[0])
