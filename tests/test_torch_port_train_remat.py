"""Rematerialisation (nn/remat.py: the step's ``remat`` and the models'
``remat_blocks``) and the batched eval branch of the PyTorch port on the
CPU.

Remat: the same seeded weights and batch through the plain step and the
rematerialised one. The recompute repeats the forward's operations in the
same order on the CPU, so gradients, losses and BatchNorm running
statistics must be equal bit for bit, and each BatchNorm must count one
update. Without the guard in nn/layers.py::BatchNorm3d a recompute applies
the momentum a second time; one case shows that it would.

Batched eval: make_pyfer_eval_step with ``valid`` against the JAX eval step
on the reduced DOSE-PYFER of tests/test_torch_port_models.py, three
samples of which one is a pad row: the scalars to the eval test's bars
(tests/test_torch_port_train.py: val loss 1e-4, dose score 70 × 1e-4).
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dose_prediction_tpu.core import torch_import as TI  # noqa: E402
from dose_prediction_tpu.train import state as JS  # noqa: E402
from dose_prediction_tpu.train import steps as JSTEP  # noqa: E402

from dose_prediction_tpu_torch.models import DosePyfer, TranSeg  # noqa: E402
from dose_prediction_tpu_torch.nn import remat  # noqa: E402
from dose_prediction_tpu_torch.train import state as S  # noqa: E402
from dose_prediction_tpu_torch.train import steps  # noqa: E402

import test_torch_port_models as M  # noqa: E402  (seeded reduced models, JAX import)
import test_torch_port_train as T  # noqa: E402
from test_torch_port_train_seg import seg_batch  # noqa: E402

LR, WD = T.LR, T.WD


def dose_model(remat_blocks=False):
    return M.seeded(DosePyfer(list_ch_A=M.LIST_CH, img_size=M.SIZE, remat_blocks=remat_blocks,
                              device="cpu", **M.CFG), 0)


def seg_model(remat_blocks=False):
    return M.seeded(TranSeg(out_ch=8, img_size=M.SIZE, remat_blocks=remat_blocks,
                            device="cpu", **M.CFG), 0)


def run_step(kind, remat_step=False, remat_blocks=False, steps_=2):
    """``steps_`` steps of the DOSE-PYFER (net_A trained, so the remat also
    recomputes it) or TranSeg step; the model, the losses and the last
    step's gradients."""
    if kind == "dose":
        model = dose_model(remat_blocks)
        opt = S.make_optimizer(model, learning_rate=LR, weight_decay=WD)
        step = steps.make_pyfer_train_step(model, opt, freeze=False, remat=remat_step)
        x, gt = T.batch(seed=4)
        batch = {"input": torch.from_numpy(x), "gt": torch.from_numpy(gt)}
    else:
        model = seg_model(remat_blocks)
        opt = S.make_optimizer(model, learning_rate=LR, weight_decay=WD)
        step = steps.make_transeg_train_step(model, opt)
        ct, labels = seg_batch(seed=4)
        batch = {"ct": torch.from_numpy(ct), "labels": torch.from_numpy(labels)}
    state, losses = S.TrainState(model, opt), []
    for _ in range(steps_):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return model, losses, {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def plain():
    return {kind: run_step(kind) for kind in ("dose", "seg")}


def assert_same(plain_run, run):
    (m0, losses0, g0), (m1, losses1, g1) = plain_run, run
    assert losses1 == losses0
    assert g1.keys() == g0.keys()
    for n in g0:
        assert torch.equal(g1[n], g0[n]), n
    stats = 0
    for (n, b0), (_, b1) in zip(m0.named_buffers(), m1.named_buffers()):
        assert torch.equal(b1, b0), n
        if n.endswith("num_batches_tracked"):
            assert int(b1) == 2, n          # one update a step
            stats += 1
    assert stats == 8                      # 4 decoders × 2 BatchNorms


@pytest.mark.parametrize("kind,remat_step,remat_blocks", [
    ("dose", True, False), ("dose", False, True), ("dose", True, True), ("seg", False, True)])
def test_remat_gives_the_plain_steps_gradients_and_statistics(plain, kind, remat_step,
                                                              remat_blocks):
    """Two steps, so the second starts from parameters and statistics the
    first updated under remat."""
    assert_same(plain[kind], run_step(kind, remat_step, remat_blocks))


def test_remat_without_the_guard_updates_statistics_twice(plain):
    """With the guard off, a recompute applies the BatchNorm momentum again:
    the running statistics leave the plain step's and each BatchNorm counts
    two updates a step. The guard is what keeps the case above equal."""
    with mock.patch.object(remat, "updates_batch_stats", lambda: True):
        model, losses, _ = run_step("seg", remat_blocks=True)
    m0 = plain["seg"][0]
    assert losses == plain["seg"][1]        # the forward does not read them in training
    bufs0 = dict(m0.named_buffers())
    moved = [n for n, b in model.named_buffers() if n.endswith("running_mean")
             and not torch.equal(b, bufs0[n])]
    assert len(moved) == 8
    assert all(int(b) == 4 for n, b in model.named_buffers() if n.endswith("num_batches_tracked"))


def test_checkpoint_is_a_plain_call_without_autograd():
    calls = []

    def fn(x):
        calls.append(remat.updates_batch_stats())
        y = x.exp()
        return y * y

    with torch.no_grad():
        assert torch.equal(remat.checkpoint(fn, torch.ones(3)), torch.ones(3).exp() ** 2)
    x = torch.ones(3, requires_grad=True)
    remat.checkpoint(fn, x).sum().backward()        # forward, then one recompute
    assert calls == [True, True, False]
    assert torch.allclose(x.grad, 2 * torch.ones(3).exp() ** 2)


def test_batched_eval_matches_jax():
    """Three samples, the last a pad row (valid 0): the scalars only."""
    model = M.port_dose()
    variables, _ = M.to_jax(model, M.jax_dose(), TI.import_pyfer, (1, M.SIZE, M.SIZE, M.SIZE, 9))
    xs, gts = zip(*(T.batch(seed=s) for s in (5, 6, 7)))
    x, gt = np.concatenate(xs), np.concatenate(gts)
    valid = np.array([1, 1, 0], np.int32)
    jstate = JS.TrainState(step=0, params=variables["params"],
                           batch_stats=variables["batch_stats"], opt_state=None,
                           moving_loss=0.0)
    want = JSTEP.make_pyfer_eval_step(M.jax_dose())(jstate, {"input": x, "gt": gt,
                                                             "valid": valid})
    got = steps.make_pyfer_eval_step(model)({"input": torch.from_numpy(x),
                                             "gt": torch.from_numpy(gt),
                                             "valid": torch.from_numpy(valid)})
    assert sorted(got) == sorted(want) == ["dose_score_mean", "n_valid", "val_loss_mean"]
    assert float(got["n_valid"]) == float(want["n_valid"]) == 2.0
    assert abs(float(got["val_loss_mean"]) - float(want["val_loss_mean"])) <= 1e-4
    assert abs(float(got["dose_score_mean"]) - float(want["dose_score_mean"])) <= 70 * 1e-4
    # the pad row is weighted out: the mean over the two valid samples alone
    two = steps.make_pyfer_eval_step(model)({"input": torch.from_numpy(x[:2]),
                                             "gt": torch.from_numpy(gt[:2]),
                                             "valid": torch.ones(2)})
    assert abs(float(two["val_loss_mean"]) - float(got["val_loss_mean"])) <= 1e-6
