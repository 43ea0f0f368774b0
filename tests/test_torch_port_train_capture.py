"""The captured train step's host side on the CPU (infer/aot.py::LazyTrainStage,
train/state.py's host and device halves, the float32 moving loss).

A CUDA graph needs the card; here the stage runs with its graph faked
(``cpu_graphs``): the capture runs the step and then restores every
parameter, buffer and optimizer-state tensor (a capture records without
running), and a replay runs the step again with the optimizer's host half
(``advance``) left out, since the stage runs it before each replay: the
device half then reads the scalars that call wrote, as a replayed graph
does. What the fake cannot show, a capture on the card shows
(tests/test_torch_port_cuda.py, chip_smoke.py's train_captured phase).

- The update through the stage against optax, 5 updates or more in each
  case (adam, adamw, adam8bit, the global-norm clip, ``grad_accum=2``, a
  cosine schedule, the plateau's ``set_learning_rate``), with the
  tolerances of tests/test_torch_port_train_optim.py: parameters within
  1e-6 absolute. Each update's scalars on the device are its own: the
  negated rate equal to the schedule's float32 value at the update's count
  (the schedules are held against JAX's in
  tests/test_torch_port_train_optim.py), the bias corrections
  ``1 − b^t`` within two float32 ulps of numpy's ``b^t`` (the subtraction
  is exact; two float32 powers may each be an ulp off), MultiSteps' divisor
  exact. One capture per MultiSteps phase: an optimizer that
  replaced a state tensor in an update would capture again at the next
  call (the key holds the addresses).
- The moving loss against JAX's ``update_moving_loss``: equal bit for bit
  to the function evaluated op by op (its float32 arithmetic as written),
  within a relative 1e-5 of the jitted one (XLA's fused program may contract
  and reorder the EMA's two products), NaN seeds included.
- Each captured step kind, captured against eager on the same weights and
  batches, equal bit for bit on the CPU (one thread, the same operations),
  with every call, eager and captured, under a guard that fails on a
  tensor read on the host (``item``, ``__float__``, ``__int__``,
  ``__bool__``, ``tolist``, ``numpy``) and on host data put on a device
  (``torch.tensor(..., device=...)``, ``torch.as_tensor`` of a non-tensor
  with a device): on the card either is a copy that a capture refuses. The
  optimizer's host half is exempt: its schedule values are host arithmetic
  on host tensors, and it writes the update's scalars before a replay.
- The capture key, ``maybe_wrap_train_step`` and the stage's refusals.
"""

import contextlib
import dataclasses
import sys
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu.train import state as JS  # noqa: E402

from dose_prediction_tpu_torch.core import checkpoint as C  # noqa: E402
from dose_prediction_tpu_torch.core.config import FLAGS  # noqa: E402
from dose_prediction_tpu_torch.data import packed as PK  # noqa: E402
from dose_prediction_tpu_torch.infer import aot  # noqa: E402
from dose_prediction_tpu_torch.train import state as S  # noqa: E402
from dose_prediction_tpu_torch.train import steps  # noqa: E402
from dose_prediction_tpu_torch.train import trainers as TR  # noqa: E402

import test_torch_port_models as M  # noqa: E402  (seeded reduced models, JAX import)
import test_torch_port_train as T  # noqa: E402  (batches)
import test_torch_port_train_optim as O  # noqa: E402  (optax runs, toy models)

SIZE = M.SIZE
TOL = O.TOL


# ---------------------------------------------------------------------------
# the faked graph
# ---------------------------------------------------------------------------

class _Stream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    """A replay: the captured function again, the optimizer's host half out."""

    def __init__(self, fn, static, opt, emits):
        self.fn, self.static, self.opt, self.emits = fn, static, opt, emits

    def replay(self):
        with mock.patch.object(self.opt, "advance", lambda: self.emits):
            state, loss = self.fn()
        self.static[0].moving_loss.copy_(state.moving_loss)
        self.static[1].copy_(loss)


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The stage on the CPU with its graph faked (module docstring). Call the
    fixture's value with the model and optimizer the stage's step updates."""
    monkeypatch.setattr(aot, "_require_cuda", lambda name, args: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.delenv("DPT_NO_AOT", raising=False)
    bound = {}

    def graph(stage, stream, device, fn):
        model, opt = bound["model"], bound["opt"]
        tensors = [*model.parameters(), *model.buffers(), *opt.state_tensors()]
        keep = [t.detach().clone() for t in tensors]
        emits, advance = [], opt.advance
        with mock.patch.object(opt, "advance", lambda: emits.append(advance()) or emits[-1]):
            static = fn()
        with torch.no_grad():
            for t, k in zip(tensors, keep):
                t.copy_(k)
        return _FakeGraph(fn, static, opt, emits[0]), static

    monkeypatch.setattr(aot.LazyTrainStage, "_graph", graph)
    return lambda model, opt: bound.update(model=model, opt=opt)


HOST_READS = ("item", "__float__", "__int__", "__bool__", "tolist", "numpy")


@contextlib.contextmanager
def no_host_reads():
    """Fail on any tensor read on the host and on host data put on a device
    inside the block, but in the optimizer's host half
    (``_Optimizer.advance``)."""
    host_half = S._Optimizer.advance.__code__

    def in_host_half():
        frame = sys._getframe(2)
        while frame is not None:
            if frame.f_code is host_half:
                return True
            frame = frame.f_back
        return False

    def guard(name, real):
        def read(self, *args, **kwargs):
            if not in_host_half():
                raise AssertionError(f"a host read in the step: Tensor.{name}")
            return real(self, *args, **kwargs)
        return read

    def placed(name, real):
        def make(data, *args, **kwargs):
            if (kwargs.get("device") is not None and not torch.is_tensor(data)
                    and not in_host_half()):
                raise AssertionError(f"host data put on a device in the step: torch.{name}")
            return real(data, *args, **kwargs)
        return make

    with contextlib.ExitStack() as stack:
        for name in HOST_READS:
            stack.enter_context(mock.patch.object(torch.Tensor, name,
                                                  guard(name, getattr(torch.Tensor, name))))
        for name in ("tensor", "as_tensor"):
            stack.enter_context(mock.patch.object(torch, name, placed(name, getattr(torch, name))))
        yield


def test_the_guard_catches_each_host_read():
    x = torch.ones(2)
    for read in (lambda: x.sum().item(), lambda: float(x.sum()), lambda: int(x.sum()),
                 lambda: bool(x.sum()), lambda: x.tolist(), lambda: x.numpy(),
                 lambda: torch.tensor(1.0, device=x.device),
                 lambda: torch.as_tensor([1.0], device=x.device)):
        with no_host_reads(), pytest.raises(AssertionError, match="host"):
            read()
    with no_host_reads():
        assert torch.as_tensor(x, device=x.device) is x


# ---------------------------------------------------------------------------
# the update through the stage against optax
# ---------------------------------------------------------------------------

def grad_step(model, opt):
    """``step(state, batch)``: the batch's tensors are the trainable leaves'
    gradients, then the update; the loss is the first gradient's sum."""
    def step(state, batch):
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.grad = batch[n]
        opt.step()
        loss = next(iter(batch.values())).sum()
        return dataclasses.replace(state, step=state.step + 1, moving_loss=S.update_moving_loss(
            state.moving_loss, loss)), loss
    return step


def _correction_close(got: float, b: float, t: int) -> bool:
    power = np.float32(b) ** np.float32(t)
    return abs(got - float(np.float32(1) - power)) <= 2 * float(np.spacing(power))


def run_captured(model, opt, tx, rng, calls, *, schedule=None, scale=lambda i: 1.0,
                 between=lambda i, opt_state: opt_state):
    """``calls`` updates of ``tx`` (optax) and of ``opt`` through a
    LazyTrainStage on the same numpy-seeded gradients; after each emitting
    call the device scalars are held against ``schedule`` (the port's
    schedule of optax's count, else the group's rate) and numpy's bias
    corrections.
    Returns the optax parameters by name and the stage."""
    stage = aot.LazyTrainStage("train:test", grad_step(model, opt))
    state = S.TrainState(model, opt)
    params = O._tree((n, p.detach().numpy().copy()) for n, p in model.named_parameters())
    opt_state = tx.init(params)
    b1, b2 = opt.param_groups[0]["b1"], opt.param_groups[0]["b2"]
    for i in range(calls):
        grads = {n: (scale(i) * rng.standard_normal(p.shape)).astype(np.float32)
                 for n, p in model.named_parameters()}
        updates, opt_state = tx.update(O._tree(grads.items()), opt_state, params)
        params = optax.apply_updates(params, updates)
        with no_host_reads():
            state, _ = stage(state, {n: torch.from_numpy(g) for n, g in grads.items()})
        n = i % opt.grad_accum
        neg_lr, bc1, bc2, n1 = (float(v) for v in opt.scalars[-4:])
        assert n1 == n + 1, i
        if n + 1 == opt.grad_accum:
            t = opt.count
            # Adam reads the rate at optax's count t − 1, adam8bit at t (adam8bit.py:141)
            at = t if isinstance(opt, O.A8.Adam8bit) else t - 1
            want = (np.float32(schedule(at)) if schedule is not None
                    else np.float32(opt.param_groups[0]["lr"]))
            assert -neg_lr == float(want) == opt.param_groups[0]["last_lr"], (i, neg_lr, want)
            assert _correction_close(bc1, b1, t) and _correction_close(bc2, b2, t), (i, bc1, bc2)
        opt_state = between(i, opt_state)
    return O._flat(params), stage


CASES = {
    "adam": dict(kw=dict(learning_rate=0.05), calls=5),
    "adamw": dict(kw=dict(learning_rate=0.05, weight_decay=O.WD), calls=5),
    # every other call's gradients are under the clip norm
    "clip": dict(kw=dict(learning_rate=0.05, weight_decay=O.WD, grad_clip_norm=3.0),
                 calls=6, scale=lambda i: 0.05 if i % 2 else 1.0),
    "cosine": dict(kw=dict(weight_decay=O.WD), schedule=lambda mod: mod.cosine_schedule(
        0.05, 4, 1e-3), calls=6),
    # both phases five times: five updates
    "grad_accum=2": dict(kw=dict(weight_decay=O.WD, grad_clip_norm=0.5, grad_accum=2),
                         schedule=lambda mod: mod.cosine_schedule(0.05, 3), calls=10),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_captured_update_matches_optax(cpu_graphs, case):
    spec = CASES[case]
    rng = np.random.default_rng(13)
    model = O.seeded(O._Toy(), rng)
    sched = spec.get("schedule")
    lr = {} if sched is None else {"learning_rate": sched(S)}
    opt = S.make_optimizer(model, **spec["kw"], **lr)
    tx = JS.make_optimizer(**spec["kw"], **({} if sched is None else
                                            {"learning_rate": sched(JS)}))
    cpu_graphs(model, opt)
    want, stage = run_captured(model, opt, tx, rng, spec["calls"],
                               schedule=None if sched is None else opt.param_groups[0]["lr"],
                               scale=spec.get("scale", lambda i: 1.0))
    O.assert_params(model, want)
    k = opt.grad_accum
    assert opt.count == spec["calls"] // k >= 5
    assert stage.captures == k and stage.used_aot, (stage.captures, k)


def test_captured_plateau_rate_reaches_the_device_scalars(cpu_graphs):
    """set_learning_rate after the second update, on both sides: the third
    update runs at the new rate from the same graph (the rate is no part of
    the key)."""
    rng = np.random.default_rng(9)
    model = O.seeded(O._Toy(), rng)
    opt = S.make_plateau_optimizer(model, base_lr=0.05, weight_decay=O.WD)
    tx = JS.make_plateau_optimizer(base_lr=0.05, weight_decay=O.WD)
    cpu_graphs(model, opt)

    def between(i, opt_state):
        if i == 1:
            S.set_learning_rate(opt, 0.0123)
            return JS.set_learning_rate(opt_state, 0.0123)
        return opt_state

    want, stage = run_captured(model, opt, tx, rng, 5, between=between)
    O.assert_params(model, want)
    assert -float(opt.scalars[0]) == float(np.float32(0.0123)) == S.get_learning_rate(opt)
    assert stage.captures == 1


def test_captured_adam8bit_matches_jax(cpu_graphs):
    """Five adam8bit updates (weight decay, a cosine schedule read at the
    update's count) through the stage: the moments are written in place,
    so one capture serves every update."""
    rng = np.random.default_rng(21)
    model = O.seeded(O._Toy8(), rng)
    opt = S.make_optimizer(model, learning_rate=S.cosine_schedule(1e-2, 4), weight_decay=O.WD,
                           kind="adam8bit")
    tx = JS.make_optimizer(learning_rate=JS.cosine_schedule(1e-2, 4), weight_decay=O.WD,
                           kind="adam8bit")
    cpu_graphs(model, opt)
    want, stage = run_captured(model, opt, tx, rng, 5, schedule=opt.param_groups[0]["lr"],
                               scale=lambda i: 10.0 ** (i - 2))
    O.assert_params(model, want)
    assert stage.captures == 1 and opt.count == 5


# ---------------------------------------------------------------------------
# the moving loss
# ---------------------------------------------------------------------------

def test_moving_loss_matches_jax_float32():
    """200 losses over five decades, a NaN among them (the next loss seeds
    the EMA again), from a NaN seed."""
    rng = np.random.default_rng(0)
    losses = (rng.standard_normal(200) ** 2 * 10.0 ** rng.uniform(-3, 2, 200)).astype(np.float32)
    losses[50] = np.nan
    jitted = jax.jit(JS.update_moving_loss)
    got = S.TrainState(O._Toy(), None).moving_loss
    assert got.dtype == torch.float32 and got.shape == () and torch.isnan(got)
    op_by_op = fused = jnp.float32(np.nan)
    worst = 0.0
    for loss in losses:
        got = S.update_moving_loss(got, torch.tensor(loss))
        op_by_op = JS.update_moving_loss(op_by_op, jnp.float32(loss))
        fused = jitted(fused, jnp.float32(loss))
        g, a, b = got.numpy(), np.float32(op_by_op), np.float32(fused)
        assert g.dtype == np.float32 and (g == a or (np.isnan(g) and np.isnan(a))), (g, a)
        if not np.isnan(b):
            worst = max(worst, abs(float(g) - float(b)) / abs(float(b)))
    print(f"moving loss: bit-equal to JAX op by op over 200 losses; jitted JAX within a "
          f"relative {worst:.3g}")
    assert worst <= 1e-5
    assert np.isnan(float(S.update_moving_loss(torch.tensor(1.0), torch.tensor(np.nan))))


def test_moving_loss_lives_on_the_models_device_and_checkpoints_as_a_float(tmp_path):
    model = O._Toy()
    state = S.TrainState(model, S.make_optimizer(model, learning_rate=1e-3), step=3,
                         moving_loss=0.25)
    assert torch.is_tensor(state.moving_loss) and state.moving_loss.device.type == "cpu"
    C.save_checkpoint(tmp_path / "slot.pt", {"state": state, "epoch": 0})
    saved = C.restore_checkpoint(tmp_path / "slot.pt")
    assert isinstance(saved["moving_loss"], float) and saved["moving_loss"] == 0.25
    restored = C.restore_checkpoint(tmp_path / "slot.pt", {"state": state, "epoch": 0})["state"]
    assert restored.moving_loss.dtype == torch.float32 and float(restored.moving_loss) == 0.25


# ---------------------------------------------------------------------------
# the step kinds, captured against eager
# ---------------------------------------------------------------------------

def dose_batches(kind: str, n: int):
    out = []
    for seed in range(n):
        if kind == "packed":
            rng = np.random.default_rng(seed)
            shape = (1, SIZE, SIZE, SIZE)
            out.append({
                "ct": torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16(),
                "dose": torch.from_numpy(rng.random(shape).astype(np.float32)).bfloat16(),
                "ptv": torch.from_numpy((rng.random(shape) < 0.1).astype(np.uint8) * 70),
                "mask_bits": torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8)),
                "shift": torch.tensor([rng.uniform(-0.1, 0.1)], dtype=torch.float32),
                "flip": torch.tensor([rng.integers(0, 8)], dtype=torch.int32),
                "rot_k": torch.tensor([rng.integers(0, 4)], dtype=torch.int32)})
        else:
            x, gt = T.batch(seed)
            x = torch.from_numpy(x)
            out.append({"input": x.bfloat16() if kind == "bf16" else x,
                        "gt": torch.from_numpy(gt)})
    return out


def seg_batches(n: int):
    out = []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        out.append({"ct": torch.from_numpy(rng.standard_normal((1, SIZE, SIZE, SIZE, 1))
                                           .astype(np.float32)),
                    "labels": torch.from_numpy(rng.integers(0, 8, (1, SIZE, SIZE, SIZE))
                                               .astype(np.uint8))})
    return out


def make_pyfer(kind="adamw", grad_accum=1, clip=None, packed=False):
    model = M.port_dose()
    opt = S.make_optimizer(model, learning_rate=T.LR, weight_decay=T.WD, kind=kind,
                           freeze_labels=S.cascade_freeze_labels(model), grad_accum=grad_accum,
                           grad_clip_norm=clip)
    return model, opt, steps.make_pyfer_train_step(model, opt, packed=packed)


def make_seg():
    model = M.port_seg()
    opt = S.make_optimizer(model, learning_rate=T.LR, weight_decay=T.WD)
    return model, opt, steps.make_transeg_train_step(model, opt)


KINDS = {   # (make, batches, calls, captures)
    "pyfer float32 adamw": (lambda: make_pyfer(), lambda: dose_batches("float32", 4), 4, 1),
    "pyfer bf16 adamw": (lambda: make_pyfer(), lambda: dose_batches("bf16", 3), 3, 1),
    "pyfer packed adam8bit": (lambda: make_pyfer("adam8bit", packed=True),
                              lambda: dose_batches("packed", 3), 3, 1),
    "pyfer grad_accum=2 clip": (lambda: make_pyfer(grad_accum=2, clip=0.5),
                                lambda: dose_batches("float32", 4), 4, 2),
    "transeg adamw": (make_seg, lambda: seg_batches(3), 3, 1),
}


@pytest.mark.parametrize("name", sorted(KINDS))
def test_captured_step_equals_eager_with_no_host_read(cpu_graphs, name):
    """The same weights and batches through the eager step and through the
    stage: each call's loss, moving loss, step count and every parameter
    and buffer after it equal bit for bit, and no call reads a tensor on the
    host."""
    make, batches, calls, captures = KINDS[name]
    batches = batches()
    model_e, opt_e, step_e = make()
    model_c, opt_c, step_c = make()
    cpu_graphs(model_c, opt_c)
    stage = aot.LazyTrainStage(f"train:{name}", step_c)
    state_e, state_c = S.TrainState(model_e, opt_e), S.TrainState(model_c, opt_c)
    for i in range(calls):
        batch = batches[i % len(batches)]
        with no_host_reads():
            state_e, loss_e = step_e(state_e, batch)
            state_c, loss_c = stage(state_c, batch)
        assert torch.equal(loss_c, loss_e) and torch.equal(state_c.moving_loss,
                                                           state_e.moving_loss), i
        assert state_c.step == state_e.step == i + 1
        assert (opt_c.count, opt_c.mini_step) == (opt_e.count, opt_e.mini_step)
        for (n, a), b in zip(model_e.state_dict().items(), model_c.state_dict().values()):
            assert torch.equal(a, b), (i, n)
    assert stage.captures == captures and stage.used_aot


# ---------------------------------------------------------------------------
# the key, the hook and the refusals
# ---------------------------------------------------------------------------

def test_capture_key_follows_phase_routing_and_replaced_state(tmp_path, monkeypatch):
    model, opt, step = make_pyfer(grad_accum=2)
    state = S.TrainState(model, opt)
    batch = dose_batches("float32", 1)[0]
    opt.materialize()
    first = aot.train_key(state, batch)
    state, _ = step(state, batch)
    second = aot.train_key(state, batch)
    state, _ = step(state, batch)
    assert first != second and aot.train_key(state, batch) == first    # the phase
    monkeypatch.setattr(FLAGS, "use_k3_conv3d", "1")
    assert aot.train_key(state, batch) != first
    monkeypatch.setattr(FLAGS, "use_k3_conv3d", "0")
    assert aot.train_key(state, batch) == first
    C.save_checkpoint(tmp_path / "slot.pt", {"state": state, "epoch": 0})
    state = C.restore_checkpoint(tmp_path / "slot.pt", {"state": state, "epoch": 0})["state"]
    opt.materialize()
    assert aot.train_key(state, batch) != first                        # new moment tensors
    assert aot.train_key(state, {**batch, "input": batch["input"].bfloat16()}) != \
        aot.train_key(state, batch)


def test_a_restore_captures_again_and_trains_on(cpu_graphs, tmp_path):
    """Two calls, a restore of the first call's slot, two more: the restore
    replaces the optimizer's state tensors, so the stage captures again, and
    the losses after it equal an eager run's that restored the same slot."""
    batches = dose_batches("float32", 2)
    runs = {}
    for captured in (False, True):
        model, opt, step = make_pyfer()
        if captured:
            cpu_graphs(model, opt)
            step = stage = aot.LazyTrainStage("train:pyfer", step)
        state = S.TrainState(model, opt)
        state, _ = step(state, batches[0])
        slot = tmp_path / f"{captured}.pt"
        C.save_checkpoint(slot, {"state": state, "epoch": 0})
        state, _ = step(state, batches[1])
        state = C.restore_checkpoint(slot, {"state": state, "epoch": 0})["state"]
        losses = []
        for b in batches:
            state, loss = step(state, b)
            losses.append(loss)
        runs[captured] = (losses, [p.detach().clone() for p in model.parameters()])
    assert stage.captures == 2
    assert all(torch.equal(a, b) for a, b in zip(runs[False][0], runs[True][0]))
    assert all(torch.equal(a, b) for a, b in zip(runs[False][1], runs[True][1]))


def test_a_failed_capture_raises_naming_the_stage(cpu_graphs, monkeypatch):
    model, opt, step = make_seg()
    cpu_graphs(model, opt)

    def refuse(*args):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(aot.LazyTrainStage, "_graph", refuse)
    stage = aot.LazyTrainStage("train:transeg", step)
    state = S.TrainState(model, opt)
    with pytest.raises(RuntimeError, match="captured stage 'train:transeg': capture failed"):
        stage(state, seg_batches(1)[0])
    assert (opt.count, opt.mini_step) == (1, 0)      # the warm-up's update stands
    assert stage.captures == 0


def test_the_stage_refuses_cpu_tensors_and_runs_eager_under_no_aot(monkeypatch):
    model, opt, step = make_seg()
    stage = aot.LazyTrainStage("train:transeg", step)
    state, batch = S.TrainState(model, opt), seg_batches(1)[0]
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("DPT_NO_AOT", raising=False)
        else:
            monkeypatch.setenv("DPT_NO_AOT", env)
        with pytest.raises(ValueError, match="'train:transeg': a CUDA graph needs CUDA tensors"):
            stage(state, batch)
    assert stage.used_aot is None and opt.count == 0


def test_maybe_wrap_train_step_wraps_on_the_card_only(monkeypatch):
    def step(state, batch):
        return state, None

    class OnCard(torch.nn.Module):
        def parameters(self, recurse=True):
            yield SimpleNamespace(device=torch.device("cuda", 0))

    monkeypatch.delenv("DPT_NO_AOT", raising=False)
    wrapped = aot.maybe_wrap_train_step("pyfer", OnCard(), step)
    assert isinstance(wrapped, aot.LazyTrainStage) and wrapped.name == "train:pyfer"
    assert wrapped.step is step and wrapped.used_aot is None
    assert aot.maybe_wrap_train_step("pyfer", O._Toy(), step) is step
    monkeypatch.setenv("DPT_NO_AOT", "1")
    assert aot.maybe_wrap_train_step("transeg", OnCard(), step) is step


def test_cpu_trainers_keep_the_eager_step(tmp_path):
    cfg = TR.TrainConfig(device="cpu", ckpt_dir=str(tmp_path / "ck"), log_dir=str(tmp_path))
    pyfer = TR.PyferTrainer(cfg, model=M.port_dose(), example_shape=(1, SIZE, SIZE, SIZE, 9))
    seg = TR.TranSegTrainer(cfg, model=M.port_seg(), crop=(SIZE,) * 3)
    for trainer in (pyfer, seg):
        assert not isinstance(trainer.train_step, aot.LazyTrainStage)
        assert trainer.train_step.__name__ == "step"


def test_unpack_refuses_decisions_left_on_another_device():
    batch = dose_batches("packed", 1)[0]
    batch["shift"] = torch.empty(1, device="meta")
    with pytest.raises(ValueError, match=r"decisions \{'shift': 'meta'\} off the volumes"):
        PK.unpack_dose_batch(batch)
