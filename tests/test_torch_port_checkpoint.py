"""The port's checkpoints (core/checkpoint.py) and reference-checkpoint
loader (core/torch_import.py) on the CPU.

Slots round-trip bit for bit with AdamW and with adam8bit (its int8 and
uint8 moments and scales included); the monitored saves keep the best
``max_to_keep`` by ``mode``; iter_N snapshots are never rotated; a leftover
temporary file is never read; a restore checks before it loads; the
run_config guard refuses a changed configuration unless
``DPT_FRESH_ON_MISMATCH=1``. merge_partial and load_pretrained_net_a equal
the JAX functions on weights carried across by weights.jax_to_torch (seeded
values in the JAX models' structure: no init program is compiled), and
load_torch_checkpoint reads the three container formats of a replica of
the reference C3D cascade (tests/test_torch_import.py) into the port's
CascadeC3D with a strict load.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu.core import checkpoint as JC  # noqa: E402
from dose_prediction_tpu.models import CascadeC3D as JCascadeC3D  # noqa: E402
from dose_prediction_tpu.models import DosePyfer as JDosePyfer  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.core import checkpoint as C  # noqa: E402
from dose_prediction_tpu_torch.core.torch_import import load_torch_checkpoint  # noqa: E402
from dose_prediction_tpu_torch.models import CascadeC3D, DosePyfer  # noqa: E402
from dose_prediction_tpu_torch.train import adam8bit as A8  # noqa: E402
from dose_prediction_tpu_torch.train import state as S  # noqa: E402
from dose_prediction_tpu_torch.train import trainers as T  # noqa: E402

from test_torch_import import _torch_cascade  # noqa: E402  (the reference C3D replica)

LIST_CH = (-1, 2, 4, 8, 16, 32)
SIZE = 16


def c3d(seed=0):
    return T.seeded(seed, lambda: CascadeC3D(list_ch_A=LIST_CH, list_ch_B=LIST_CH,
                                             device="cpu"))


def trained_state(kind, seed=0, steps=2):
    """A C3D cascade and its optimizer after ``steps`` updates on seeded data."""
    model = c3d(seed)
    opt = S.make_optimizer(model, learning_rate=1e-3, weight_decay=1e-4, kind=kind)
    state = S.TrainState(model, opt)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, 9, SIZE, SIZE, SIZE)).astype(np.float32))
    for _ in range(steps):
        state = take_step(state, x)
    return state, x


def take_step(state, x):
    state.optimizer.zero_grad()
    a, b = state.model(x)
    loss = a.square().mean() + b.square().mean()
    loss.backward()
    state.optimizer.step()
    return S.TrainState(state.model, state.optimizer, state.step + 1,
                        S.update_moving_loss(state.moving_loss, float(loss)))


@pytest.mark.parametrize("kind", ["adamw", "adam8bit"])
def test_slot_round_trip_is_bit_for_bit(tmp_path, kind):
    state, x = trained_state(kind)
    mgr = C.CheckpointManager(tmp_path)
    mgr.save_last({"state": state, "epoch": 3})
    fresh = c3d(seed=9)
    template = {"state": S.TrainState(fresh, S.make_optimizer(
        fresh, learning_rate=1e-3, weight_decay=1e-4, kind=kind)), "epoch": 0}
    restored = mgr.restore_last(template)
    assert restored["epoch"] == 3
    got = restored["state"]
    assert (got.step, got.moving_loss) == (state.step, state.moving_loss)
    assert got.optimizer.count == state.optimizer.count == 2
    for (n, a), b in zip(state.model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), n
    if kind == "adam8bit":
        for p, q in zip(state.model.parameters(), fresh.parameters()):
            mine, theirs = state.optimizer.moments(p), got.optimizer.moments(q)
            for u, v in zip(mine, theirs):
                for s, t in zip(u if isinstance(u, tuple) else (u,),
                                v if isinstance(v, tuple) else (v,)):
                    assert s.dtype == t.dtype and torch.equal(s, t)
        assert A8.state_nbytes(got.optimizer) == A8.state_nbytes(state.optimizer) > 0
    # one more step from each: the same parameters, bit for bit
    a, b = take_step(state, x), take_step(got, x)
    assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
    assert a.moving_loss == b.moving_loss


@pytest.mark.parametrize("mode,keep", [("max", [3, 4]), ("min", [0, 2])])
def test_monitored_saves_keep_the_best_by_mode(tmp_path, mode, keep):
    state, _ = trained_state("adamw", steps=1)
    mgr = C.CheckpointManager(tmp_path, max_to_keep=2, monitor="score", mode=mode)
    for step, score in enumerate([1.0, 3.0, 2.0, 5.0, 4.0]):
        mgr.save(step, {"state": state, "epoch": step}, {"score": score})
    assert mgr.all_steps() == keep
    assert sorted(p.name for p in (tmp_path / "monitored").glob("*.pt")) == \
        [f"{s}.pt" for s in keep]
    best = {"max": 3, "min": 0}[mode]
    assert mgr.best_step() == best and mgr.latest_step() == keep[-1]
    assert mgr.restore_best()[1]["epoch"] == best


def test_iter_snapshots_are_never_rotated(tmp_path):
    state, _ = trained_state("adamw", steps=1)
    mgr = C.CheckpointManager(tmp_path, max_to_keep=1)
    for step in (4, 8, 12):
        mgr.save_snapshot(step, {"state": state, "epoch": step // 4})
        mgr.save(step, {"state": state, "epoch": step // 4}, {"dose_score": float(step)})
    assert mgr.snapshots() == [4, 8, 12]
    assert mgr.all_steps() == [12]
    assert mgr.restore_snapshot(8)["epoch"] == 2


def test_a_leftover_temporary_file_is_ignored(tmp_path):
    mgr = C.CheckpointManager(tmp_path)
    (tmp_path / ".last.pt.tmp-12345").write_bytes(b"half a slot")
    (tmp_path / "monitored").mkdir()
    (tmp_path / "monitored" / ".7.pt.tmp-1").write_bytes(b"half a slot")
    (tmp_path / ".iter_3.pt.tmp-9").write_bytes(b"x")
    assert mgr.restore_last() is None
    assert mgr.all_steps() == [] and mgr.snapshots() == []
    state, _ = trained_state("adamw", steps=1)
    mgr.save_last({"state": state, "epoch": 0})
    assert mgr.restore_last()["epoch"] == 0
    # the write left no temporary file of its own
    assert sorted(p.name for p in tmp_path.glob(".*tmp*")) == [".iter_3.pt.tmp-9",
                                                               ".last.pt.tmp-12345"]


def test_restore_checks_before_it_loads(tmp_path):
    state, _ = trained_state("adamw")
    C.save_checkpoint(tmp_path / "a.pt", {"state": state, "epoch": 1})
    # another architecture: refused, and the template's weights untouched
    other = T.seeded(1, lambda: CascadeC3D(list_ch_A=LIST_CH, list_ch_B=(-1, 4, 8, 16, 32, 64),
                                           device="cpu"))
    before = {k: v.clone() for k, v in other.state_dict().items()}
    with pytest.raises(ValueError, match="shapes"):
        C.restore_checkpoint(tmp_path / "a.pt", {"state": S.TrainState(
            other, S.make_optimizer(other, learning_rate=1e-3)), "epoch": 0})
    assert all(torch.equal(before[k], v) for k, v in other.state_dict().items())
    # the same architecture with another optimizer family: refused
    same = c3d(seed=2)
    before = {k: v.clone() for k, v in same.state_dict().items()}
    with pytest.raises(ValueError, match="Adam8bit"):
        C.restore_checkpoint(tmp_path / "a.pt", {"state": S.TrainState(
            same, S.make_optimizer(same, learning_rate=1e-3, kind="adam8bit")), "epoch": 0})
    assert all(torch.equal(before[k], v) for k, v in same.state_dict().items())
    with pytest.raises(ValueError, match="loss"):
        C.restore_checkpoint(tmp_path / "a.pt", {"state": state, "epoch": 0, "loss": 0.0})


def test_run_config_mismatch_is_refused_unless_fresh(tmp_path, monkeypatch):
    state, _ = trained_state("adamw", steps=1)
    mgr = C.CheckpointManager(tmp_path)
    mgr.save_last({"state": state, "epoch": 0})
    spec = {"optimizer": "adamw", "models": [{"model": "CascadeC3D", "config": {"a": 1}}]}
    mgr.write_run_config(spec)
    template = {"state": state, "epoch": 0}
    restored, start = T._try_resume(mgr, template, run_config=spec)
    assert start == 1 and restored["epoch"] == 0
    changed = {**spec, "optimizer": "adam8bit"}
    with pytest.raises(RuntimeError, match="graph-determining"):
        T._try_resume(mgr, template, run_config=changed)
    monkeypatch.setenv("DPT_FRESH_ON_MISMATCH", "1")
    assert T._try_resume(mgr, template, run_config=changed) == (None, 0)
    assert mgr.read_run_config() == changed


def test_unrestorable_slots_are_refused_unless_fresh(tmp_path, monkeypatch):
    state, _ = trained_state("adamw", steps=1)
    mgr = C.CheckpointManager(tmp_path)
    mgr.save_last({"state": state, "epoch": 0})
    eight = c3d(seed=3)
    template = {"state": S.TrainState(eight, S.make_optimizer(eight, learning_rate=1e-3,
                                                              kind="adam8bit")), "epoch": 0}
    with pytest.raises(RuntimeError, match="could not be restored"):
        T._try_resume(mgr, template)
    monkeypatch.setenv("DPT_FRESH_ON_MISMATCH", "1")
    assert T._try_resume(mgr, template) == (None, 0)


def jax_variables(model, shape, seed):
    """Variables of ``model``'s structure (``jax.eval_shape`` of its init,
    which compiles nothing), each leaf drawn from a normal seeded by
    ``seed``: the merges copy by path and shape, whatever the values."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed), jnp.zeros(shape, jnp.float32))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)


def port_pyfer():
    return DosePyfer(list_ch_A=LIST_CH, feature_size=2, hidden_size=24, mlp_dim=48,
                     num_layers=4, num_heads=2, img_size=SIZE, device="cpu")


def test_load_pretrained_net_a_matches_jax():
    shape = (1, SIZE, SIZE, SIZE, 9)
    jpyfer = JDosePyfer(out_ch=1, list_ch_A=LIST_CH, feature_size=2, hidden_size=24,
                        mlp_dim=48, num_layers=4, num_heads=2, act="mish")
    pyfer_vars = jax_variables(jpyfer, shape, 0)
    c3d_vars = jax_variables(JCascadeC3D(out_ch=1, list_ch_A=LIST_CH, list_ch_B=LIST_CH),
                             (1, 32, 32, 32, 9), 1)
    merged, jstats = JC.load_pretrained_net_a(pyfer_vars["params"], c3d_vars["params"],
                                              verbose=False)
    target = port_pyfer()
    want = weights.jax_to_torch({**pyfer_vars, "params": merged}, target)
    got, stats = C.load_pretrained_net_a(weights.jax_to_torch(pyfer_vars, target),
                                         weights.jax_to_torch(c3d_vars, c3d()), verbose=False)
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert stats["copied"] == jstats["copied"] > 0


def test_merge_partial_skips_shape_mismatches_as_jax_does():
    """A C3D cascade with wider net_B into a narrower one: only entries of
    equal shape are copied (train_light_transeg.py:126-146 surgery)."""
    wide = (-1, 2, 4, 8, 16, 64)
    src_vars = jax_variables(JCascadeC3D(out_ch=1, list_ch_A=LIST_CH, list_ch_B=wide),
                             (1, 32, 32, 32, 9), 4)
    tgt_vars = jax_variables(JCascadeC3D(out_ch=1, list_ch_A=LIST_CH, list_ch_B=LIST_CH),
                             (1, 32, 32, 32, 9), 5)
    merged, jstats = JC.merge_partial(tgt_vars["params"], src_vars["params"], verbose=False)
    target = c3d()
    wide_model = T.seeded(0, lambda: CascadeC3D(list_ch_A=LIST_CH, list_ch_B=wide,
                                                device="cpu"))
    want = weights.jax_to_torch({"params": merged}, target)
    got, stats = C.merge_partial(weights.jax_to_torch(tgt_vars, target),
                                 weights.jax_to_torch(src_vars, wide_model), verbose=False)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert stats["copied"] == jstats["copied"] < stats["inside"] == jstats["inside"]


def test_strip_prefix_and_variables_from_checkpoint():
    sd = {"_model.a.weight": torch.ones(1), "b.bias": torch.zeros(1), "_model": torch.ones(2)}
    assert list(C.strip_prefix(sd, "_model")) == ["a.weight", "b.bias", "_model"]
    assert C.variables_from_checkpoint({"model": {"x": 1}, "optimizer": {}}) == {"x": 1}
    assert C.variables_from_checkpoint({"x": 1}) == {"x": 1}


@pytest.mark.parametrize("fmt", ["networktrainer", "lightning", "bare"])
def test_load_torch_checkpoint_reads_the_reference_containers(tmp_path, fmt):
    torch.manual_seed(0)
    replica = _torch_cascade(LIST_CH).eval()
    sd = replica.state_dict()
    if fmt == "networktrainer":      # network_trainer.py:349-356, DataParallel prefixes
        obj = {"network_state_dict": {f"module.{k}": v for k, v in sd.items()},
               "optimizer_state_dict": {}, "epoch": 7}
        path = tmp_path / "net.pkl"
    elif fmt == "lightning":
        obj = {"state_dict": dict(sd), "epoch": 3, "hyper_parameters": {"lr": 1e-3}}
        path = tmp_path / "last.ckpt"
    else:
        obj, path = dict(sd), tmp_path / "bare.pth"
    torch.save(obj, path)
    loaded = load_torch_checkpoint(str(path))
    assert set(loaded) == set(sd)
    model = c3d(seed=4)
    model.load_state_dict(loaded, strict=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 9, 32, 32, 32)).astype(np.float32))
    with torch.no_grad():
        want = replica(x)
        got = model.eval()(x)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4
