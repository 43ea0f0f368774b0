"""The port's trainers against themselves on the CPU
(tests/test_torch_port_trainers.py's cohort and small DOSE-PYFER): an
interrupted and resumed fit ends bit for bit where an uninterrupted one
ends, the resume guard refuses a changed ``act``, and a mesh is refused.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dose_prediction_tpu_torch.cli import main as CLI  # noqa: E402
from dose_prediction_tpu_torch.train import trainers as T  # noqa: E402

from torch_threads import one_torch_thread  # noqa: E402,F401

from test_torch_port_trainers import (  # noqa: E402,F401
    SHAPE,
    SIZE,
    cohort,
    jax_without_native,
    records,
    state_numpy,
)


def port_pyfer(seed=0):
    return T.seeded(seed, lambda: CLI.default_flagship_model(small=True, img_size=(SIZE,) * 3,
                                                             device="cpu"))


@pytest.mark.parametrize("kind", ["adamw", "adam8bit"])
def test_interrupted_fit_resumes_bit_for_bit(tmp_path, cohort, kind):
    ds, _ = cohort
    kw = dict(check_val=1, optimizer=kind, device="cpu", feed_dtype="packed")
    whole = T.PyferTrainer(T.TrainConfig(max_epochs=3, ckpt_dir=str(tmp_path / "w"),
                                         log_dir=str(tmp_path / "wl"), **kw),
                           model=port_pyfer(), example_shape=SHAPE)
    whole.fit(ds, ds)
    first = T.PyferTrainer(T.TrainConfig(max_epochs=3, max_steps=2, ckpt_dir=str(tmp_path / "r"),
                                         log_dir=str(tmp_path / "rl"), **kw),
                           model=port_pyfer(), example_shape=SHAPE)
    first.fit(ds, ds)
    assert first.state.step == 2
    resumed = T.PyferTrainer(T.TrainConfig(max_epochs=3, ckpt_dir=str(tmp_path / "r"),
                                           log_dir=str(tmp_path / "rl"), **kw),
                             model=port_pyfer(seed=5), example_shape=SHAPE)
    resumed.fit(ds, ds)
    assert resumed.state.step == whole.state.step == 6
    assert resumed.state.moving_loss == whole.state.moving_loss
    a, b = state_numpy(resumed.model), state_numpy(whole.model)
    assert all(np.array_equal(a[k], b[k]) for k in b)
    assert records(tmp_path / "rl")["val_loss"] == records(tmp_path / "wl")["val_loss"]
    # the best slot holds the best validation of the whole run
    assert resumed.ckpt.best_step() == whole.ckpt.best_step()


def test_resume_guard_refuses_a_changed_act(tmp_path, cohort, monkeypatch):
    ds, _ = cohort
    cfg = T.TrainConfig(max_epochs=1, check_val=5, device="cpu", ckpt_dir=str(tmp_path / "g"),
                        log_dir=str(tmp_path / "gl"))
    T.PyferTrainer(cfg, model=port_pyfer(), example_shape=SHAPE).fit(ds)
    relu = CLI.default_flagship_model(small=True, act="relu", img_size=(SIZE,) * 3,
                                      device="cpu")
    cfg2 = T.TrainConfig(**{**cfg.__dict__, "max_epochs": 2})
    with pytest.raises(RuntimeError, match="act"):
        T.PyferTrainer(cfg2, model=relu, example_shape=SHAPE).fit(ds)
    monkeypatch.setenv("DPT_FRESH_ON_MISMATCH", "1")
    fresh = T.PyferTrainer(cfg2, model=relu, example_shape=SHAPE)
    fresh.fit(ds)
    assert fresh.state.step == 4          # started over: two epochs of two steps


def test_mesh_shape_is_refused():
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        T.PyferTrainer(T.TrainConfig(mesh_shape={"data": 2}, device="cpu"),
                       model=port_pyfer(), example_shape=SHAPE)
