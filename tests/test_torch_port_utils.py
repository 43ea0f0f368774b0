"""The port's metric logger, epoch timer and profiling hooks
(utils/{logging,profiling}.py) against the JAX package's on the CPU: the
same metrics.jsonl records and log.txt lines, the same timer buckets; a
torch.profiler trace written to the directory; StepTimer's summary."""

import json

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu.utils import logging as JLOG  # noqa: E402

from dose_prediction_tpu_torch.utils import logging as LOG  # noqa: E402
from dose_prediction_tpu_torch.utils import profiling as PROF  # noqa: E402


def test_metric_logger_writes_the_jax_records(tmp_path, capsys):
    for mod, d in ((LOG, tmp_path / "port"), (JLOG, tmp_path / "jax")):
        logger = mod.MetricLogger(d, run_name="pyfer")
        logger.log({"train_mean_loss": 0.5, "moving_loss": torch.tensor(0.25)}, 3)
        logger.log_text("epoch 3: done")
        logger.close()
    out = capsys.readouterr().out
    assert out.count("[pyfer step 3] train_mean_loss=0.5 moving_loss=0.25") == 2
    recs = {}
    for name in ("port", "jax"):
        rec = json.loads((tmp_path / name / "metrics.jsonl").read_text())
        rec.pop("time")
        recs[name] = rec
        assert (tmp_path / name / "log.txt").read_text() == "epoch 3: done\n"
    assert recs["port"] == recs["jax"] == {"step": 3, "run": "pyfer", "train_mean_loss": 0.5,
                                           "moving_loss": 0.25}


def test_epoch_timer_buckets_and_report():
    port, ref = LOG.EpochTimer(), JLOG.EpochTimer()
    for t in (port, ref):
        for bucket in ("loader", "train", "train", "val"):
            t.tick()
            t.tock(bucket)
    assert port.report().split(" ")[0::2] == ref.report().split(" ")[0::2]
    assert min(port.train_s, port.loader_s, port.val_s) > 0
    port.reset()
    assert (port.train_s, port.loader_s, port.val_s) == (0.0, 0.0, 0.0)


def test_trace_writes_a_profiler_trace(tmp_path):
    with PROF.trace(str(tmp_path / "prof")):
        with PROF.step_annotation("step0"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1 and "step0" in traces[0].read_text()
    with PROF.trace(None):          # no directory: nothing recorded
        pass
    with pytest.raises(KeyError):   # the body's exception propagates
        with PROF.trace(str(tmp_path / "prof2")):
            raise KeyError("body")


def test_step_timer_summary():
    timer = PROF.StepTimer()
    assert timer.summary() == {}
    for _ in range(3):
        timer.start()
        timer.stop()
    s = timer.summary()
    assert s["n"] == 3 and s["p50_s"] <= s["p90_s"] and s["mean_s"] >= 0
