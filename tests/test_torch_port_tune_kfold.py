"""The port's hyperparameter search (train/tune.py), k-fold driver
(train/kfold.py) and MLflow bridge (utils/mlflow_export.py) against the JAX
package's on the CPU.

Both packages draw from numpy alone, so the bar is equality: for the same
seeds and histories the port's ``sample_config``, ``TPESampler.suggest``,
``GPSampler.suggest``, ASHA decisions, PBT and PB2 exploit moves, whole
searches and ``kfold_split`` give exactly the JAX package's values. The
search scenarios mirror tests/test_tune_kfold.py (journal, resume, ASHA
rungs replayed, gapped ids, a truncated journal line, no valid trial, the
sampler's fast-forward on resume) and run in both packages; each must
give the same trials and pass the scenario's own check. The port places
trial i on ``devices[i % len(devices)]`` and hands that device to
``train_trial``. The MLflow bridges run against a fake client, as
tests/test_misc_coverage.py does; mlflow itself is not installed.
"""

import contextlib
import itertools
import json
import math
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dose_prediction_tpu.train import kfold as JK  # noqa: E402
from dose_prediction_tpu.train import tune as JTU  # noqa: E402

from dose_prediction_tpu_torch.train import kfold as K  # noqa: E402
from dose_prediction_tpu_torch.train import tune as TU  # noqa: E402
from dose_prediction_tpu_torch.utils import mlflow_export as MX  # noqa: E402
from dose_prediction_tpu_torch.utils.logging import MetricLogger  # noqa: E402

from torch_threads import one_torch_thread  # noqa: E402,F401


def space_of(pkg, kind="mixed"):
    """The same search space built from ``pkg``'s distributions."""
    if kind == "pyfer":
        return pkg.PYFER_SEARCH_SPACE
    if kind == "lr":
        return {"lr": pkg.LogUniform(1e-4, 1e-1)}
    return {"lr": pkg.LogUniform(1e-4, 1e-1), "u": pkg.Uniform(0.0, 1.0),
            "act": pkg.Choice(["relu", "mish"]), "fixed": 5}


def history_of(n, seed=0):
    """n completed trials of the mixed space with seeded values."""
    rng = np.random.default_rng(seed)
    space = space_of(JTU)
    return [(JTU.sample_config(space, rng), float(rng.uniform(0, 3))) for _ in range(n)]


# -- k-fold --------------------------------------------------------------------

@pytest.mark.parametrize("n,folds,seed", [(12, 4, 123456), (200, 6, 123456), (7, 3, 1)])
def test_kfold_split_equals_jax(n, folds, seed):
    port, ref = K.kfold_split(n, folds, seed=seed), JK.kfold_split(n, folds, seed=seed)
    assert len(port) == len(ref) == folds
    for (pt, pv), (jt, jv) in zip(port, ref):
        assert np.array_equal(pt, jt) and np.array_equal(pv, jv)
        assert set(pt).isdisjoint(pv) and len(pt) + len(pv) == n
    if (n, folds) == (12, 4):    # monai CrossValidation's membership (tests/test_tune_kfold.py)
        assert [v.tolist() for _, v in port] == [[8, 5, 11], [9, 6, 2], [4, 3, 10], [7, 0, 1]]
        assert port[1][0].tolist() == [8, 5, 11, 4, 3, 10, 7, 0, 1]


class FakeDS:
    patients = [f"pt_{i}" for i in range(12)]

    def __len__(self):
        return 12

    def __getitem__(self, i):
        return self.patients[i]


@pytest.mark.parametrize("start_fold", [0, 2])
def test_run_kfold_gives_both_packages_the_same_subsets(tmp_path, start_fold):
    def recorded(pkg):
        calls = []

        class Recording:
            def __init__(self, fold, ckpt_dir):
                self.fold, self.ckpt_dir = fold, ckpt_dir

            def fit(self, train_ds, val_ds):
                calls.append((self.fold, self.ckpt_dir, list(train_ds.patients),
                              [val_ds[i] for i in range(len(val_ds))]))

            def test(self, val_ds):
                return {"mean_dose_score": float(self.fold)}

        results = pkg.run_kfold(FakeDS(), Recording, n_folds=4, start_fold=start_fold,
                                base_dir=str(tmp_path))
        return calls, results

    port, ref = recorded(K), recorded(JK)
    assert port == ref
    calls, results = port
    assert [c[0] for c in calls] == list(range(start_fold, 4))
    assert calls[0][1] == str(tmp_path / f"fold_{start_fold}")
    assert all(len(train) + len(val) == 12 for _, _, train, val in calls)
    assert results[3]["mean_dose_score"] == 3.0


# -- samplers and schedulers ---------------------------------------------------

@pytest.mark.parametrize("kind", ["pyfer", "mixed"])
@pytest.mark.parametrize("seed", [0, 7])
def test_sample_config_equals_jax(kind, seed):
    rng = np.random.default_rng(seed)
    port = [TU.sample_config(space_of(TU, kind), rng) for _ in range(20)]
    rng = np.random.default_rng(seed)
    ref = [JTU.sample_config(space_of(JTU, kind), rng) for _ in range(20)]
    assert port == ref
    assert all(1e-4 <= c["lr"] <= 1e-1 for c in port)


@pytest.mark.parametrize("sampler", ["TPESampler", "GPSampler"])
@pytest.mark.parametrize("n_done", [2, 9])     # before and after n_startup
@pytest.mark.parametrize("mode", ["min", "max"])
def test_sampler_suggest_equals_jax(sampler, n_done, mode):
    history = history_of(n_done) + [(history_of(1, 5)[0][0], math.nan)]
    port = getattr(TU, sampler)(mode=mode, seed=3, n_startup=4)
    ref = getattr(JTU, sampler)(mode=mode, seed=3, n_startup=4)
    for _ in range(5):
        got = port.suggest(space_of(TU), history)
        assert got == ref.suggest(space_of(JTU), history)
        assert 1e-4 <= got["lr"] <= 1e-1 and 0.0 <= got["u"] <= 1.0
        assert got["act"] in ("relu", "mish") and got["fixed"] == 5


@pytest.mark.parametrize("mode", ["min", "max"])
def test_asha_decisions_equal_jax(mode):
    kw = dict(max_t=16, grace_period=2, reduction_factor=2, mode=mode)
    port, ref = TU.ASHAScheduler(**kw), JTU.ASHAScheduler(**kw)
    assert port.milestones() == ref.milestones() == [2, 4, 8]
    rng = np.random.default_rng(1)
    for tid in range(8):
        pt, jt = TU.Trial(tid, {}), JTU.Trial(tid, {})
        for epoch in range(1, 17):
            value = float(rng.uniform())
            stop = port.on_result(pt, epoch, value)
            assert stop == ref.on_result(jt, epoch, value)
            if stop:
                break
        assert (pt.stopped, pt.completed, pt.report_log) == (jt.stopped, jt.completed,
                                                             jt.report_log)
    assert port._rung_results == ref._rung_results


def population(pkg, n=6, seed=2):
    rng = np.random.default_rng(seed)
    trials = [pkg.Trial(i, {"lr": float(rng.uniform(1e-4, 1e-1)), "act": "mish"})
              for i in range(n)]
    for t in trials:
        t.last_value = float(rng.uniform())
    return trials


@pytest.mark.parametrize("kind", ["PopulationBasedScheduler", "PB2Scheduler"])
def test_exploit_moves_equal_jax(kind):
    kw = dict(population=6, perturbation_interval=2, seed=0, bounds={"lr": (1e-4, 1.0)})
    port, ref = getattr(TU, kind)(**kw), getattr(JTU, kind)(**kw)
    pts, jts = population(TU), population(JTU)
    for rnd in range(4):       # PB2's GP takes over from the fourth observation
        assert port.exploit_explore(pts) == ref.exploit_explore(jts)
        assert [t.config for t in pts] == [t.config for t in jts]
        for t, j in zip(pts, jts):
            t.last_value = j.last_value = float(np.log(t.config["lr"]) ** 2 + rnd)


@pytest.mark.parametrize("kind", ["pbt", "pb2", "transfer"])
def test_run_pbt_equals_jax(kind):
    def run(pkg):
        if kind == "transfer":    # the metric is the state: the exploit copies it
            sched = pkg.PopulationBasedScheduler(population=4, perturbation_interval=1,
                                                 quantile=0.25, seed=0,
                                                 bounds={"lr": (1e-4, 1.0)})
            return pkg.run_pbt(lambda c, st, e: (st, st["w"]), lambda c: {"w": c["lr"]},
                               space={"lr": pkg.LogUniform(1e-3, 1.0)}, scheduler=sched,
                               num_epochs=3)
        cls = pkg.PB2Scheduler if kind == "pb2" else pkg.PopulationBasedScheduler
        sched = cls(population=6, perturbation_interval=2, seed=0, bounds={"lr": (1e-4, 1.0)})
        return pkg.run_pbt(lambda c, st, e: (st, (np.log(c["lr"]) - np.log(1e-2)) ** 2),
                           lambda c: {}, space={"lr": pkg.LogUniform(1e-4, 1.0)},
                           scheduler=sched, num_epochs=10)

    port = run(TU)
    assert port == run(JTU)
    finals = [t["last_value"] for t in port["trials"]]
    assert port["best_value"] == min(finals)
    if kind == "transfer":       # two exploit rounds cloned the winner's state twice
        assert finals.count(min(finals)) >= 2


# -- run_search ---------------------------------------------------------------

def port_trial(fn):
    """A JAX-style ``train_trial(config, report)`` as the port's, which also
    takes the trial's device."""
    return lambda config, report, device: fn(config, report)


def search(pkg, fn, **kw):
    return pkg.run_search(port_trial(fn) if pkg is TU else fn, **kw)


def both(fn, **kw):
    """The same search in both packages: (port result, JAX result)."""
    return search(TU, fn, **kw), search(JTU, fn, **kw)


def quadratic(config, report):
    value = (np.log(config["lr"]) - np.log(1e-2)) ** 2 + (config.get("act") == "relu") * 0.1
    report(1, value)
    return value


@pytest.mark.parametrize("sampler", ["random", "tpe", "gp"])
def test_search_equals_jax(sampler):
    port, ref = (search(pkg, quadratic, space={"lr": pkg.LogUniform(1e-5, 1.0),
                                               "act": pkg.Choice(["relu", "mish"])},
                        num_samples=12, sampler=sampler, seed=4, mode="min",
                        scheduler=pkg.ASHAScheduler(max_t=1, mode="min"))
                 for pkg in (TU, JTU))
    assert port == ref and len(port["trials"]) == 12 and set(port["best_config"]) == {"lr", "act"}
    assert port["best_value"] == min(t["last_value"] for t in port["trials"])


@pytest.mark.parametrize("seed", [1, 3])
def test_asha_search_equals_jax_and_stops_early(seed):
    epochs_run = []

    def train_trial(config, report):
        for epoch in range(1, 17):
            if report(epoch, config["lr"]):
                epochs_run.append(epoch)
                return config["lr"]
        return config["lr"]

    port, ref = (search(pkg, train_trial, space=space_of(pkg, "lr"), num_samples=8,
                        scheduler=pkg.ASHAScheduler(max_t=16, grace_period=2,
                                                    reduction_factor=2, mode="min"),
                        seed=seed, mode="min") for pkg in (TU, JTU))
    assert port == ref
    assert any(e < 16 for e in epochs_run) and port["num_early_stopped"] > 0


def journal_lines(out):
    return (out / "trials.jsonl").read_text().splitlines()


def scenario_journal(pkg, out):
    calls = []

    def fn(config, report):
        calls.append(config["lr"])
        report(1, config["lr"])
        return config["lr"]

    kw = dict(space=space_of(pkg, "lr"), out_dir=str(out))
    first = search(pkg, fn, num_samples=3, seed=5, scheduler=pkg.ASHAScheduler(max_t=1), **kw)
    assert len(journal_lines(out)) == 3
    calls.clear()
    res = search(pkg, fn, num_samples=7, seed=5, resume=True,
                 scheduler=pkg.ASHAScheduler(max_t=1), **kw)
    assert len(calls) == 4 and len(journal_lines(out)) == 7
    assert [t["trial_id"] for t in res["trials"]] == list(range(7))
    assert res["trials"][:3] == first["trials"]
    search(pkg, fn, num_samples=2, seed=9, scheduler=pkg.ASHAScheduler(max_t=1), **kw)
    assert len(journal_lines(out)) == 2       # a fresh search truncates the journal
    return res


def scenario_asha_rungs(pkg, out):
    def values(vs):
        it = iter(vs)

        def fn(config, report):
            v = next(it)
            report(1, v)
            return v
        return fn

    kw = dict(space=space_of(pkg, "lr"), seed=0, out_dir=str(out))
    search(pkg, values([1.0, 2.0]), num_samples=2,
           scheduler=pkg.ASHAScheduler(max_t=10, grace_period=1), **kw)
    res = search(pkg, values([1.5]), num_samples=3, resume=True,
                 scheduler=pkg.ASHAScheduler(max_t=10, grace_period=1), **kw)
    assert res["trials"][2]["stopped"] is True and res["num_early_stopped"] == 2
    return res


def scenario_gapped_ids(pkg, out):
    out.mkdir()
    rows = [dict(trial_id=i, config={"lr": 0.01 * (i + 1)}, rung=0, last_value=float(i + 1),
                 stopped=False, completed=True, history=[float(i + 1)],
                 report_log=[[1, float(i + 1)]]) for i in (0, 2)]
    (out / "trials.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    ran = []

    def fn(config, report):
        ran.append(config["lr"])
        report(1, 5.0)
        return 5.0

    res = search(pkg, fn, space=space_of(pkg, "lr"), num_samples=4, seed=0, out_dir=str(out),
                 resume=True, scheduler=pkg.ASHAScheduler(max_t=1))
    assert len(ran) == 2 and sorted(t["trial_id"] for t in res["trials"]) == [0, 2, 3, 4]
    assert res["best_value"] == 1.0
    return res


def scenario_truncated_line(pkg, out):
    out.mkdir()
    good = dict(trial_id=0, config={"lr": 0.01}, rung=0, last_value=1.0, stopped=False,
                completed=True, history=[1.0], report_log=[[1, 1.0]])
    (out / "trials.jsonl").write_text(json.dumps(good) + "\n" + '{"trial_id": 1, "conf')

    def fn(config, report):
        report(1, 2.0)
        return 2.0

    res = search(pkg, fn, space=space_of(pkg, "lr"), num_samples=2, seed=0, out_dir=str(out),
                 resume=True, scheduler=pkg.ASHAScheduler(max_t=1))
    assert len(res["trials"]) == 2 and res["best_value"] == 1.0
    return res


def scenario_tpe_resume(pkg, out):
    def fn(config, report):
        report(1, config["lr"])
        return config["lr"]

    kw = dict(space=space_of(pkg, "lr"), seed=3, sampler="tpe", out_dir=str(out))
    search(pkg, fn, num_samples=2, scheduler=pkg.ASHAScheduler(max_t=1), **kw)
    res = search(pkg, fn, num_samples=4, resume=True, scheduler=pkg.ASHAScheduler(max_t=1), **kw)
    lrs = [t["config"]["lr"] for t in res["trials"]]
    assert len(lrs) == 4 and len(set(lrs)) == 4     # the startup draws fast-forwarded
    return res


def scenario_no_valid_trial(pkg, out):
    def fn(config, report):
        report(1, float("nan"))
        return float("nan")

    res = search(pkg, fn, space=space_of(pkg, "lr"), num_samples=2, seed=0, out_dir=str(out),
                 scheduler=pkg.ASHAScheduler(max_t=1))
    assert res["best_config"] is None and math.isnan(res["best_value"])
    assert len(res["trials"]) == 2 and (out / "search_results.json").exists()
    return res


def same_trials(a, b):
    """Trial records equal, NaN equal to NaN."""
    return json.dumps(a, sort_keys=True, default=str) == json.dumps(b, sort_keys=True,
                                                                     default=str)


@pytest.mark.parametrize("scenario", [scenario_journal, scenario_asha_rungs, scenario_gapped_ids,
                                      scenario_truncated_line, scenario_tpe_resume,
                                      scenario_no_valid_trial])
def test_search_scenario_equals_jax(tmp_path, scenario):
    port = scenario(TU, tmp_path / "port")
    ref = scenario(JTU, tmp_path / "jax")
    assert same_trials(port["trials"], ref["trials"])
    assert same_trials(port["best_config"], ref["best_config"])
    assert port["num_early_stopped"] == ref["num_early_stopped"]
    saved = [json.loads((tmp_path / d / "search_results.json").read_text())
             for d in ("port", "jax")]
    assert same_trials(*saved)


def test_concurrent_trials_run_on_distinct_devices():
    """max_concurrent > 1: trials run in threads, two of them at once (they
    meet at a barrier), and trial i is given devices[i % len(devices)]."""
    barrier = threading.Barrier(2)
    arrivals = itertools.count()
    seen, threads = {}, set()
    devices = [torch.device("cpu"), "device-1", "device-2", "device-3"]

    def train_trial(config, report, device):
        if next(arrivals) < 2:
            barrier.wait(timeout=30)
            threads.add(threading.get_ident())
        seen[config["lr"]] = device
        report(1, config["lr"])
        return config["lr"]

    res = TU.run_search(train_trial, space=space_of(TU, "lr"), num_samples=8, seed=0,
                        max_concurrent=4, devices=devices)
    assert len(res["trials"]) == 8 and len(threads) == 2
    assert {t["trial_id"]: seen[t["config"]["lr"]] for t in res["trials"]} == {
        i: devices[i % 4] for i in range(8)}
    assert res["best_value"] == min(t["last_value"] for t in res["trials"])


def test_serial_trials_get_the_given_device_or_none():
    got = []

    def train_trial(config, report, device):
        got.append(device)
        return config["lr"]

    TU.run_search(train_trial, space=space_of(TU, "lr"), num_samples=2, seed=0)
    TU.run_search(train_trial, space=space_of(TU, "lr"), num_samples=2, seed=0,
                  devices=[torch.device("cpu")])
    assert got == [None, None, torch.device("cpu"), torch.device("cpu")]


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default devices are the cards")
def test_concurrent_trials_without_a_card_or_devices_raise():
    with pytest.raises(RuntimeError, match="CUDA"):
        TU.run_search(lambda c, r, d: 0.0, space=space_of(TU, "lr"), num_samples=2,
                      max_concurrent=2)


# -- the MLflow bridge --------------------------------------------------------

class FakeMlflow:
    def __init__(self, as_context=True):
        self.metrics, self.runs, self.uri, self.experiment = [], [], None, None
        self.as_context, self.ended = as_context, 0

    def set_tracking_uri(self, uri):
        self.uri = uri

    def set_experiment(self, name):
        self.experiment = name

    def start_run(self, run_name=None):
        self.runs.append(run_name)
        return contextlib.nullcontext() if self.as_context else None

    def log_metric(self, k, v, step=0):
        self.metrics.append((k, v, step))

    def end_run(self):
        self.ended += 1


def write_metrics(path, run_name="pyfer"):
    logger = MetricLogger(path, run_name=run_name, mirror_stdout=False)
    logger.log({"train_mean_loss": 1.5}, 1)
    logger.log({"mean_dose_score": -2.5, "val_loss": 0.3}, 5)
    logger.close()
    return path / "metrics.jsonl"


def test_export_jsonl_replays_keys_and_steps_as_jax_does(tmp_path):
    from dose_prediction_tpu.utils.mlflow_export import export_jsonl as jax_export

    jsonl = write_metrics(tmp_path)
    port, ref = FakeMlflow(), FakeMlflow()
    n = MX.export_jsonl(jsonl, tracking_uri="http://x", experiment="dose", client=port)
    assert n == jax_export(jsonl, tracking_uri="http://x", experiment="dose", client=ref) == 3
    assert vars(port) == vars(ref)
    assert port.uri == "http://x" and port.runs == ["pyfer"]
    assert ("train_mean_loss", 1.5, 1) in port.metrics
    assert ("mean_dose_score", -2.5, 5) in port.metrics


def test_mlflow_mirror_forwards_each_log(tmp_path):
    fake = FakeMlflow(as_context=False)
    mirror = MX.MlflowMirror(MetricLogger(tmp_path, run_name="c3d", mirror_stdout=False),
                             tracking_uri="http://y", client=fake)
    mirror.log({"train_mean_loss": 0.7}, 2)
    mirror.log_text("epoch 2")
    assert fake.runs == ["c3d"] and fake.uri == "http://y"
    assert fake.metrics == [("train_mean_loss", 0.7, 2)]
    assert mirror.run_name == "c3d"           # the logger's attributes pass through
    mirror.close()
    assert fake.ended == 1
    assert json.loads((tmp_path / "metrics.jsonl").read_text())["train_mean_loss"] == 0.7
    assert (tmp_path / "log.txt").read_text() == "epoch 2\n"


def test_mlflow_bridge_without_mlflow_says_so(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "mlflow", None)      # import mlflow raises
    jsonl = write_metrics(tmp_path)
    with pytest.raises(ImportError, match="mlflow is not installed"):
        MX.export_jsonl(jsonl)
    with pytest.raises(ImportError, match="mlflow is not installed"):
        MX.MlflowMirror(MetricLogger(tmp_path / "m", mirror_stdout=False))


def test_mlflow_export_main(tmp_path, monkeypatch, capsys):
    fake = FakeMlflow()
    monkeypatch.setitem(sys.modules, "mlflow", fake)
    jsonl = write_metrics(tmp_path)
    assert MX.main([str(jsonl), "--tracking-uri", "http://z", "--run-name", "r1"]) == 0
    assert capsys.readouterr().out.strip() == "exported 3 metric points"
    assert fake.runs == ["r1"] and fake.uri == "http://z" and len(fake.metrics) == 3
