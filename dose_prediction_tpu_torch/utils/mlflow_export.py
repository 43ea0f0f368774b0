"""metrics.jsonl to MLflow (counterpart of
dose_prediction_tpu/utils/mlflow_export.py).

The reference logs every metric to an MLflow tracking server
(``MLFlowLogger(tracking_uri="databricks")``, train_light_pyfer.py:316-326);
the port logs to a local ``metrics.jsonl`` (utils/logging.py). Two bridges
for a team that runs a tracking server:

- ``export_jsonl(path, tracking_uri=..., experiment=...)`` replays a
  metrics.jsonl into one MLflow run with the reference's metric keys and
  step numbers; also a command:
  ``python -m dose_prediction_tpu_torch.utils.mlflow_export logs/metrics.jsonl
  --tracking-uri http://mlflow:5000 --experiment dose``;
- ``MlflowMirror(trainer.logger, ...)`` mirrors each ``log()`` to the server
  as it happens.

mlflow is not a dependency: both import it when called, and raise an
ImportError saying so where it is absent.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional


def _require_mlflow():
    try:
        import mlflow
    except ImportError as e:
        raise ImportError("mlflow is not installed; install it (pip install mlflow) to export "
                          "metrics to a tracking server, or keep using the local "
                          "metrics.jsonl") from e
    return mlflow


def read_jsonl(path: str | Path):
    """The metric records of a metrics.jsonl."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def _connect(ml, tracking_uri: Optional[str], experiment: Optional[str]):
    if tracking_uri:
        ml.set_tracking_uri(tracking_uri)
    if experiment:
        ml.set_experiment(experiment)
    return ml


def export_jsonl(path: str | Path, *, tracking_uri: Optional[str] = None,
                 experiment: Optional[str] = None, run_name: Optional[str] = None,
                 client=None) -> int:
    """Replay a metrics.jsonl into one MLflow run; the number of metric
    points logged. ``client`` stands in for the mlflow module (tests)."""
    ml = _connect(client if client is not None else _require_mlflow(), tracking_uri, experiment)
    first = next(iter(read_jsonl(path)), None)
    n = 0
    with ml.start_run(run_name=run_name or (first or {}).get("run", "dose_prediction_tpu_torch")):
        for rec in read_jsonl(path):
            step = int(rec.get("step", 0))
            for k, v in rec.items():
                if k not in ("step", "time", "run"):
                    ml.log_metric(k, float(v), step=step)
                    n += 1
    return n


class MlflowMirror:
    """A MetricLogger whose every ``log()`` also goes to MLflow:

    >>> trainer.logger = MlflowMirror(trainer.logger, tracking_uri=...)
    """

    def __init__(self, logger, *, tracking_uri: Optional[str] = None,
                 experiment: Optional[str] = None, client=None):
        self._logger = logger
        self._ml = _connect(client if client is not None else _require_mlflow(),
                            tracking_uri, experiment)
        self._run = self._ml.start_run(run_name=logger.run_name)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        self._logger.log(metrics, step)
        for k, v in metrics.items():
            self._ml.log_metric(k, float(v), step=int(step))

    def log_text(self, text: str) -> None:
        self._logger.log_text(text)

    def close(self) -> None:
        self._ml.end_run()
        self._logger.close()

    def __getattr__(self, name):
        return getattr(self._logger, name)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Replay a metrics.jsonl into MLflow")
    ap.add_argument("jsonl", help="path to metrics.jsonl")
    ap.add_argument("--tracking-uri", default=None)
    ap.add_argument("--experiment", default=None)
    ap.add_argument("--run-name", default=None)
    args = ap.parse_args(argv)
    n = export_jsonl(args.jsonl, tracking_uri=args.tracking_uri, experiment=args.experiment,
                     run_name=args.run_name)
    print(f"exported {n} metric points")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
