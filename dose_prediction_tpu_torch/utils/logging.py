"""Metric logging and the per-epoch timing report (counterpart of
dose_prediction_tpu/utils/logging.py: MetricLogger :20, EpochTimer :61).

- MLflow metric streams of the reference (train_light_pyfer.py:316-326) →
  a local ``metrics.jsonl`` with the same metric keys;
- NetworkTrainer's log.txt report with timers (network_trainer.py:288-338)
  → EpochTimer and a console/file mirror.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional, TextIO


def _process_suffix() -> str:
    """'' on rank 0 or without torch.distributed, '.p<rank>' otherwise: ranks
    that share a log directory never interleave records in one file."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        return f".p{dist.get_rank()}"
    return ""


class MetricLogger:
    """Append-only JSONL metric log, mirrored to stdout."""

    def __init__(self, directory: str | Path, *, run_name: str = "run",
                 mirror_stdout: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / f"metrics{_process_suffix()}.jsonl"
        self._f: TextIO = open(self.path, "a")
        self.run_name = run_name
        self.mirror = mirror_stdout

    def log(self, metrics: Dict[str, float], step: int) -> None:
        rec = {"step": int(step), "time": time.time(), "run": self.run_name}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.mirror:
            kv = " ".join(f"{k}={float(v):.6g}" for k, v in metrics.items())
            print(f"[{self.run_name} step {step}] {kv}", file=sys.stdout, flush=True)

    def log_text(self, text: str) -> None:
        with open(self.dir / "log.txt", "a") as f:
            f.write(text.rstrip() + "\n")
        if self.mirror:
            print(text, flush=True)

    def close(self) -> None:
        self._f.close()


class EpochTimer:
    """Train / data-loading / validation wall time per epoch (TrainerTime,
    network_trainer.py:73-83)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.train_s = 0.0
        self.loader_s = 0.0
        self.val_s = 0.0
        self._t0: Optional[float] = None

    def tick(self):
        self._t0 = time.perf_counter()

    def tock(self, bucket: str):
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        setattr(self, bucket + "_s", getattr(self, bucket + "_s") + dt)
        self._t0 = None

    def report(self) -> str:
        return (f"train {self.train_s:.1f}s (loader {self.loader_s:.1f}s), "
                f"val {self.val_s:.1f}s")
