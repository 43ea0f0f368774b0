"""Profiling hooks (counterpart of dose_prediction_tpu/utils/profiling.py:
trace :16, step_annotation :43, StepTimer :65): torch.profiler traces,
named ranges and per-step timing that waits for the card."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Record a torch.profiler trace of the body (host and, where a card is
    present, CUDA activity) into ``log_dir`` as a chrome trace
    (``*.pt.trace.json``, which TensorBoard's profiler plugin also reads);
    nothing when ``log_dir`` is None. An exception of the body propagates."""
    if log_dir is None:
        yield
        return
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))):
        yield


@contextlib.contextmanager
def step_annotation(name: str) -> Iterator[None]:
    """A named range: a ``record_function`` span in a torch.profiler trace
    and, where a card is present, an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Per-step host timing; ``stop`` synchronizes the card first (where one
    is present), so a step's queued kernels are inside its time. Collects
    p50/p90."""

    def __init__(self):
        self.samples: list[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.samples.append(time.perf_counter() - (self._t0 or time.perf_counter()))

    def summary(self) -> dict:
        if not self.samples:
            return {}
        return {
            "p50_s": float(np.percentile(self.samples, 50)),
            "p90_s": float(np.percentile(self.samples, 90)),
            "mean_s": float(np.mean(self.samples)),
            "n": len(self.samples),
        }
