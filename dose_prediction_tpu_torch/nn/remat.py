"""Rematerialisation (counterpart of ``jax.checkpoint`` / ``flax.linen.remat``
in the JAX package's train step and decoders).

``checkpoint(fn, *args)`` runs ``fn`` through
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: its
activations are dropped after the forward and recomputed in the backward.
A recompute must not update BatchNorm running statistics a second time
(flax's remat discards the recomputed ``batch_stats``): ``fn``'s first call
is the forward, every later call a recompute, and ``updates_batch_stats()``
is False inside a recompute, which ``nn/layers.py::BatchNorm3d`` reads.
The flag is a context variable set inside the call itself, so it holds in
whichever thread autograd runs the recompute. No model of the port draws
random numbers in its forward, so the recompute restores no generator
state; reading a CUDA generator's state is refused while a CUDA graph is
captured (infer/aot.py::LazyTrainStage).
"""

from __future__ import annotations

import contextvars
from typing import Callable

import torch
from torch.utils import checkpoint as torch_checkpoint

_RECOMPUTING = contextvars.ContextVar("dpt_remat_recomputing", default=False)


def updates_batch_stats() -> bool:
    """False while a checkpointed function is being recomputed."""
    return not _RECOMPUTING.get()


def checkpoint(fn: Callable, *args: torch.Tensor, enabled: bool = True):
    """``fn(*args)`` with its activations recomputed in the backward; where
    autograd records nothing, or not ``enabled``, a plain call."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    calls = [0]

    def run(*inputs):
        calls[0] += 1
        token = _RECOMPUTING.set(calls[0] > 1 or _RECOMPUTING.get())
        try:
            return fn(*inputs)
        finally:
            _RECOMPUTING.reset(token)

    return torch_checkpoint.checkpoint(run, *args, use_reentrant=False,
                                       preserve_rng_state=False)
