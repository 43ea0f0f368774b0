"""The captured serve path (counterpart of dose_prediction_tpu/infer/aot.py).

The JAX package ships its serve programs compiled ahead of time and loads
them at the first request. A CUDA graph cannot be shipped: it holds the
addresses of the process that captured it. So the port captures each serve
stage on the card at its first call and replays it afterwards: one launch
from the host replays the stage's two thousand or so kernels (the kernels
K1, K2 and, when routed, K3 among them, the same hand-written kernels the
eager stage launches). Nothing is read from ``artifacts/``.

A ``LazyAOTStage`` keys each capture by the inputs' shapes, dtypes and
device, the routing flags of core/config.py::FLAGS (a graph bakes in the
route it was captured under) and the addresses of the bound variables (a
graph reads them where they were). A call under a new key captures again;
a captured key replays. Each capture is warmed up first on a side stream,
as ``torch.cuda.graph`` requires, which also builds and loads the kernel
library and settles cuDNN's choice of algorithm outside the graph. A
replay copies the inputs into the graph's static buffers and returns a new
tensor, never the graph's own output, which the next replay overwrites.
The kernels' launch counters count Python calls, and a replay makes none:
a capture records each kernel's launches and every replay adds them.

A capture that fails raises, naming the stage: a host synchronisation in a
stage (``.item()``, a shape that depends on data) or a kernel that does not
launch. Nothing falls back to the eager stage, and CPU tensors raise: a
graph needs the card, and the eager stages are the caller's to call.

Environment knob: ``DPT_NO_AOT=1`` runs the eager stages instead.

The train half of the JAX module (``train_spec``, ``load_train_aot``,
``maybe_wrap_train_step``, ``maybe_init_train_state``) is not ported: a
captured train step needs a capturable optimizer step (ROADMAP queue 1
item 7).
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Mapping, Optional

import torch

from dose_prediction_tpu_torch.core.config import FLAGS
from dose_prediction_tpu_torch.kernels import attention, conv3d, instance_norm

# the kernels' launch counters, credited at every replay
_COUNTERS = ((attention.fused_attention, "launches"),
             (instance_norm.instance_norm_act, "launches"),
             (instance_norm.instance_norm_act, "two_kernel_launches"),
             (conv3d.conv3d_k3, "launches"))


def disabled() -> bool:
    return os.environ.get("DPT_NO_AOT") == "1"


def build_info(device_name: Optional[str] = None,
               capability: Optional[tuple] = None) -> dict:
    """The versions, the card and the kernel sources a capture is made
    against. ``device_name`` and ``capability``, where given, are used
    instead of asking the card (cli/doctor.py's probe learns them in a
    subprocess)."""
    from dose_prediction_tpu_torch.kernels import cuda_lib

    if device_name is None and torch.cuda.is_available():
        device_name = torch.cuda.get_device_name(0)
        capability = torch.cuda.get_device_capability(0)
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device_name": device_name or "none",
            "capability": list(capability) if capability else None,
            "kernel_sources": cuda_lib.source_hash()}


def capture_key(args) -> tuple:
    """The key a capture is made and looked up under: each tensor argument's
    shape, dtype and device, each mapping argument's (bound variables')
    names, addresses, shapes and dtypes, any other argument's value, and the
    three routing flags."""
    parts = []
    for a in args:
        if isinstance(a, torch.Tensor):
            parts.append((tuple(a.shape), a.dtype, a.device))
        elif isinstance(a, Mapping):
            parts.append(tuple((k, v.data_ptr(), tuple(v.shape), v.dtype, v.device)
                               for k, v in a.items()))
        else:
            parts.append(a)
    return (tuple(parts), FLAGS.use_k1_attention, FLAGS.use_k2_instance_norm,
            FLAGS.use_k3_conv3d)


def _require_cuda(name: str, args) -> torch.device:
    """The device of the stage's tensors; anything but one CUDA device raises."""
    devices = {t.device for a in args
               for t in ((a,) if isinstance(a, torch.Tensor) else
                         a.values() if isinstance(a, Mapping) else ())}
    for d in devices:
        if d.type != "cuda":
            raise ValueError(f"captured stage {name!r}: a CUDA graph needs CUDA tensors, got "
                             f"one on {d}; call the eager stages for the CPU")
    if len(devices) != 1:
        raise ValueError(f"captured stage {name!r}: tensors on {sorted(map(str, devices))}, "
                         "want one CUDA device")
    return devices.pop()


def _counts() -> list:
    return [getattr(f, field) for f, field in _COUNTERS]


def _add_counts(delta) -> None:
    for (f, field), n in zip(_COUNTERS, delta):
        setattr(f, field, getattr(f, field) + n)


class GraphPool:
    """One graph memory pool per device, shared by the stages that take it.
    Stages that share a pool must replay on one stream: a replay may reuse
    another graph's scratch memory, which is safe only because every replay
    reads its inputs from its own buffers and its output is copied out
    before the next one runs."""

    def __init__(self):
        self._handles = {}

    def handle(self, device: torch.device):
        if device not in self._handles:
            self._handles[device] = torch.cuda.graph_pool_handle()
        return self._handles[device]


class _Capture:
    def __init__(self, graph, inputs, output, launches):
        self.graph, self.inputs, self.output, self.launches = graph, inputs, output, launches


class LazyAOTStage:
    """A serve stage, ``eager_fn(*args) -> tensor``, captured as a CUDA
    graph at its first call under each key (``capture_key``) and replayed
    afterwards. Tensor arguments are copied into the graph's buffers at each
    call; mapping arguments (the state dicts the stage applies) are bound
    where they lie. Runs without autograd. ``pool`` (a GraphPool) shares
    graph memory with other stages replayed on the same stream.

    ``used_aot`` is None until the first call, then whether the stage runs
    captured (False under ``DPT_NO_AOT=1``); ``captures`` counts captures
    and ``capture_s`` holds each one's seconds (warm-up included)."""

    def __init__(self, name: str, eager_fn: Callable, *, pool: Optional[GraphPool] = None):
        self.name = name
        self.eager_fn = eager_fn
        self.pool = pool
        self.used_aot: Optional[bool] = None
        self.capture_s: list = []
        self._graphs: dict = {}

    @property
    def captures(self) -> int:
        return len(self.capture_s)

    @torch.inference_mode()
    def __call__(self, *args) -> Any:
        device = _require_cuda(self.name, args)
        if disabled():
            self.used_aot = False
            return self.eager_fn(*args)
        key = capture_key(args)
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._graphs[key] = self._capture(device, args)
        with torch.cuda.device(device):
            for buf, a in zip(cap.inputs, args):
                if buf is not None:
                    buf.copy_(a)
            cap.graph.replay()
        _add_counts(cap.launches)
        self.used_aot = True
        return cap.output.clone()

    def _capture(self, device: torch.device, args) -> _Capture:
        t0 = time.perf_counter()
        inputs = [a.clone() if isinstance(a, torch.Tensor) else None for a in args]
        static = [a if b is None else b for a, b in zip(args, inputs)]
        pool = None if self.pool is None else self.pool.handle(device)
        with torch.cuda.device(device):
            current, side = torch.cuda.current_stream(), torch.cuda.Stream()
            side.wait_stream(current)
            try:
                with torch.cuda.stream(side):
                    self.eager_fn(*static)                   # the warm-up
                before = _counts()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool, stream=side):
                    output = self.eager_fn(*static)
            except Exception as e:
                raise RuntimeError(f"captured stage {self.name!r}: capture failed: "
                                   f"{type(e).__name__}: {e}") from e
            current.wait_stream(side)
        if not isinstance(output, torch.Tensor):
            raise TypeError(f"captured stage {self.name!r} returns a tensor, got "
                            f"{type(output).__name__}")
        after = _counts()
        launches = [b - a for a, b in zip(before, after)]
        _add_counts([-n for n in launches])       # recorded, not launched
        self.capture_s.append(time.perf_counter() - t0)
        return _Capture(graph, inputs, output, launches)

