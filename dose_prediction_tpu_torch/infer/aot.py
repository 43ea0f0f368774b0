"""The captured serve path and train step (counterpart of
dose_prediction_tpu/infer/aot.py).

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

Environment knob: ``DPT_NO_AOT=1`` runs the eager stages and train steps
instead.

The train half. The JAX package ships train-step executables for the CLI's
quick-starts and wraps the trainers' steps in them (``maybe_wrap_train_step``,
trainers.py:547 and :1047). The port captures the step itself: a
``LazyTrainStage`` holds a CUDA graph of a whole train step (forward,
backward, optimizer update, moving loss) per key (``train_key``), made from
the trainer's own step at its first call, and ``maybe_wrap_train_step``
wraps the DOSE-PYFER and TranSeg trainers' steps in one on the card. The
rest of the JAX train half has no counterpart: ``load_train_aot``,
``train_artifact_path`` and ``init_artifact_path`` because a graph cannot
be shipped; ``train_spec``, ``spec_key`` and ``canonical_spec`` because
they gate a shipped program against the trainer's config, and an
in-process capture is made from that config's own step, so there is
nothing to gate; ``maybe_init_train_state`` because initialising a model
and an optimizer compiles nothing in PyTorch.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Callable, Mapping, Optional

import torch

from dose_prediction_tpu_torch.core.config import FLAGS
from dose_prediction_tpu_torch.kernels import attention, conv3d, instance_norm

# held while a train step is captured (LazyTrainStage._graph)
_CAPTURE_LOCK = threading.Lock()

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


class _TrainCapture:
    def __init__(self, graph, inputs, moving_in, moving_out, loss, launches):
        self.graph, self.inputs, self.launches = graph, inputs, launches
        self.moving_in, self.moving_out, self.loss = moving_in, moving_out, loss


def train_key(state, batch: Mapping[str, torch.Tensor]) -> tuple:
    """The key a train step is captured and looked up under: the batch
    tensors' names, shapes, dtypes and device; the moving loss's dtype and
    device; the optimizer's MultiSteps phase and the hyperparameters a graph
    bakes in (b1, b2, eps, weight decay, the clip norm); which parameters
    train; the addresses of every parameter, buffer and optimizer-state
    tensor (a restore that replaces optimizer state, a PBT exploit or
    surgery that replaces a tensor therefore captures again); the routing
    flags and cuDNN's and the matmuls' switches (TF32, cuDNN's deterministic
    and benchmark modes), which choose the kernels a graph records. The
    learning rate, the bias corrections and MultiSteps' divisor reach the
    graph through the optimizer's ``scalars`` and are not in it."""
    opt = state.optimizer
    tensors = [*state.model.parameters(), *state.model.buffers(), *opt.state_tensors()]
    hyper = tuple(tuple(g[k] for k in ("b1", "b2", "eps", "weight_decay"))
                  for g in opt.param_groups)
    return (tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in sorted(batch.items())),
            (state.moving_loss.dtype, state.moving_loss.device), opt.mini_step, hyper,
            opt.grad_clip_norm, tuple(p.requires_grad for p in state.model.parameters()),
            tuple(t.data_ptr() for t in tensors), FLAGS.use_k1_attention,
            FLAGS.use_k2_instance_norm, FLAGS.use_k3_conv3d, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)


class LazyTrainStage:
    """A train step, ``step(state, batch) -> (state, loss)`` of
    train/steps.py, captured as a CUDA graph at its first call under each
    key (``train_key``) and replayed afterwards.

    The first call under a key runs the eager step for real on a side
    stream and returns its result: the warm-up, which also makes the
    optimizer's state, builds the kernel library and settles cuDNN's
    choices. The stage then captures the step, which records it without
    running it, and undoes what the capture moved on the host: the
    optimizer's count, MultiSteps' phase and rates (``host_state``) and the
    kernels' launch counters. A later call copies the batch and the moving
    loss into the graph's buffers, runs the optimizer's host half
    (``advance``: the phase, the count, this update's scalars written to the
    card), replays, credits the kernels' launches, and returns a clone of
    the loss with a state whose step (on the host) and moving loss moved on.
    With ``grad_accum=k`` each of the k phases has its graph.

    The stage's graphs share one memory pool and one capture stream (the
    caching allocator reuses a block only on the stream it was freed on):
    each replay's outputs are cloned before another replay, and nothing that
    lives from one step to the next lies in the pool (the optimizer's state
    is made before the first capture, ``materialize``). A capture that
    fails raises, naming the stage; CPU tensors raise; ``DPT_NO_AOT=1`` runs
    the eager step. ``used_aot``, ``captures`` and ``capture_s`` as
    LazyAOTStage's."""

    def __init__(self, name: str, step: Callable):
        self.name = name
        self.step = step
        self.used_aot: Optional[bool] = None
        self.capture_s: list = []
        self._graphs: dict = {}
        self._pool = GraphPool()
        self._streams: dict = {}

    @property
    def captures(self) -> int:
        return len(self.capture_s)

    def __call__(self, state, batch: Mapping[str, torch.Tensor]):
        device = _require_cuda(self.name, (batch, state.moving_loss))
        if disabled():
            self.used_aot = False
            return self.step(state, batch)
        opt = state.optimizer
        opt.materialize()
        key = train_key(state, batch)
        cap = self._graphs.get(key)
        if cap is None:
            out = self._capture(key, device, state, batch)
        else:
            with torch.cuda.device(device):
                for k, buf in cap.inputs.items():
                    buf.copy_(batch[k])
                cap.moving_in.copy_(state.moving_loss)
                opt.advance()
                cap.graph.replay()
            _add_counts(cap.launches)
            out = (dataclasses.replace(state, step=state.step + 1,
                                       moving_loss=cap.moving_out.clone()), cap.loss.clone())
        self.used_aot = True
        return out

    def _capture(self, key, device: torch.device, state, batch):
        t0 = time.perf_counter()
        opt = state.optimizer
        inputs = {k: v.clone() for k, v in batch.items()}
        moving_in = state.moving_loss.clone()
        host, warm = opt.host_state(), None
        with torch.cuda.device(device):
            current = torch.cuda.current_stream()
            if device not in self._streams:
                self._streams[device] = torch.cuda.Stream()
            side = self._streams[device]
            side.wait_stream(current)
            try:
                with torch.cuda.stream(side):
                    out = self.step(state, batch)            # the warm-up: this call's step
                warm, before = opt.host_state(), _counts()
                opt.set_host_state(host)
                graph, (static, loss) = self._graph(side, device, lambda: self.step(
                    dataclasses.replace(state, moving_loss=moving_in), inputs))
            except Exception as e:
                raise RuntimeError(f"captured stage {self.name!r}: capture failed: "
                                   f"{type(e).__name__}: {e}") from e
            finally:
                if warm is not None:
                    opt.set_host_state(warm)
            current.wait_stream(side)
        launches = [b - a for a, b in zip(before, _counts())]
        _add_counts([-n for n in launches])       # recorded, not launched
        self._graphs[key] = _TrainCapture(graph, inputs, moving_in, static.moving_loss, loss,
                                          launches)
        self.capture_s.append(time.perf_counter() - t0)
        return out

    def _graph(self, stream, device: torch.device, fn: Callable):
        """``fn()`` captured on ``stream`` into a graph of the stage's pool:
        (the graph, ``fn``'s outputs, which each replay overwrites)."""
        graph = torch.cuda.CUDAGraph()
        # thread_local: concurrent trials on one card (train/tune.py) launch
        # from their own threads while this one captures. One capture at a
        # time: entering one synchronizes the device and empties the
        # allocator's cache. The likely cause, not shown, of the one
        # cudaErrorStreamCaptureInvalidated seen at a trial's first captured
        # op is that sync reaching another thread's capture in flight; the
        # train path calls no other synchronize or empty_cache
        # (tests/test_torch_port_cuda.py::test_concurrent_trial_captures_on_card).
        # Not covered: a draw from the default CUDA generator in another
        # thread during a capture raises (the generator is in capture mode
        # for the whole process)
        with _CAPTURE_LOCK, torch.cuda.graph(graph, pool=self._pool.handle(device),
                                             stream=stream, capture_error_mode="thread_local"):
            out = fn()
        return graph, out


def maybe_wrap_train_step(kind: str, model: torch.nn.Module, step: Callable,
                          mesh=None) -> Callable:
    """Trainer hook (the JAX one, :411-425): on the card, ``step`` as a
    LazyTrainStage named ``train:<kind>``; for a model on the CPU, on a
    ``mesh`` (a step that holds collectives is not captured; the JAX hook
    returns its jit step for a mesh, :411-416), or under ``DPT_NO_AOT=1``,
    ``step`` itself. The JAX hook's config and example shape select a
    shipped program; a capture reads its key from each call's batch and
    state instead."""
    if disabled() or mesh is not None or next(model.parameters()).device.type != "cuda":
        return step
    return LazyTrainStage(f"train:{kind}", step)
