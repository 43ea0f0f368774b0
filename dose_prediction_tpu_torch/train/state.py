"""Train state, freeze labels, optimizers and learning-rate schedules
(counterpart of dose_prediction_tpu/train/state.py).

The JAX package builds its optimizers from optax; the port writes the same
update rules as ``torch.optim.Optimizer``s that update every trainable leaf
with multi-tensor (``torch._foreach_*``) operations, the port's form of the
one fused program XLA makes of an optax update:

- ``make_optimizer``: optionally ``optax.clip_by_global_norm`` over the
  trainable gradients, then ``optax.adam`` / ``optax.adamw`` (or the
  block-wise 8-bit Adam of train/adam8bit.py), optionally behind
  ``optax.MultiSteps`` (``grad_accum``);
- ``make_split_lr_optimizer``: encoder and decoder leaves at their own
  learning rates;
- ``make_plateau_optimizer``: a learning rate that ``set_learning_rate``
  rewrites between steps, driven by a host-side ``ReduceLROnPlateau``.

A learning rate is a float or a schedule of optax's update count
(``multistep_schedule``, ``cosine_schedule``). A step reads nothing on the
host: each update's scalars (the learning rate, the two bias corrections
and MultiSteps' divisor) are computed on the host in float32 and written
to the card, and the moving loss is a tensor there, so that a CUDA graph
of a whole step (infer/aot.py::LazyTrainStage) replays with each update's
own scalars. Freezing sets
``requires_grad=False``, so a frozen parameter gets no gradient, no update
and no weight decay (``optax.set_to_zero``). A trainable parameter without
a gradient is updated with a zero gradient, as optax updates every leaf it
is given: its moments decay and weight decay still shrinks it.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import struct
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

from dose_prediction_tpu_torch.parallel.collectives import all_reduce_

OPTIMIZERS = ("adamw", "adam", "adam8bit")
# a schedule maps optax's update count to a float32 learning rate
Schedule = Callable[[int], torch.Tensor]
LearningRate = Union[float, Schedule]


@dataclasses.dataclass
class TrainState:
    """What a step updates: the step count (on the host) and the moving loss
    (on the card); the model and optimizer are updated in place."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    # EMA of the train loss (eps 0.01, network_trainer.py:162-168): a 0-d
    # float32 tensor on the model's device; a number given here is put there
    moving_loss: Union[float, torch.Tensor] = math.nan
    # on a mesh, parallel/mesh.py::shard_params's plan: a checkpoint gathers
    # the split leaves whole (core/checkpoint.py)
    plan: Optional[object] = None

    def __post_init__(self):
        if not torch.is_tensor(self.moving_loss):
            first = next(itertools.chain(self.model.parameters(), self.model.buffers()), None)
            self.moving_loss = torch.tensor(float(self.moving_loss), dtype=torch.float32,
                                            device=None if first is None else first.device)


def update_moving_loss(moving: Union[float, torch.Tensor], loss: Union[float, torch.Tensor],
                       eps: float = 0.01) -> torch.Tensor:
    """EMA train loss in float32 on ``moving``'s device (state.py:277-279):
    the first loss seeds it, chosen by ``torch.where`` so that nothing is
    read on the host."""
    moving = torch.as_tensor(moving, dtype=torch.float32)
    loss = torch.as_tensor(loss, dtype=torch.float32, device=moving.device)
    return torch.where(torch.isnan(moving), loss, (1 - eps) * moving + eps * loss)


def label_params_by_name(model: nn.Module, frozen_if: Callable[[Sequence[str]], bool]
                         ) -> Dict[str, str]:
    """'frozen' / 'trainable' for each parameter from the components of its
    name (state.py:44-54 labels flax paths the same way)."""
    return {n: "frozen" if frozen_if(n.split(".")) else "trainable"
            for n, _ in model.named_parameters()}


def cascade_freeze_labels(model: nn.Module) -> Dict[str, str]:
    """'frozen' for every parameter under net_A or conv_out_A, 'trainable'
    for the rest (state.py:57-62; train_light_pyfer.py:85-88)."""
    return label_params_by_name(model, lambda keys: any(k in ("net_A", "conv_out_A")
                                                        for k in keys))


def encoder_labels(model: nn.Module, encoder_key: str = "encoder") -> Dict[str, str]:
    """'enc' for each parameter with a name component containing
    ``encoder_key``, 'dec' for the rest (state.py:128-137)."""
    frozen = label_params_by_name(model, lambda keys: any(encoder_key in k for k in keys))
    return {n: "enc" if label == "frozen" else "dec" for n, label in frozen.items()}


def _f32(x: float) -> float:
    """``x`` rounded to float32 (a scalar that a float32 kernel takes as is),
    in host arithmetic."""
    return struct.unpack("f", struct.pack("f", x))[0]


def _capturing(t: torch.Tensor) -> bool:
    """Whether work on ``t``'s device is being captured into a CUDA graph."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


class _Optimizer(torch.optim.Optimizer):
    """What every optimizer here shares: one update count for the whole
    optimizer (optax's ``count``), global-norm clipping in optax's order,
    gradient accumulation as ``optax.MultiSteps`` and the plateau's
    adjustable learning rate.

    A call has a host half, ``advance``, and a device half. The host half
    moves MultiSteps' phase and the count, computes the update's scalars in
    float32 (per group the negated learning rate and the bias corrections
    ``1 − b1^t``, ``1 − b2^t``; MultiSteps' divisor ``n + 1``) and writes
    them into ``scalars``, a float32 tensor on the parameters' device; the
    device half reads them from there. While a CUDA graph is captured the
    write is left out: a replay's scalars are written before it
    (infer/aot.py::LazyTrainStage). Subclasses write ``_scalars(group)``
    (the group's rate and bias corrections at the count), ``_init_state``
    (the state the first update would create) and ``_update(group, params,
    grads, scalars)`` for one group's trainable leaves (a gradient of None
    is zeros)."""

    def __init__(self, params, defaults: dict, *, grad_clip_norm: Optional[float] = None,
                 grad_accum: int = 1, injectable: bool = False):
        super().__init__(params, defaults)
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be at least 1, got {grad_accum}")
        self.grad_clip_norm = grad_clip_norm
        self.grad_accum = grad_accum
        self.injectable = injectable
        self.count = 0           # inner updates (optax's count): emits only
        self.mini_step = 0       # MultiSteps' mini_step
        self.scalars: Optional[torch.Tensor] = None
        self.plan = None         # parallel/mesh.py::ShardPlan, set by distribute()

    def distribute(self, plan) -> None:
        """Train over ``plan.mesh`` (parallel/mesh.py::shard_params's plan):
        each call first sums the gradients over the 'data' axis (each rank's
        loss being its share of the global batch's), in one all-reduce over
        the optimizer's gradient lists, then gives every rank of the 'model'
        axis the gradients of the replicated leaves of its first rank (one
        broadcast; they are equal but where a kernel sums in a
        nondeterministic order, and the replicas must not drift apart); the
        clip's norm is that of the whole leaves."""
        self.plan = plan

    def _groups(self):
        return [(g, [p for p in g["params"] if p.requires_grad]) for g in self.param_groups]

    def materialize(self) -> None:
        """Create now what the first update would create: ``scalars``,
        MultiSteps' buffers and the subclass's state (zeros, as the first
        update makes them). A capture is keyed by these tensors' addresses,
        so they must exist before the first one."""
        if self.scalars is None:
            self.scalars = torch.zeros(3 * len(self.param_groups) + 1, dtype=torch.float32,
                                       device=self.param_groups[0]["params"][0].device)
        for group, ps in self._groups():
            if self.grad_accum > 1:
                for p in ps:
                    if "acc" not in self.state[p]:
                        self.state[p]["acc"] = torch.zeros_like(
                            p, memory_format=torch.preserve_format)
            if ps:
                self._init_state(group, ps)

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor of the optimizer's that an update reads or writes in
        place: ``scalars`` and each leaf's state."""
        head = [] if self.scalars is None else [self.scalars]
        return head + [t for st in self.state.values() for t in st.values()
                       if torch.is_tensor(t)]

    def host_state(self) -> tuple:
        """What ``advance`` moves on the host: the count, MultiSteps' phase
        and each group's ``last_lr``."""
        return self.count, self.mini_step, [g.get("last_lr") for g in self.param_groups]

    def set_host_state(self, host: tuple) -> None:
        self.count, self.mini_step, rates = host
        for g, lr in zip(self.param_groups, rates):
            g["last_lr"] = lr

    def advance(self) -> bool:
        """The host half of a call (class docstring); True when the call
        updates the parameters, which then get the group's ``last_lr``."""
        self.materialize()
        n = self.mini_step
        self.mini_step = (n + 1) % self.grad_accum
        emits = self.mini_step == 0
        values = []
        if emits:
            self.count += 1
        for group in self.param_groups:
            lr, bc1, bc2 = self._scalars(group) if emits else (0.0, 1.0, 1.0)
            if emits:
                group["last_lr"] = lr
            values += [-lr, bc1, bc2]
        values.append(float(n + 1))
        if not _capturing(self.scalars):
            host = torch.tensor(values, dtype=torch.float32)
            # pinned, so that the copy runs in stream order and the host
            # buffer lives until it has (the caching host allocator)
            self.scalars.copy_(host.pin_memory() if self.scalars.is_cuda else host,
                               non_blocking=True)
        return emits

    # -- checkpoints: the optimizer's whole state, as optax's opt_state ------
    def state_dict(self) -> dict:
        """torch's state dict (each leaf's moments and accumulators, the
        groups' hyperparameters) with the optimizer's class, its update
        count and MultiSteps' mini_step. A schedule (a callable learning
        rate) is stored as None: the restored optimizer keeps its own, which
        the restored count drives; a plateau's float rate is stored."""
        sd = super().state_dict()
        for g in sd["param_groups"]:
            if callable(g.get("lr")):
                g["lr"] = None
        sd.update(kind=type(self).__name__, count=self.count, mini_step=self.mini_step)
        return sd

    def check_state_dict(self, state_dict: dict) -> None:
        """Raise ValueError unless ``state_dict`` is this optimizer's kind
        over groups of the same sizes, with each leaf's state shaped as the
        leaf; nothing is changed."""
        if state_dict.get("kind") != type(self).__name__:
            raise ValueError(f"optimizer state of a {state_dict.get('kind')!r}, "
                             f"but this optimizer is a {type(self).__name__!r}")
        saved = [len(g["params"]) for g in state_dict["param_groups"]]
        mine = [len(g["params"]) for g in self.param_groups]
        if saved != mine:
            raise ValueError(f"optimizer groups of {saved} leaves, but this one has {mine}")
        params = [p for g in self.param_groups for p in g["params"]]
        for i, st in state_dict["state"].items():
            for k, v in st.items():
                if torch.is_tensor(v) and v.shape != params[i].shape:
                    raise ValueError(f"optimizer state {k!r} of leaf {i}: shape "
                                     f"{tuple(v.shape)}, leaf {tuple(params[i].shape)}")

    def load_state_dict(self, state_dict: dict) -> None:
        self.check_state_dict(state_dict)
        groups = [{**g, "lr": cur["lr"]} if g.get("lr") is None else dict(g)
                  for g, cur in zip(state_dict["param_groups"], self.param_groups)]
        super().load_state_dict({"state": state_dict["state"], "param_groups": groups})
        self.count = int(state_dict["count"])
        self.mini_step = int(state_dict["mini_step"])

    def lr_at(self, group: dict, count: int) -> float:
        """The group's learning rate at update count ``count``, as a float
        that float32 holds exactly."""
        lr = group["lr"]
        return float(torch.as_tensor(lr(count), dtype=torch.float32)) if callable(lr) \
            else _f32(lr)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__}.step takes no closure")
        groups = self._groups()
        grads = [[p.grad for p in ps] for _, ps in groups]
        if self.plan is not None:
            self._sum_over_data(grads)
            self._replicate_over_model(groups, grads)
        emits = self.advance()
        if self.grad_accum > 1:
            grads = self._accumulate(groups, grads, self.scalars[-1])
            if not emits:
                return
        if self.grad_clip_norm is not None:
            grads = self._clip(grads)
        for i, ((group, ps), gs) in enumerate(zip(groups, grads)):
            if ps:
                self._update(group, ps, gs, self.scalars[3 * i:3 * i + 3])
        if self.grad_accum > 1:
            torch._foreach_zero_([self.state[p]["acc"] for _, ps in groups for p in ps])

    def _accumulate(self, groups, grads, n1: torch.Tensor):
        """MultiSteps' running mean ``acc + (g − acc) / (n + 1)`` into a
        buffer per leaf (a missing gradient is zeros), ``n1`` = n + 1 on the
        device; the accumulated gradients, which only an emitting call
        uses (no update, no weight decay on the others)."""
        with_g, g_list, without = [], [], []
        for (_, ps), gs in zip(groups, grads):
            for p, g in zip(ps, gs):
                (with_g if g is not None else without).append(self.state[p]["acc"])
                if g is not None:
                    g_list.append(g)
        if with_g:
            d = torch._foreach_sub(g_list, with_g)
            torch._foreach_div_(d, n1)
            torch._foreach_add_(with_g, d)
        if without:
            d = torch._foreach_neg(without)
            torch._foreach_div_(d, n1)
            torch._foreach_add_(without, d)
        return [[self.state[p]["acc"] for p in ps] for _, ps in groups]

    def _sum_over_data(self, grads) -> None:
        """Each present gradient summed in place over the mesh's 'data' axis,
        in one all-reduce of the gradients laid end to end."""
        group = self.plan.mesh.group("data")
        present = [g for gs in grads for g in gs if g is not None]
        if group is None or not present:
            return
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in present]), group)
        torch._foreach_copy_(present, [f.view_as(g) for f, g in
                                       zip(flat.split([g.numel() for g in present]), present)])

    def _replicate_over_model(self, groups, grads) -> None:
        """The replicated leaves' gradients of the 'model' axis's first rank,
        on every rank of the axis (distribute)."""
        group = self.plan.mesh.group("model")
        replicated = [g for (_, ps), gs in zip(groups, grads) for p, g in zip(ps, gs)
                      if g is not None and self.plan.shard_of(p) is None]
        if group is None or not replicated:
            return
        flat = torch.cat([g.reshape(-1) for g in replicated])
        dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
        torch._foreach_copy_(replicated, [f.view_as(g) for f, g in
                                          zip(flat.split([g.numel() for g in replicated]),
                                              replicated)])

    def _global_norm(self, grads, present) -> torch.Tensor:
        """The float32 norm of every trainable gradient: on a mesh, of the
        whole leaves (a split leaf's squares summed over its axis, a
        replicated leaf's counted once)."""
        norms = torch.stack(torch._foreach_norm(present))
        if self.plan is None or not self.plan.shards:
            return torch.linalg.vector_norm(norms)
        shards = [self.plan.shard_of(p) for (_, ps), gs in zip(self._groups(), grads)
                  for p, g in zip(ps, gs) if g is not None]
        squares = norms.square()
        total = squares[[i for i, s in enumerate(shards) if s is None]].sum()
        for axis in sorted({s.axis for s in shards if s is not None}):
            split = squares[[i for i, s in enumerate(shards) if s is not None and s.axis == axis]]
            total = total + all_reduce_(split.sum(), self.plan.mesh.group(axis))
        return total.sqrt()

    def _clip(self, grads):
        """optax.clip_by_global_norm: ``(g / ‖g‖) · max`` where ``‖g‖ ≥ max``,
        ``g`` otherwise, over every trainable gradient (float32 norm)."""
        present = [g for gs in grads for g in gs if g is not None]
        if not present:
            return grads
        norm = self._global_norm(grads, present)
        keep = norm < self.grad_clip_norm
        # g / 1 · 1 == g exactly, so a select needs no branch on the host
        div = torch.where(keep, torch.ones_like(norm), norm)
        mul = torch.where(keep, torch.ones_like(norm), torch.full_like(norm, self.grad_clip_norm))
        clipped = iter(torch._foreach_mul(torch._foreach_div(present, div), mul))
        return [[None if g is None else next(clipped) for g in gs] for gs in grads]

    def _scalars(self, group: dict) -> tuple:
        raise NotImplementedError

    def _init_state(self, group: dict, params: List[torch.Tensor]) -> None:
        raise NotImplementedError

    def _update(self, group: dict, params: List[torch.Tensor], grads: List,
                scalars: torch.Tensor) -> None:
        raise NotImplementedError


class Adam(_Optimizer):
    """optax's Adam / AdamW, multi-tensor.

    Per update t (optax's count + 1), over a group's trainable leaves:
    ``m ← (1−b1)·g + b1·m``; ``v ← (1−b2)·g² + b2·v``;
    ``u = (m / (1−b1^t)) / (√(v / (1−b2^t)) + eps)`` with ``1−b^t`` in
    float32; ``u ← u + wd·p`` when wd is nonzero; ``p ← p − lr·u``, where
    ``lr`` is the group's rate or its schedule at optax's count t − 1."""

    def __init__(self, params, *, lr: LearningRate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip_norm: Optional[float] = None, grad_accum: int = 1,
                 injectable: bool = False):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay),
                         grad_clip_norm=grad_clip_norm, grad_accum=grad_accum,
                         injectable=injectable)

    def _scalars(self, group):
        t = self.count
        bc1, bc2 = (float(1 - torch.tensor(b, dtype=torch.float32) ** t)
                    for b in (group["b1"], group["b2"]))
        return self.lr_at(group, t - 1), bc1, bc2

    def _init_state(self, group, params):
        for p in params:
            st = self.state[p]
            if "mu" not in st:
                st["mu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)

    def _update(self, group, params, grads, scalars):
        b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
        neg_lr, bc1, bc2 = scalars
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(mus, b1)
        torch._foreach_mul_(nus, b2)
        # optax.inject_hyperparams holds b1 and b2 as float32 arrays, so the
        # plateau optimizer takes 1 − b in float32
        c1, c2 = ((_f32(1 - _f32(b)) if self.injectable else 1 - b) for b in (b1, b2))
        present = [i for i, g in enumerate(grads) if g is not None]
        if present:
            g = [grads[i] for i in present]
            torch._foreach_add_([mus[i] for i in present], torch._foreach_mul(g, c1))
            sq = torch._foreach_mul(g, g)
            torch._foreach_mul_(sq, c2)
            torch._foreach_add_([nus[i] for i in present], sq)
        u = torch._foreach_div(mus, bc1)
        den = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(u, den)
        if wd:
            torch._foreach_add_(u, torch._foreach_mul(params, wd))
        torch._foreach_mul_(u, neg_lr)
        torch._foreach_add_(params, u)


def _split(model: nn.Module, labels: Mapping[str, str]):
    """Set frozen parameters to requires_grad=False; the trainable rest."""
    trainable = []
    for name, p in model.named_parameters():
        if labels.get(name, "trainable") == "frozen":
            p.requires_grad_(False)
        else:
            trainable.append(p)
    return trainable


def make_optimizer(model: nn.Module, *, learning_rate: LearningRate, weight_decay: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   freeze_labels: Optional[Mapping[str, str]] = None,
                   grad_clip_norm: Optional[float] = None, kind: str = "adamw",
                   grad_accum: int = 1) -> _Optimizer:
    """The optimizer of state.py:65-109 for ``model``. As there, 'adamw' and
    'adam' name one rule: optax.adamw when ``weight_decay`` is nonzero,
    optax.adam otherwise; 'adam8bit' is train/adam8bit.py. Parameters
    labelled 'frozen' in ``freeze_labels`` are set to
    ``requires_grad=False`` and left out. ``grad_accum=k`` averages k calls'
    gradients before one update (optax.MultiSteps)."""
    if kind not in OPTIMIZERS:
        raise ValueError(f"optimizer kind {kind!r} is not ported; options: {OPTIMIZERS}")
    trainable = _split(model, dict(freeze_labels or {}))
    kwargs = dict(lr=learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                  grad_clip_norm=grad_clip_norm, grad_accum=grad_accum)
    if kind == "adam8bit":
        from dose_prediction_tpu_torch.train.adam8bit import Adam8bit

        return Adam8bit(trainable, **kwargs)
    return Adam(trainable, **kwargs)


def make_split_lr_optimizer(model: nn.Module, *, lr_encoder: LearningRate,
                            lr_decoder: LearningRate, weight_decay: float = 0.0,
                            b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                            encoder_key: str = "encoder") -> Adam:
    """Split encoder/decoder learning rates (state.py:112-145,
    NetworkTrainer.set_optimizer): parameters with a name component
    containing ``encoder_key`` get ``lr_encoder``, the rest ``lr_decoder``."""
    labels = encoder_labels(model, encoder_key)
    named = list(model.named_parameters())
    groups = [{"params": [p for n, p in named if labels[n] == label], "lr": lr}
              for label, lr in (("enc", lr_encoder), ("dec", lr_decoder))]
    return Adam([g for g in groups if g["params"]], lr=lr_decoder, b1=b1, b2=b2, eps=eps,
                weight_decay=weight_decay)


def make_plateau_optimizer(model: nn.Module, *, base_lr: float, weight_decay: float = 0.0,
                           b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Adam:
    """Adam(W) whose learning rate ``set_learning_rate`` rewrites between
    steps (state.py:166-183, optax.inject_hyperparams): the reference's
    per-epoch scheduler.step(val) path."""
    return Adam(list(model.parameters()), lr=base_lr, b1=b1, b2=b2, eps=eps,
                weight_decay=weight_decay, injectable=True)


def set_learning_rate(optimizer: _Optimizer, lr: float) -> _Optimizer:
    """Set every group's learning rate of a plateau optimizer to ``lr``
    (float32, as the injected hyperparameter); the next update writes it
    into the optimizer's ``scalars`` with the rest. Raises where the rate is not
    adjustable (state.py:186-224): silently leaving it would freeze the
    rate forever."""
    if not getattr(optimizer, "injectable", False):
        raise ValueError("set_learning_rate: this optimizer has no adjustable learning rate "
                         "(build it with make_plateau_optimizer)")
    for group in optimizer.param_groups:
        group["lr"] = _f32(lr)
    return optimizer


def get_learning_rate(optimizer: _Optimizer) -> Optional[float]:
    """The plateau optimizer's learning rate, None for any other
    (state.py:227-242)."""
    if not getattr(optimizer, "injectable", False):
        return None
    return _f32(optimizer.param_groups[0]["lr"])


# ---------------------------------------------------------------------------
# LR schedules (NetworkTrainer.set_lr_scheduler, network_trainer.py:127-153),
# functions of optax's update count computed in float32 as the JAX ones are
# ---------------------------------------------------------------------------

def multistep_schedule(base_lr: float, milestones: Sequence[int], gamma: float = 0.1
                       ) -> Schedule:
    """torch MultiStepLR as optax.piecewise_constant_schedule (state.py:150-153):
    from count ``m`` on (``count >= m``), each milestone multiplies the
    float32 rate by ``gamma``."""
    boundaries = sorted({int(m) for m in milestones})

    def sched(count: int) -> torch.Tensor:
        v = torch.tensor(base_lr, dtype=torch.float32)
        for m in boundaries:
            if count >= m:
                v = gamma * v
        return v

    return sched


def cosine_schedule(base_lr: float, t_max: int, eta_min: float = 0.0) -> Schedule:
    """torch CosineAnnealingLR over t_max updates (state.py:156-163), in
    float32: ``eta_min + ½(base − eta_min)(1 + cos(π·t / t_max))`` with
    ``t = clip(count, 0, t_max)``. The cosine of the float32 argument is
    rounded correctly to float32 (taken in float64): torch's float32 cos on
    the CPU may be a last bit off, which ``1 + cos`` magnifies."""

    def sched(count: int) -> torch.Tensor:
        t = torch.tensor(min(max(int(count), 0), t_max), dtype=torch.float32)
        cos = torch.cos((math.pi * t / t_max).double()).float()
        return eta_min + 0.5 * (base_lr - eta_min) * (1 + cos)

    return sched


class ReduceLROnPlateau:
    """Host-side plateau scheduler (torch semantics: factor, patience, min on
    the monitored value), a copy of state.py:245-275. Its rate goes to
    ``set_learning_rate``."""

    def __init__(self, *, factor: float = 0.5, patience: int = 10,
                 mode: str = "min", min_lr: float = 0.0, base_lr: float = 1e-3):
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.min_lr = min_lr
        self.lr = base_lr
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def step(self, value: float) -> float:
        improved = (
            self.best is None
            or (self.mode == "min" and value < self.best)
            or (self.mode == "max" and value > self.best)
        )
        if improved:
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr
