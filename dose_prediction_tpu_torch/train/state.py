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
(``multistep_schedule``, ``cosine_schedule``). Freezing sets
``requires_grad=False``, so a frozen parameter gets no gradient, no update
and no weight decay (``optax.set_to_zero``). A trainable parameter without
a gradient is updated with a zero gradient, as optax updates every leaf it
is given: its moments decay and weight decay still shrinks it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import torch
from torch import nn

OPTIMIZERS = ("adamw", "adam", "adam8bit")
# a schedule maps optax's update count to a float32 learning rate
Schedule = Callable[[int], torch.Tensor]
LearningRate = Union[float, Schedule]


@dataclasses.dataclass
class TrainState:
    """What a step updates: the step count and the moving loss; the model and
    optimizer are updated in place."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    # EMA of the train loss (eps 0.01, network_trainer.py:162-168)
    moving_loss: float = math.nan


def update_moving_loss(moving: float, loss: float, eps: float = 0.01) -> float:
    """EMA train loss (state.py:277-279): the first loss seeds it."""
    return loss if math.isnan(moving) else (1 - eps) * moving + eps * loss


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
    """``x`` rounded to float32 (a scalar that a float32 kernel takes as is)."""
    return float(torch.tensor(x, dtype=torch.float32))


class _Optimizer(torch.optim.Optimizer):
    """What every optimizer here shares: one update count for the whole
    optimizer (optax's ``count``), global-norm clipping in optax's order,
    gradient accumulation as ``optax.MultiSteps`` and the plateau's
    adjustable learning rate. Subclasses write ``_update(params, grads)``
    for one group's trainable leaves (a gradient of None is zeros) and
    leave the rate they applied in the group's ``last_lr``."""

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

    def _groups(self):
        return [(g, [p for p in g["params"] if p.requires_grad]) for g in self.param_groups]

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
        if self.grad_accum > 1:
            grads = self._accumulate(groups, grads)
            if grads is None:
                return
        self.count += 1
        if self.grad_clip_norm is not None:
            grads = self._clip(grads)
        for (group, ps), gs in zip(groups, grads):
            if ps:
                self._update(group, ps, gs)
        if self.grad_accum > 1:
            torch._foreach_zero_([self.state[p]["acc"] for _, ps in groups for p in ps])

    def _accumulate(self, groups, grads):
        """MultiSteps' running mean ``acc + (g − acc) / (n + 1)`` into a
        buffer per leaf (a missing gradient is zeros); the accumulated
        gradients on the k-th call, else None (no update, no weight decay)."""
        n = self.mini_step
        with_g, g_list, without = [], [], []
        for (_, ps), gs in zip(groups, grads):
            for p, g in zip(ps, gs):
                st = self.state[p]
                if "acc" not in st:
                    st["acc"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                (with_g if g is not None else without).append(st["acc"])
                if g is not None:
                    g_list.append(g)
        if with_g:
            d = torch._foreach_sub(g_list, with_g)
            torch._foreach_div_(d, float(n + 1))
            torch._foreach_add_(with_g, d)
        if without:
            d = torch._foreach_neg(without)
            torch._foreach_div_(d, float(n + 1))
            torch._foreach_add_(without, d)
        self.mini_step = (n + 1) % self.grad_accum
        if self.mini_step != 0:
            return None
        return [[self.state[p]["acc"] for p in ps] for _, ps in groups]

    def _clip(self, grads):
        """optax.clip_by_global_norm: ``(g / ‖g‖) · max`` where ``‖g‖ ≥ max``,
        ``g`` otherwise, over every trainable gradient (float32 norm)."""
        present = [g for gs in grads for g in gs if g is not None]
        if not present:
            return grads
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(present)))
        keep = norm < self.grad_clip_norm
        # g / 1 · 1 == g exactly, so a select needs no branch on the host
        div = torch.where(keep, torch.ones_like(norm), norm)
        mul = torch.where(keep, torch.ones_like(norm), torch.full_like(norm, self.grad_clip_norm))
        clipped = iter(torch._foreach_mul(torch._foreach_div(present, div), mul))
        return [[None if g is None else next(clipped) for g in gs] for gs in grads]

    def _update(self, group: dict, params: List[torch.Tensor], grads: List) -> None:
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

    def _update(self, group, params, grads):
        b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
        for p in params:
            st = self.state[p]
            if "mu" not in st:
                st["mu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
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
        t = self.count
        bc1, bc2 = (float(1 - torch.tensor(b, dtype=torch.float32) ** t) for b in (b1, b2))
        u = torch._foreach_div(mus, bc1)
        den = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(u, den)
        if wd:
            torch._foreach_add_(u, torch._foreach_mul(params, wd))
        group["last_lr"] = self.lr_at(group, t - 1)
        torch._foreach_mul_(u, -group["last_lr"])
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
    (float32, as the injected hyperparameter). Raises where the rate is not
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
