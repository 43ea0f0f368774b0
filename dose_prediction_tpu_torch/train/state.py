"""Train state, freeze labels and the optimizer (counterpart of
dose_prediction_tpu/train/state.py).

The JAX package builds its optimizer from optax; the port writes the same
update rule as a ``torch.optim.Optimizer``: optionally
``optax.clip_by_global_norm`` over the trainable gradients, then
``optax.adam`` or ``optax.adamw`` (weight decay added to the Adam direction
before the learning rate scales it). Freezing sets ``requires_grad=False``,
so a frozen parameter gets no gradient, no update and no weight decay
(``optax.set_to_zero``). A trainable parameter without a gradient is updated
with a zero gradient, as optax updates every leaf it is given: its moments
decay and weight decay still shrinks it. Not ported yet: ``adam8bit``, ``grad_accum``, the
split learning rate, schedules and the plateau wait.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional

import torch
from torch import nn

OPTIMIZERS = ("adamw", "adam")


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


def cascade_freeze_labels(model: nn.Module) -> Dict[str, str]:
    """'frozen' for every parameter under net_A or conv_out_A, 'trainable'
    for the rest (state.py:57-62; train_light_pyfer.py:85-88)."""
    return {n: "frozen" if any(k in ("net_A", "conv_out_A") for k in n.split("."))
            else "trainable" for n, _ in model.named_parameters()}


class Adam(torch.optim.Optimizer):
    """optax's Adam / AdamW, optionally after global-norm clipping.

    Per step t, over every parameter that requires a gradient (a missing
    ``.grad`` counts as zeros, which add nothing to the norm):
    ``g ← g · max_norm / ‖g‖`` when ``‖g‖ ≥ max_norm`` (optax's select, not
    torch's clip_grad_norm_, which adds 1e-6 to the norm); ``m ← b1·m +
    (1−b1)·g``; ``v ← b2·v + (1−b2)·g²``; ``u = m̂ / (√v̂ + eps) + wd·p``
    with ``m̂ = m / (1−b1^t)``, ``v̂ = v / (1−b2^t)`` (``1−b^t`` in float32,
    as optax computes it); ``p ← p − lr·u``. ``t`` is one count for the whole
    optimizer (optax's ``count``), not a count per parameter."""

    def __init__(self, params, *, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip_norm: Optional[float] = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))
        self.grad_clip_norm = grad_clip_norm
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        self.count += 1
        t = self.count
        grads = [p.grad for group in self.param_groups for p in group["params"]
                 if p.requires_grad and p.grad is not None]
        clip = None
        if self.grad_clip_norm is not None and grads:
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            clip = torch.where(norm < self.grad_clip_norm, torch.ones_like(norm),
                               self.grad_clip_norm / norm)
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            # bias corrections in float32, as optax computes them
            bc1, bc2 = (1 - torch.tensor(b, dtype=torch.float32) ** t for b in (b1, b2))
            for p in group["params"]:
                if not p.requires_grad:
                    continue
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                mu, nu = state["mu"], state["nu"]
                mu.mul_(b1)
                nu.mul_(b2)
                if p.grad is not None:
                    g = p.grad if clip is None else p.grad * clip
                    mu.add_(g, alpha=1 - b1)
                    nu.addcmul_(g, g, value=1 - b2)
                u = (mu / bc1.to(mu.dtype)) / ((nu / bc2.to(nu.dtype)).sqrt() + group["eps"])
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p.sub_(group["lr"] * u)


def make_optimizer(model: nn.Module, *, learning_rate: float, weight_decay: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   freeze_labels: Optional[Mapping[str, str]] = None,
                   grad_clip_norm: Optional[float] = None, kind: str = "adamw") -> Adam:
    """The optimizer of state.py:65-109 for ``model``. As there, 'adamw' and
    'adam' name one rule: optax.adamw when ``weight_decay`` is nonzero,
    optax.adam otherwise. Parameters labelled 'frozen' in ``freeze_labels``
    are set to ``requires_grad=False`` and left out."""
    if kind not in OPTIMIZERS:
        raise ValueError(f"optimizer kind {kind!r} is not ported; options: {OPTIMIZERS}")
    labels = dict(freeze_labels or {})
    trainable = []
    for name, p in model.named_parameters():
        if labels.get(name, "trainable") == "frozen":
            p.requires_grad_(False)
        else:
            trainable.append(p)
    return Adam(trainable, lr=learning_rate, b1=b1, b2=b2, eps=eps,
                weight_decay=weight_decay, grad_clip_norm=grad_clip_norm)
