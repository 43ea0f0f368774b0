"""Train and eval steps (counterpart of dose_prediction_tpu/train/steps.py):
the DOSE-PYFER step (:24-84) and eval step (:87-119), the C3D cascade's
step (:122-144), the experiments zoo's deep-supervision step (:204-235),
the single-output dose step of HD-UNet (:147-171) with its eval step
(JAX train/trainers.py:921-949) and the OAR-TranSeg step (:174-204), which also trains the plain UNETR, and DoseGAN's alternating
critic and generator steps (:239-307) with their eval step (JAX
train/trainers.py:1352-1364); reference
train_light_{pyfer,c3d,hdunet,transeg,dosegan}.py.

Batches keep the JAX package's channels-last layout at this boundary:
``input (N, D, H, W, 9)`` and ``gt (N, D, H, W, 2)`` (dose ÷ 70, possible-dose
mask); the steps permute once to NCDHW. The model computes in the dtype of
``batch['input']`` with float32 parameters, or in the step's ``dtype`` where
one is given (the JAX model's ``dtype`` attribute). With ``packed=True`` the
DOSE-PYFER, C3D, single-output and DoseGAN steps take the packed feed
(data/packed.py, steps.py:69-70 and :132-133): unpacked and augmented in
float32 on the batch's device, then cast once to ``dtype``. Not ported: ``donate`` (the steps update in place).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from dose_prediction_tpu_torch.data.packed import unpack_dose_batch
from dose_prediction_tpu_torch.evaluation.metrics import postprocess_prediction
from dose_prediction_tpu_torch.nn import remat as R
from dose_prediction_tpu_torch.parallel.collectives import all_reduce_
from dose_prediction_tpu_torch.train import losses as L
from dose_prediction_tpu_torch.train.state import TrainState, update_moving_loss


def to_ncdhw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 4, 1, 2, 3).contiguous()


def _dose_feed(batch: Dict[str, torch.Tensor], packed: bool, dtype: Optional[torch.dtype]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The model's NCDHW input in ``dtype`` (the input's own when None) and
    the NCDHW gt, from a float32, bf16 or (``packed``) packed batch."""
    if packed:
        batch = unpack_dose_batch(batch)
    x = batch["input"] if dtype is None else batch["input"].to(dtype)
    return to_ncdhw(x), to_ncdhw(batch["gt"])


def make_pyfer_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, *,
                          delta1: float = 10.0, delta2: float = 8.0, freeze: bool = True,
                          remat: bool = False, packed: bool = False,
                          dtype: Optional[torch.dtype] = None, mesh=None
                          ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                        Tuple[TrainState, torch.Tensor]]:
    """``step(state, batch) -> (state, loss)``: GenLoss deep supervision over
    the cascade output, net_A frozen by default (run without autograd). The
    model's parameters, BatchNorm statistics and the optimizer are updated in
    place; the returned state carries the next step count and moving loss.
    ``remat`` recomputes the whole model call in the backward (steps.py:54-55,
    ``jax.checkpoint``; nn/remat.py), with BatchNorm statistics updated once.
    ``packed`` takes the packed feed; ``dtype`` is the dtype the model
    computes in (module docstring). On a ``mesh`` (parallel/mesh.py) whose
    'data' axis splits the global batch, the batch is this rank's rows: the
    loss is this rank's share of the global batch's (losses.py::gen_loss),
    and the loss returned is the global one (the shares all-reduced)."""
    group = None if mesh is None else mesh.group("data")

    def apply(x: torch.Tensor):
        return model(x, stop_gradient_a=freeze)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        x, gt = _dose_feed(batch, packed, dtype)
        preds = R.checkpoint(apply, x, enabled=remat)
        loss = L.gen_loss(preds, gt, delta1=delta1, delta2=delta2, cascade=True, freeze=freeze,
                          group=group)
        return _apply_update(state, optimizer, loss, group)

    return step


def _apply_update(state: TrainState, optimizer: torch.optim.Optimizer, loss: torch.Tensor,
                  group=None) -> Tuple[TrainState, torch.Tensor]:
    """Back-propagate ``loss``, update, and advance the state's count and
    moving loss (the tail of every JAX step); nothing is read on the host.
    With ``group``, ``loss`` is a rank's share: the one kept is the sum over
    the group."""
    loss.backward()
    optimizer.step()
    loss = loss.detach()
    if group is not None:
        loss = all_reduce_(loss.clone(), group)
    moving = update_moving_loss(state.moving_loss, loss)
    return dataclasses.replace(state, step=state.step + 1, moving_loss=moving), loss


def make_cascade_c3d_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, *,
                                freeze: bool = False, packed: bool = False,
                                dtype: Optional[torch.dtype] = None
                                ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                              Tuple[TrainState, torch.Tensor]]:
    """The C3D cascade's step (steps.py:122-144; train_light_c3d.py): the
    masked-L1 cascade loss of ``(pred_a, pred_b)``, net_A's head in it at
    0.5 unless ``freeze``. Batches, ``packed`` and ``dtype`` as
    make_pyfer_train_step's."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        x, gt = _dose_feed(batch, packed, dtype)
        pred_a, pred_b = model(x)
        loss = L.cascade_l1_loss(pred_a, pred_b, gt, freeze=freeze)
        return _apply_update(state, optimizer, loss)

    return step


def make_simple_dose_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, *,
                                packed: bool = False, dtype: Optional[torch.dtype] = None
                                ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                              Tuple[TrainState, torch.Tensor]]:
    """The step of a single-output dose model (HD-UNet; steps.py:147-171,
    train_light_hdunet.py with Loss(casecade=False)): masked L1 of the one
    output against the dose, in the possible-dose mask. Batches,
    ``packed`` and ``dtype`` as make_pyfer_train_step's."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        x, gt = _dose_feed(batch, packed, dtype)
        loss = L.masked_l1(model(x), gt[:, 0:1], gt[:, 1:2])
        return _apply_update(state, optimizer, loss)

    return step


def make_deep_supervision_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, *,
                                     delta1: float = 10.0, delta2: float = 8.0,
                                     huber: bool = False, packed: bool = False
                                     ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                                   Tuple[TrainState, torch.Tensor]]:
    """The experiments zoo's step (steps.py:204-235; train_light_exp_models.py:193):
    a model returning a deep-supervision output list trains with the
    non-cascade GenLoss (``huber`` for the Huber reconstruction term).
    The model's BatchNorm statistics update is kept. Batches and
    ``packed`` as make_pyfer_train_step's."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        x, gt = _dose_feed(batch, packed, None)
        loss = L.gen_loss(model(x), gt, delta1=delta1, delta2=delta2, huber=huber)
        return _apply_update(state, optimizer, loss)

    return step


@contextlib.contextmanager
def buffers_kept(module: nn.Module) -> Iterator[None]:
    """Run a train-mode forward whose BatchNorm statistics update is thrown
    away: ``module``'s buffers are restored as they were on exit (the JAX
    step discards that ``mutable`` output)."""
    saved = [b.detach().clone() for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in zip(module.buffers(), saved):
                b.copy_(s)


@contextlib.contextmanager
def frozen(module: nn.Module) -> Iterator[None]:
    """``module``'s parameters without gradients for the duration: a
    backward through it computes its input gradients only."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def make_dosegan_train_steps(generator: nn.Module, discriminator: nn.Module,
                             g_optimizer: torch.optim.Optimizer,
                             d_optimizer: torch.optim.Optimizer, *, l1_weight: float = 100.0,
                             packed: bool = False, dtype: Optional[torch.dtype] = None
                             ) -> Callable[[TrainState, TrainState, Dict[str, torch.Tensor]],
                                           Tuple[TrainState, TrainState, Dict]]:
    """``step(g_state, d_state, batch) -> (g_state, d_state, {'g_loss',
    'd_loss'})``: one critic update, then one generator update
    (steps.py:239-307; train_light_dosegan.py:111-142). The critic is
    unconditional: it sees only a dose volume.

    - Critic: the generator runs in train mode on its pre-update weights,
      without autograd, and its BatchNorm statistics update is thrown away;
      the critic runs on the real dose, then on the fake, updating its
      statistics twice in that order; loss 0.5·(BCE(real, 1) + BCE(fake, 0)).
    - Generator: its forward runs again and keeps its statistics update; the
      critic runs on its updated weights in train mode, its statistics
      update thrown away and no gradient kept for its weights; loss
      BCE(fake, 1) + ``l1_weight`` · masked L1 against the dose.

    Batches, ``packed`` and ``dtype`` as make_pyfer_train_step's."""

    def step(g_state: TrainState, d_state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[TrainState, TrainState, Dict[str, torch.Tensor]]:
        generator.train()
        discriminator.train()
        x, gt = _dose_feed(batch, packed, dtype)
        gt_dose, mask = gt[:, 0:1], gt[:, 1:2]
        with torch.no_grad(), buffers_kept(generator):
            fake = generator(x)
        d_optimizer.zero_grad(set_to_none=True)
        real_logits = discriminator(gt_dose.to(fake.dtype))
        fake_logits = discriminator(fake)
        d_loss = 0.5 * (L.bce_with_logits(real_logits, torch.ones_like(real_logits))
                        + L.bce_with_logits(fake_logits, torch.zeros_like(fake_logits)))
        d_state, d_loss = _apply_update(d_state, d_optimizer, d_loss)
        g_optimizer.zero_grad(set_to_none=True)
        fake = generator(x)
        with buffers_kept(discriminator), frozen(discriminator):
            fake_logits = discriminator(fake)
        g_loss = (L.bce_with_logits(fake_logits, torch.ones_like(fake_logits))
                  + l1_weight * L.masked_l1(fake, gt_dose, mask))
        g_state, g_loss = _apply_update(g_state, g_optimizer, g_loss)
        return g_state, d_state, {"g_loss": g_loss, "d_loss": d_loss}

    return step


def make_dosegan_eval_step(generator: nn.Module) -> Callable[[Dict[str, torch.Tensor]], Dict]:
    """``step(batch)`` of the DoseGAN generator (JAX trainers.py:1352-1364):
    an eval-mode forward, the unmasked L1 against the dose as the val loss
    (criterionL1, train_light_dosegan.py:81,168), the ×70 masked dose score
    and the post-processed prediction."""

    @torch.no_grad()
    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        generator.eval()
        return _eval_outputs(generator(to_ncdhw(batch["input"])), batch,
                             lambda pred, gt: (pred.float() - gt[:, 0:1].float()).abs().mean())

    return step


def make_transeg_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, *, mesh=None
                            ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                          Tuple[TrainState, torch.Tensor]]:
    """The OAR-TranSeg step (steps.py:174-204; train_light_transeg.py:193-198):
    DiceCE on crops. ``batch``: ``ct (N, D, H, W, 1)`` and ``labels (N, D, H,
    W)`` of any integer type (uint8 on the wire), widened to int64 on their
    device for one_hot and gather. The seg family's BatchNorms update their
    running statistics. On a ``mesh`` whose 'data' axis splits the global
    batch, as make_pyfer_train_step: the loss is this rank's share, the one
    returned the global one."""
    group = None if mesh is None else mesh.group("data")

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(to_ncdhw(batch["ct"]))
        loss = L.dice_ce_loss(logits, batch["labels"].long(), group=group)
        return _apply_update(state, optimizer, loss, group)

    return step


def _eval_outputs(pred: torch.Tensor, batch: Dict[str, torch.Tensor], val_loss
                  ) -> Dict[str, torch.Tensor]:
    """The eval step's outputs for the full-resolution prediction ``pred``
    (NCDHW): ``val_loss(pred, gt)``, the ×70 masked dose score and the
    post-processed prediction (NDHWC, Gy); or, with ``batch['valid']``, the
    validity-weighted means of the per-sample masked L1s (steps.py:100-115)."""
    gt = to_ncdhw(batch["gt"])
    gt_dose, mask = gt[:, 0:1], gt[:, 1:2]
    post = postprocess_prediction(pred, mask)
    valid = batch.get("valid")
    if valid is not None:
        v = valid.float()
        per_loss = L.masked_l1_per_sample(pred, gt_dose, mask)
        per_score = L.masked_l1_per_sample(post, 70.0 * gt_dose, mask)
        n = v.sum().clamp_min(1.0)
        return {"val_loss_mean": (per_loss * v).sum() / n,
                "dose_score_mean": (per_score * v).sum() / n, "n_valid": v.sum()}
    return {"val_loss": val_loss(pred, gt),
            "dose_score": L.masked_l1(post, 70.0 * gt_dose, mask),
            "prediction": post.permute(0, 2, 3, 4, 1)}


def make_simple_dose_eval_step(model: nn.Module) -> Callable[[Dict[str, torch.Tensor]], Dict]:
    """``step(batch)`` of a single-output dose model (the HD-UNet trainer's
    eval steps, JAX trainers.py:921-949): an eval-mode forward, the masked
    L1 val loss, the ×70 masked dose score and the prediction; batched with
    ``batch['valid']`` as make_pyfer_eval_step."""

    @torch.no_grad()
    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        return _eval_outputs(model(to_ncdhw(batch["input"])), batch,
                             lambda pred, gt: L.masked_l1(pred, gt[:, 0:1], gt[:, 1:2]))

    return step


def make_pyfer_eval_step(model: nn.Module) -> Callable[[Dict[str, torch.Tensor]], Dict]:
    """``step(batch)``: a full-volume eval-mode forward, the val loss of the
    full-resolution head, the ×70 masked dose score and the post-processed
    prediction (NDHWC, Gy). With ``batch['valid']`` (B,), the batched
    validation of steps.py:100-115 (several patients a program, pad rows
    weighted 0): only ``val_loss_mean``, ``dose_score_mean`` (per-sample
    masked L1s weighted by validity) and ``n_valid``."""

    @torch.no_grad()
    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        _, preds_b = model(to_ncdhw(batch["input"]))
        return _eval_outputs(preds_b[0], batch,
                             lambda pred, gt: L.gen_loss(pred, gt, mode="val"))

    return step
