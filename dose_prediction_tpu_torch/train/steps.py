"""DOSE-PYFER train and eval steps (counterpart of
dose_prediction_tpu/train/steps.py::make_pyfer_train_step, :24-84, and
make_pyfer_eval_step, :87-…; reference train_light_pyfer.py:122-174).

Batches keep the JAX package's channels-last layout at this boundary:
``input (N, D, H, W, 9)`` and ``gt (N, D, H, W, 2)`` (dose ÷ 70, possible-dose
mask); the steps permute once to NCDHW. The model computes in the dtype of
``batch['input']`` with float32 parameters. Not ported yet: ``remat``
(torch.utils.checkpoint), the ``packed`` feed and ``donate``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from dose_prediction_tpu_torch.evaluation.metrics import postprocess_prediction
from dose_prediction_tpu_torch.train import losses as L
from dose_prediction_tpu_torch.train.state import TrainState, update_moving_loss


def to_ncdhw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 4, 1, 2, 3).contiguous()


def make_pyfer_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, *,
                          delta1: float = 10.0, delta2: float = 8.0, freeze: bool = True
                          ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                        Tuple[TrainState, torch.Tensor]]:
    """``step(state, batch) -> (state, loss)``: GenLoss deep supervision over
    the cascade output, net_A frozen by default (run without autograd). The
    model's parameters, BatchNorm statistics and the optimizer are updated in
    place; the returned state carries the next step count and moving loss."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        preds = model(to_ncdhw(batch["input"]), stop_gradient_a=freeze)
        loss = L.gen_loss(preds, to_ncdhw(batch["gt"]), delta1=delta1, delta2=delta2,
                          cascade=True, freeze=freeze)
        loss.backward()
        optimizer.step()
        loss = loss.detach()
        moving = update_moving_loss(state.moving_loss, float(loss))
        return dataclasses.replace(state, step=state.step + 1, moving_loss=moving), loss

    return step


def make_pyfer_eval_step(model: nn.Module) -> Callable[[Dict[str, torch.Tensor]], Dict]:
    """``step(batch)``: a full-volume eval-mode forward, the val loss of the
    full-resolution head, the ×70 masked dose score and the post-processed
    prediction (NDHWC, Gy). The JAX step's batched-validation branch
    (``batch['valid']``, for a data-parallel mesh) is not ported."""

    @torch.no_grad()
    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        _, preds_b = model(to_ncdhw(batch["input"]))
        pred = preds_b[0]
        gt = to_ncdhw(batch["gt"])
        gt_dose, mask = gt[:, 0:1], gt[:, 1:2]
        post = postprocess_prediction(pred, mask)
        return {"val_loss": L.gen_loss(pred, gt, mode="val"),
                "dose_score": L.masked_l1(post, 70.0 * gt_dose, mask),
                "prediction": post.permute(0, 2, 3, 4, 1)}

    return step
