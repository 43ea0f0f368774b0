"""ViT-GAN training (counterpart of dose_prediction_tpu/train/gan.py; reference
train_light_gan.py).

The generator is the non-cascade ViT generator (models/experiments.py::
vitgan_generator), the critic MedicalNet's ResNet-10 on the dose:
- G loss = δ3 · BCE(critic(fake) → 1) + the non-cascade GenLoss of G's
  deep-supervision outputs (:184-188);
- D loss = ½ (BCE(critic(real) → 1) + BCE(critic(fake) → 0)) (:199-201);
- a MedicalNet-pretrained critic keeps its pretrained leaves frozen until
  ``unfreeze_epoch`` (FineTuneCB, :85-96); without one the critic waits for
  that epoch whole;
- validation by the sliding window at ×80 (:224-238).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from dose_prediction_tpu_torch.core import checkpoint as C
from dose_prediction_tpu_torch.core.torch_import import load_torch_checkpoint
from dose_prediction_tpu_torch.data.openkbp import OpenKBPDataset
from dose_prediction_tpu_torch.data.pipeline import device_prefetch
from dose_prediction_tpu_torch.device import resolve_device
from dose_prediction_tpu_torch.models.experiments import VitGenerator, resnet10, vitgan_generator
from dose_prediction_tpu_torch.nn.init import reinit_weights
from dose_prediction_tpu_torch.train import losses as L
from dose_prediction_tpu_torch.train import state as S
from dose_prediction_tpu_torch.train.state import TrainState
from dose_prediction_tpu_torch.train.steps import (
    _apply_update,
    _dose_feed,
    buffers_kept,
    frozen,
)
from dose_prediction_tpu_torch.train.trainers import (
    TrainConfig,
    _drains_checkpoints,
    _host_mean,
    _refuse_mesh,
    _resume_guard_config,
    _save_epoch_slots,
    _SlidingDose,
    _stop_requested,
    _train_batches,
    _try_resume,
    seeded,
)
from dose_prediction_tpu_torch.utils.logging import MetricLogger
from dose_prediction_tpu_torch.utils.profiling import trace


@contextlib.contextmanager
def _held(module: nn.Module, mask: Optional[Mapping[str, bool]]):
    """Restore ``module``'s parameters that ``mask`` marks True as they were
    on entry: an update inside computes and records its full optimizer step
    (moments, count), but those leaves do not move (gan.py:93-96 zeroes
    their updates, decay included)."""
    names = [n for n, frozen_leaf in (mask or {}).items() if frozen_leaf]
    params = dict(module.named_parameters())
    saved = {n: params[n].detach().clone() for n in names}
    try:
        yield
    finally:
        with torch.no_grad():
            for n, value in saved.items():
                params[n].copy_(value)


def make_vitgan_train_step(generator: nn.Module, discriminator: nn.Module,
                           g_optimizer: torch.optim.Optimizer,
                           d_optimizer: torch.optim.Optimizer, *, delta3: float = 0.01,
                           delta1: float = 10.0, delta2: float = 1.0, packed: bool = False,
                           d_freeze_mask: Optional[Mapping[str, bool]] = None
                           ) -> Callable[..., Tuple[TrainState, TrainState, Dict]]:
    """``step(g_state, d_state, batch, train_d=True, freeze_d=False) ->
    (g_state, d_state, {'g_loss', 'd_loss'})`` (gan.py:36-107): a generator
    update, then, with ``train_d``, a critic update.

    - Generator: its train-mode forward keeps its BatchNorm statistics; the
      critic runs in train mode on the full-resolution output, its
      statistics update thrown away and no gradient kept for its weights.
    - Critic: the generator runs again on its updated weights, without
      autograd, its statistics update thrown away; the critic runs on the
      real dose, then on the fake, updating its statistics in that order.
      With ``freeze_d`` and ``d_freeze_mask`` ({critic parameter name:
      frozen}) the frozen leaves keep their values while their optimizer
      state advances, as the JAX step zeroes their computed update.
    - Without ``train_d`` the critic does not change at all (its step count
      included) and ``d_loss`` is 0.

    Batches and ``packed`` as steps.make_pyfer_train_step's."""

    def step(g_state: TrainState, d_state: TrainState, batch: Dict[str, torch.Tensor],
             train_d: bool = True, freeze_d: bool = False
             ) -> Tuple[TrainState, TrainState, Dict[str, torch.Tensor]]:
        generator.train()
        discriminator.train()
        x, gt = _dose_feed(batch, packed, None)
        g_optimizer.zero_grad(set_to_none=True)
        preds = generator(x)
        with buffers_kept(discriminator), frozen(discriminator):
            fake_logits = discriminator(preds[0])
        adv = L.bce_with_logits(fake_logits, torch.ones_like(fake_logits))
        recon = L.gen_loss(preds, gt, delta1=delta1, delta2=delta2, cascade=False)
        g_state, g_loss = _apply_update(g_state, g_optimizer, delta3 * adv + recon)
        d_loss = torch.zeros((), dtype=torch.float32, device=gt.device)
        if train_d:
            with torch.no_grad(), buffers_kept(generator):
                fake = generator(x)[0]
            d_optimizer.zero_grad(set_to_none=True)
            real_logits = discriminator(gt[:, 0:1].to(fake.dtype))
            fake_logits = discriminator(fake)
            loss = 0.5 * (L.bce_with_logits(real_logits, torch.ones_like(real_logits))
                          + L.bce_with_logits(fake_logits, torch.zeros_like(fake_logits)))
            with _held(discriminator, d_freeze_mask if freeze_d else None):
                d_state, d_loss = _apply_update(d_state, d_optimizer, loss)
        return g_state, d_state, {"g_loss": g_loss, "d_loss": d_loss}

    return step


def load_pretrained_critic(path: str, discriminator: nn.Module) -> Dict[str, bool]:
    """create_pretrained_medical_resnet for the critic (gan.py:110-135;
    train_light_gan.py:136-141, models_experiments.py:1555-1588): a
    MedicalNet torch pickle (DataParallel 'module.' prefixes stripped)
    merged into ``discriminator`` as ``strict=False`` loads it, BatchNorm
    statistics included, in place. Returns {parameter name: pretrained}: a
    parameter the file does not hold at its shape (the segmentation
    pretrains carry no ``fc``) keeps its initialisation and trains from the
    first epoch."""
    source = load_torch_checkpoint(path)
    merged, _ = C.merge_partial(discriminator.state_dict(), source, verbose=False)
    discriminator.load_state_dict(merged, strict=True)
    return {n: n in source and tuple(source[n].shape) == tuple(p.shape)
            for n, p in discriminator.named_parameters()}


class VitGANTrainer(_SlidingDose):
    """ViT-GAN's full harness (gan.py:138-317): a generator update and a
    windowed-freeze critic update a batch; sliding-window validation with
    roi = the example size and the ×80 dose scale (train_light_gan.py:219-238);
    best slots on mean_dose_score=max, an every-epoch 'last' slot of
    ``{"g", "d", "epoch"}`` with resume (:268-270); the OpenKBP test sweep.

    Defaults are the reference's (:104-107,250-251): δ3 = 2, the generator
    at 1e-4, the critic at 5e-3, cfg.optimizer's Adam (adam8bit as the
    reference trains). Without ``generator`` or ``discriminator`` each is
    built from cfg.seed (the critic from seed + 1); ``init_type`` re-draws
    the generator the pix2pix way (nn/init.py::reinit_weights) from seed +
    2; ``pretrained_critic`` loads a MedicalNet pickle into the critic
    (load_pretrained_critic). At ``unfreeze_epoch``, with a pretrained
    critic, both optimizers restart from fresh state (FineTuneCB rebuilds
    them, :89-96)."""

    _generator_attr = "gen"

    def __init__(self, cfg: TrainConfig, *, generator: Optional[VitGenerator] = None,
                 discriminator: Optional[nn.Module] = None,
                 example_shape: Sequence[int] = (1, 128, 128, 128, 9),
                 unfreeze_epoch: int = 10, delta3: float = 2.0, g_lr: float = 1e-4,
                 d_lr: float = 5e-3, val_scale: float = 80.0, init_type: Optional[str] = None,
                 init_gain: float = 0.02, pretrained_critic: Optional[str] = None):
        _refuse_mesh(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.unfreeze_epoch = unfreeze_epoch
        self.val_scale = val_scale
        self.roi_size = tuple(example_shape[1:4])
        self.gen = generator if generator is not None else seeded(cfg.seed, lambda: (
            vitgan_generator(img_size=self.roi_size, device=self.device)))
        self.disc = discriminator if discriminator is not None else seeded(
            cfg.seed + 1, lambda: resnet10(num_classes=1, device=self.device))
        if init_type is not None:
            gen = torch.Generator(self.device).manual_seed(cfg.seed + 2)
            reinit_weights(self.gen, gen, init_type=init_type, init_gain=init_gain)
        self.d_frozen_mask = None
        if pretrained_critic is not None:
            self.d_frozen_mask = load_pretrained_critic(pretrained_critic, self.disc)
        self._lrs, self._delta3 = (g_lr, d_lr), delta3
        self.g_state = self.d_state = None
        self._build_optimizers()
        self.logger = MetricLogger(cfg.log_dir, run_name="vitgan")
        self.ckpt = C.CheckpointManager(cfg.ckpt_dir, monitor="mean_dose_score", mode="max")

    def _build_optimizers(self) -> None:
        """Fresh optimizers for both nets and the step over them; the states
        keep their step counts and moving losses."""
        cfg = self.cfg
        g_opt, d_opt = (S.make_optimizer(net, learning_rate=lr, kind=cfg.optimizer)
                        for net, lr in ((self.gen, self._lrs[0]), (self.disc, self._lrs[1])))
        carry = lambda st: {} if st is None else {  # noqa: E731
            "step": st.step, "moving_loss": st.moving_loss}
        self.g_state = S.TrainState(self.gen, g_opt, **carry(self.g_state))
        self.d_state = S.TrainState(self.disc, d_opt, **carry(self.d_state))
        self.step = make_vitgan_train_step(
            self.gen, self.disc, g_opt, d_opt, delta3=self._delta3, delta1=cfg.delta1,
            delta2=cfg.delta2, packed=cfg.feed_dtype == "packed",
            d_freeze_mask=self.d_frozen_mask)

    def _tree(self, epoch: int) -> Dict[str, Any]:
        return {"g": self.g_state, "d": self.d_state, "epoch": epoch}

    @_drains_checkpoints
    def fit(self, train_ds: OpenKBPDataset, val_ds: Optional[OpenKBPDataset] = None, *,
            resume: bool = True) -> None:
        cfg = self.cfg
        start_epoch = 0
        if resume:
            restored, start_epoch = _try_resume(
                self.ckpt, self._tree(0),
                run_config=_resume_guard_config(cfg, self.gen, self.disc))
            if restored is not None:         # loaded into the current optimizers
                self.g_state, self.d_state = restored["g"], restored["d"]
                self.logger.log_text(f"resumed from epoch {start_epoch - 1}")
        global_step = int(self.g_state.step)
        pretrained = self.d_frozen_mask is not None
        for epoch in range(start_epoch, cfg.max_epochs):
            # with a pretrained critic D trains from epoch 0, its pretrained
            # leaves frozen until the unfreeze epoch; without one the whole
            # critic waits for it (gan.py:264-277)
            train_d = epoch >= self.unfreeze_epoch or pretrained
            freeze_d = pretrained and epoch < self.unfreeze_epoch
            if epoch == self.unfreeze_epoch and pretrained:
                self._build_optimizers()
                self.logger.log_text(f"epoch {epoch}: critic unfrozen, optimizers restarted")
            g_losses, d_losses = [], []
            feed = device_prefetch(_train_batches(cfg, train_ds, epoch), device=self.device)
            with trace(cfg.profile_dir if epoch == start_epoch else None), contextlib.closing(feed):
                for batch in feed:
                    self.g_state, self.d_state, info = self.step(
                        self.g_state, self.d_state, batch, train_d=train_d, freeze_d=freeze_d)
                    g_losses.append(info["g_loss"])
                    d_losses.append(info["d_loss"])
                    global_step += 1
                    if _stop_requested(cfg, global_step):
                        break
            self.logger.log({"gan_loss": _host_mean(g_losses),
                             "disc_loss": _host_mean(d_losses)}, epoch + 1)
            if val_ds is not None and (epoch + 1) % cfg.check_val == 0:
                metrics = self.validate(val_ds)
                self.logger.log(metrics, epoch + 1)
                self.ckpt.save(epoch, self._tree(epoch),
                               {"mean_dose_score": metrics["mean_dose_score"]})
            _save_epoch_slots(self.ckpt, cfg, epoch, global_step, self._tree(epoch))
            if _stop_requested(cfg, global_step):
                break
