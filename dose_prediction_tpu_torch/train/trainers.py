"""Task trainers (counterpart of dose_prediction_tpu/train/trainers.py):
epoch loops over the port's train steps, with validation, checkpoints,
resume and a graceful stop on SIGTERM.

- PyferTrainer      ← train_light_pyfer.py (the flagship: frozen net_A
                      cascade, GenLoss δ1=10 δ2=8, best slot on
                      mean_dose_score=max)
- CascadeC3DTrainer ← train_light_c3d.py (masked-L1 cascade; split rates,
                      multistep, cosine or plateau)
- HDUNetTrainer     ← train_light_hdunet.py (masked L1; full-volume
                      validation, best slot on mean_dose_score=max)
- TranSegTrainer    ← OARSegmentation/train_light_transeg.py (DiceCE on
                      crops; sliding-window validation with Dice and HD95),
                      any block family and k7 mode
- UNETRSegTrainer   ← the same harness for the plain UNETR (mode_model=0)
- DoseGANTrainer    ← train_light_dosegan.py (alternating critic and
                      generator updates; full-volume validation, best slot
                      on mean_dose_score=max)
- ExpModelTrainer   ← train_light_exp_models.py (any deep-supervision
                      model, non-cascade GenLoss; sliding-window validation
                      at ×80, best slot on mean_dose_score=max)

ViT-GAN's trainer is train/gan.py::VitGANTrainer.

The models compute in float32, their default dtype, as the JAX trainers'
do (the JAX CLI passes no dtype), under PyTorch's TF32 defaults on the
card. Hyperparameter defaults are the reference's tuned values
(train_light_pyfer.py:293-300). On the card PyferTrainer and
TranSegTrainer, and so UNETRSegTrainer, run their steps as CUDA graphs
(infer/aot.py::maybe_wrap_train_step, as the JAX trainers wrap theirs at
:547 and :1047).

PyferTrainer, TranSegTrainer and UNETRSegTrainer train on a mesh
(``mesh_shape``, e.g. {'data': 2}, {'model': 2} or {'data': 2, 'model': 2})
of the processes that parallel/multihost.py::initialize joined, one device
each (the JAX mesh branches, :522-609 and :1027-1093): each process builds
the trainer, which shards the model (parallel/mesh.py::shard_params) before
it makes the optimizer, and feeds this process's rows of each global batch.
Over a 'data' axis PyferTrainer validates several patients at once
(``_mesh_val_metrics``), and the seg trainers split each patient's window
batch (infer/sliding_window.py::sliding_window_inference_sharded). Their
steps stay eager. The other trainers refuse a mesh: their mesh branches are
ROADMAP queue 1 item 7.4.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import signal
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from dose_prediction_tpu_torch.core import checkpoint as C
from dose_prediction_tpu_torch.data.openkbp import OpenKBPDataset
from dose_prediction_tpu_torch.data.pipeline import device_prefetch, dose_batches, seg_batches
from dose_prediction_tpu_torch.device import resolve_device
from dose_prediction_tpu_torch.evaluation import metrics as M
from dose_prediction_tpu_torch.infer import aot as AOT
from dose_prediction_tpu_torch.infer.pipeline import pipeline_map
from dose_prediction_tpu_torch.infer.sliding_window import (
    sliding_window_inference,
    sliding_window_inference_sharded,
)
from dose_prediction_tpu_torch.models import (
    UNETR,
    CascadeC3D,
    DosePyfer,
    HDUNet,
    NLayerDiscriminator,
    TranSeg,
    UnetGenerator3D,
)
from dose_prediction_tpu_torch.models.spec import model_spec
from dose_prediction_tpu_torch.train import losses as L
from dose_prediction_tpu_torch.train import state as S
from dose_prediction_tpu_torch.train import steps as STEP
from dose_prediction_tpu_torch.utils.logging import EpochTimer, MetricLogger
from dose_prediction_tpu_torch.utils.profiling import trace


@dataclasses.dataclass
class TrainConfig:
    """Shared loop settings (trainers.py:51-111; reference defaults cited
    per field there). ``device`` is the port's: where the model, its
    batches and its optimizer live ('cuda' unless the caller asks for the
    CPU)."""

    max_epochs: int = 1300
    check_val: int = 5
    batch_size: int = 1
    learning_rate: float = 0.0006130697604327541
    weight_decay: float = 0.00016303111017674179
    delta1: float = 10.0
    delta2: float = 8.0
    freeze_net_a: bool = True
    optimizer: str = "adamw"         # 'adamw' | 'adam8bit'
    seed: int = 0
    ckpt_dir: str = "checkpoints"
    log_dir: str = "logs"
    max_steps: Optional[int] = None
    # a device mesh (dp / dp×tp) over torch.distributed's processes:
    # PyferTrainer and the seg trainers (module docstring); batch_size
    # divides over 'data'
    mesh_shape: Optional[Dict[str, int]] = None
    feed_dtype: str = "float32"      # 'float32' | 'bfloat16' | 'packed'
    # every N epochs a never-rotated 'iter_<global_step>' slot
    save_per_epoch: Optional[int] = None
    # an epoch of exactly N samples, cycling through the shuffled cohort
    samples_per_epoch: Optional[int] = None
    grad_accum: int = 1
    remat_blocks: bool = False
    # a torch.profiler trace of the first epoch into this directory
    profile_dir: Optional[str] = None
    # C3D rates and schedules (train_light_c3d.py:179-243); horizons in
    # optimizer steps
    lr_encoder: Optional[float] = None
    lr_decoder: Optional[float] = None
    scheduler: Optional[str] = None       # 'multistep' | 'cosine' | 'plateau'
    milestones: Sequence[int] = ()
    gamma: float = 0.1
    t_max: Optional[int] = None
    eta_min: float = 0.0
    device: str = "cuda"


def _refuse_mesh(cfg: TrainConfig) -> None:
    if cfg.mesh_shape:
        raise NotImplementedError(
            f"mesh_shape={cfg.mesh_shape}: this trainer trains on one device; its mesh "
            "branch is ROADMAP queue 1 item 7.4 (PyferTrainer, TranSegTrainer and "
            "UNETRSegTrainer take a mesh)")


def _build_mesh(mesh_shape: Dict[str, int], device: torch.device):
    """The mesh of ``mesh_shape`` over every process of the group (:114-124):
    its axes' product must equal the world size."""
    from dose_prediction_tpu_torch.parallel import multihost as MH

    return MH.global_mesh(dict(mesh_shape), device=device)


def _check_mesh_batch(cfg: TrainConfig, mesh) -> None:
    if mesh is not None and cfg.batch_size % mesh.size("data"):
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by the 'data' mesh "
                         f"axis ({mesh.size('data')})")


def _feed_rows(batch_sharding):
    """(this process's 'data' index, the axis's size) where each process
    builds only its rows of the global batch (:202-210), else None (no
    mesh, or a 'data' axis of size 1: every process takes the whole
    batch). Pass it to the builders' ``process_rows`` and as
    device_prefetch's ``local_rows``."""
    if batch_sharding is None or batch_sharding.mesh.size("data") == 1:
        return None
    return batch_sharding.mesh.index("data"), batch_sharding.mesh.size("data")


def _timed_batches(iterator, timer: EpochTimer, bucket: str = "loader"):
    """Each batch's wait into the loader bucket (TrainerTime,
    network_trainer.py:186-191)."""
    it = iter(iterator)
    while True:
        timer.tick()
        try:
            batch = next(it)
        except StopIteration:
            timer._t0 = None
            return
        timer.tock(bucket)
        yield batch


def _train_batches(cfg: TrainConfig, train_ds, epoch: int, *, drop_last: bool = False,
                   process_rows=None):
    """One epoch's batches by cfg.feed_dtype (:213-238); a cohort that does
    not pack (non-binary masks or a non-integer 70·PTV) takes the float32
    feed, which the packed-built steps pass through. ``process_rows``
    builds only this process's rows (_feed_rows)."""
    if cfg.feed_dtype == "packed":
        from dose_prediction_tpu_torch.data.packed import pack_patient, packed_dose_batches

        patients = getattr(train_ds, "patients", None)
        if patients is not None and all(pack_patient(p) is not None for p in patients):
            return packed_dose_batches(train_ds, batch_size=cfg.batch_size,
                                       seed=cfg.seed + epoch, drop_last=drop_last,
                                       num_samples_per_epoch=cfg.samples_per_epoch,
                                       process_rows=process_rows)
        print("[feed] dataset not packable (non-binary masks or non-integer "
              "70*PTV); falling back to the float32 feed")
    return dose_batches(train_ds, batch_size=cfg.batch_size, seed=cfg.seed + epoch,
                        drop_last=drop_last, native_bf16=cfg.feed_dtype == "bfloat16",
                        num_samples_per_epoch=cfg.samples_per_epoch,
                        process_rows=process_rows)


def _padded_dose_val_batches(val_ds, val_batch: int):
    """The full-volume validation feed of a 'data' axis (:240-254): batches
    of ``val_batch`` rows, the last padded by repeating its last patient,
    with a 'valid' (B,) weight marking the real rows, in the batch-1
    sweep's order."""
    for batch in dose_batches(val_ds, batch_size=val_batch, shuffle=False, augment=False):
        n = batch["input"].shape[0]
        if n < val_batch:
            batch = {k: torch.cat([v] + [v[-1:]] * (val_batch - n)) for k, v in batch.items()}
        batch["valid"] = (torch.arange(val_batch) < n).float()
        yield batch


def _mesh_val_metrics(eval_fn, val_ds, mesh, batch_sharding, device) -> Dict[str, float]:
    """Validation over a 'data' axis (:257-276): each process scores its
    rows of ``mesh.size('data')`` patients a batch; ``eval_fn(batch)``
    returns the validity-weighted means of its rows and their count
    (dose_score_mean, val_loss_mean, n_valid). Their weighted sums,
    all-reduced over 'data', give the cohort's means, equal in exact
    arithmetic to the batch-1 sweep's."""
    from dose_prediction_tpu_torch.parallel.collectives import all_reduce_

    weighted = []
    for batch in device_prefetch(_padded_dose_val_batches(val_ds, mesh.size("data")),
                                 device=device, sharding=batch_sharding):
        s, l, n = eval_fn(batch)
        weighted.append(torch.stack([s * n, l * n, n]).float())
    if not weighted:
        return {"mean_dose_score": float("nan"), "val_loss": float("nan")}
    tot = all_reduce_(torch.stack(weighted).sum(0), mesh.group("data")).tolist()
    n_tot = max(tot[2], 1.0)
    return {"mean_dose_score": -tot[0] / n_tot, "val_loss": tot[1] / n_tot}


def _host_mean(losses: List[torch.Tensor]) -> float:
    """Float32 mean of an epoch's loss scalars (:325)."""
    if not losses:
        return float("nan")
    return float(torch.stack([l.float() for l in losses]).mean())


def to_host(tensors: Dict[str, torch.Tensor]) -> Callable[[], Dict[str, torch.Tensor]]:
    """Start copying ``tensors`` to pinned host memory; the returned function
    waits for that copy only, not for work queued after it (the overlap
    infer/pipeline.py describes)."""
    if not any(t.is_cuda for t in tensors.values()):
        return lambda: tensors
    host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v, non_blocking=True)
            for k, v in tensors.items()}
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return host

    return wait


# -- the graceful stop -------------------------------------------------------
# While a fit runs in the main thread, SIGTERM (a preemption notice) sets
# this flag instead of killing the process; each loop polls it, so the run
# ends at the next batch boundary after the epoch's 'last' save. The flag is
# reset when a fit starts.
_SHUTDOWN_REQUESTED = False


def _stop_requested(cfg: TrainConfig, global_step: int) -> bool:
    """max_steps reached, or SIGTERM received."""
    return _SHUTDOWN_REQUESTED or (cfg.max_steps is not None and global_step >= cfg.max_steps)


def _drains_checkpoints(fit_fn):
    """Install the graceful-SIGTERM handler for the fit (main thread only)
    and reach the checkpoint manager's drain point when it returns
    (:355-392)."""

    @functools.wraps(fit_fn)
    def wrapper(self, *args, **kwargs):
        global _SHUTDOWN_REQUESTED
        _SHUTDOWN_REQUESTED = False
        installed, prev_handler = False, None

        def on_sigterm(signum, frame):
            global _SHUTDOWN_REQUESTED
            _SHUTDOWN_REQUESTED = True
            print("[trainer] SIGTERM received: finishing the current step, saving "
                  "'last', then exiting", flush=True)

        try:
            prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
            installed = True
        except ValueError:
            pass  # not the main thread
        try:
            return fit_fn(self, *args, **kwargs)
        finally:
            if installed:
                signal.signal(signal.SIGTERM, prev_handler)
            ckpt = getattr(self, "ckpt", None)
            if ckpt is not None:
                ckpt.wait()

    return wrapper


def _save_epoch_slots(ckpt: C.CheckpointManager, cfg: TrainConfig, epoch: int,
                      global_step: int, tree: Dict[str, Any]) -> None:
    """'last' every epoch, 'iter_<global_step>' every cfg.save_per_epoch."""
    if cfg.save_per_epoch and (epoch + 1) % cfg.save_per_epoch == 0:
        ckpt.save_snapshot(global_step, tree)
    ckpt.save_last(tree)


def _resume_guard_config(cfg: TrainConfig, *models) -> Dict[str, Any]:
    """What a resumed run must match (:405-417): the optimizer family and
    every model-constructor argument."""
    return {"optimizer": cfg.optimizer,
            "models": [{"model": type(m).__name__, "config": model_spec(m)} for m in models]}


def _try_resume(ckpt: C.CheckpointManager, template: Dict[str, Any],
                run_config: Optional[Dict[str, Any]] = None):
    """The shared resume policy (:420-495): the 'last' slot, else the newest
    monitored one, degrading past an unreadable or mismatched slot. Returns
    (tree or None, start_epoch). Raises where the directory holds work this
    configuration cannot continue (a different run_config, or slots of which
    none restores), unless ``DPT_FRESH_ON_MISMATCH=1``."""
    fresh_ok = os.environ.get("DPT_FRESH_ON_MISMATCH") == "1"
    canon = lambda d: json.dumps(d, sort_keys=True, default=str)  # noqa: E731
    if run_config is not None:
        stored = ckpt.read_run_config()
        if stored is not None and canon(stored) != canon(run_config):
            msg = ("[resume] checkpoint dir was written by a run with different "
                   "graph-determining settings:\n"
                   f"  recorded: {canon(stored)}\n"
                   f"  current:  {canon(run_config)}\n"
                   "Resuming would train a different graph over the restored weights. "
                   "Relaunch with the recorded settings, or set DPT_FRESH_ON_MISMATCH=1 "
                   "to discard the old run.")
            if not fresh_ok:
                raise RuntimeError(msg)
            print(msg + "\n[resume] DPT_FRESH_ON_MISMATCH=1: starting FRESH; later saves "
                  "overwrite the old slots")
            ckpt.write_run_config(run_config)
            return None, 0
    restored = None
    last_failed = False
    try:
        restored = ckpt.restore_last(template)
    except Exception as e:   # a corrupt or mismatched slot: try the next one
        last_failed = True
        print(f"[resume] 'last' slot unreadable ({type(e).__name__}: {e}); falling back "
              "to monitored checkpoints")
    if restored is None:
        try:
            _, restored = ckpt.restore_latest(template)
        except Exception as e:
            print(f"[resume] monitored checkpoints unreadable ({type(e).__name__}: {e})")
            last_failed = True
    if run_config is not None and (restored is not None or not last_failed):
        ckpt.write_run_config(run_config)
    if restored is None:
        if last_failed:
            msg = ("[resume] existing checkpoints could not be restored against the "
                   "current model/optimizer structure (architecture or optimizer "
                   "changed?). Relaunch with the settings the run was trained with, or "
                   "set DPT_FRESH_ON_MISMATCH=1 to discard the old run and start fresh")
            if not fresh_ok:
                raise RuntimeError(msg)
            print(msg + "\n[resume] DPT_FRESH_ON_MISMATCH=1: starting FRESH")
            if run_config is not None:
                ckpt.write_run_config(run_config)
        return None, 0
    return restored, int(restored["epoch"]) + 1


def seeded(seed: int, build: Callable[[], torch.nn.Module]) -> torch.nn.Module:
    """A model built with torch's generators seeded from ``seed``."""
    with torch.random.fork_rng(devices=range(torch.cuda.device_count())):
        torch.manual_seed(seed)
        return build()


def _full_volume_validation(eval_step, val_ds: OpenKBPDataset, device: torch.device
                            ) -> Dict[str, float]:
    """The dose trainers' batch-1 full-volume sweep through ``eval_step``:
    mean_dose_score (negated, to maximize) and val_loss, each the mean over
    the cohort."""
    scores, vlosses = [], []
    for batch in device_prefetch(dose_batches(val_ds, batch_size=1, shuffle=False,
                                              augment=False), device=device):
        out = eval_step(batch)
        scores.append(float(out["dose_score"]))
        vlosses.append(float(out["val_loss"]))
    return {"mean_dose_score": -float(np.mean(scores)), "val_loss": float(np.mean(vlosses))}


def _sliding_val_sweep(predictor, val_ds: OpenKBPDataset, *, roi_size: Sequence[int],
                       sw_batch_size: int, val_scale: float, device: torch.device
                       ) -> Dict[str, float]:
    """The ×``val_scale`` sliding-window validation of the exp and ViT-GAN
    trainers (JAX trainers.py:279-309; train_light_{exp_models,gan}.py:218-247):
    per patient the blended full-resolution prediction, its GenLoss val loss
    and the masked MAE of the post-processed prediction against
    ``val_scale`` × the dose; mean_dose_score is that MAE's mean, negated
    (to maximize). Patient i+1's sweep is queued before patient i is scored."""
    scores, vlosses = [], []

    @torch.no_grad()
    def produce(p):
        x = torch.from_numpy(np.ascontiguousarray(p.model_input[None], np.float32)).to(device)
        gt = torch.from_numpy(np.ascontiguousarray(p.gt[None], np.float32)).to(device)
        pred = sliding_window_inference(STEP.to_ncdhw(x), predictor, roi_size=roi_size,
                                        sw_batch_size=sw_batch_size, out_channels=1)
        vloss = L.gen_loss(pred, STEP.to_ncdhw(gt), mode="val")
        return p, to_host({"pred": pred, "vloss": vloss})

    def consume(staged):
        p, wait = staged
        out = wait()
        vlosses.append(float(out["vloss"]))
        post = M.postprocess_prediction(out["pred"].numpy()[0, 0], p.dose_mask, scale=val_scale)
        scores.append(M.dose_score(post, val_scale * p.dose, p.dose_mask))

    for _ in pipeline_map(produce, consume, val_ds.patients):
        pass
    return {"mean_dose_score": -float(np.mean(scores)), "val_loss": float(np.mean(vlosses))}


class _SlidingDose:
    """The sliding-window ×``val_scale`` evaluation of a deep-supervision
    generator ``self.<attr>`` that the exp and ViT-GAN trainers share: its
    full-resolution head (``lambda x: self.forward(x)[0]``) in eval mode
    over windows of ``self.roi_size``."""

    _generator_attr = "model"

    def _predictor(self):
        model = getattr(self, self._generator_attr)
        model.eval()
        return lambda windows: model(windows)[0]

    def validate(self, val_ds: OpenKBPDataset, *, sw_batch_size: int = 4) -> Dict[str, float]:
        """mean_dose_score (negated, to maximize) and the GenLoss val_loss of
        the blended prediction over the cohort."""
        return _sliding_val_sweep(self._predictor(), val_ds, roi_size=self.roi_size,
                                  sw_batch_size=sw_batch_size, val_scale=self.val_scale,
                                  device=self.device)

    def predict_fn(self, sw_batch_size: int = 4) -> Callable[[Dict[str, torch.Tensor]],
                                                             torch.Tensor]:
        """``predict_fn(batch)``: the post-processed ×``val_scale`` prediction
        (NDHWC) of an NDHWC batch on the device."""
        predictor = self._predictor()

        @torch.no_grad()
        def predict(batch):
            pred = sliding_window_inference(STEP.to_ncdhw(batch["input"]), predictor,
                                            roi_size=self.roi_size, sw_batch_size=sw_batch_size,
                                            out_channels=1)
            return M.postprocess_prediction(pred.permute(0, 2, 3, 4, 1), batch["gt"][..., 1:2],
                                            scale=self.val_scale)

        return predict

    def test(self, test_ds: OpenKBPDataset, *, sw_batch_size: int = 4, with_ivs: bool = True,
             device_metrics: bool = False, plots_dir: Optional[str] = None) -> Dict[str, Any]:
        """The OpenKBP test sweep on the sliding-window ×``val_scale``
        predictions (train_light_{exp_models,gan}.py:263-300)."""
        return evaluate_dose_model(self.predict_fn(sw_batch_size), test_ds, with_ivs=with_ivs,
                                   device_metrics=device_metrics, plots_dir=plots_dir,
                                   device=self.device)


class PyferTrainer:
    """The flagship DOSE-PYFER trainer (:498-655)."""

    def __init__(self, cfg: TrainConfig, *, model: Optional[DosePyfer] = None,
                 pretrained_c3d_params: Optional[Dict[str, torch.Tensor]] = None,
                 example_shape: Sequence[int] = (1, 128, 128, 128, 9)):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.model = model if model is not None else seeded(cfg.seed, lambda: DosePyfer(
            img_size=tuple(example_shape[1:4]), remat_blocks=cfg.remat_blocks,
            device=self.device))
        if pretrained_c3d_params is not None:
            # net_A surgery before the optimizer exists: fresh moments do not
            # depend on the parameters
            merged, _ = C.load_pretrained_net_a(self.model.state_dict(), pretrained_c3d_params)
            self.model.load_state_dict(merged, strict=True)
        self.mesh = self.batch_sharding = plan = None
        if cfg.mesh_shape:
            from dose_prediction_tpu_torch.parallel import mesh as PM

            # shard before the optimizer exists: split leaves are new
            # parameters (the JAX branch shards its fresh state, :522-535)
            self.mesh = _build_mesh(cfg.mesh_shape, self.device)
            _check_mesh_batch(cfg, self.mesh)
            plan = PM.shard_params(self.model, self.mesh)
            self.batch_sharding = PM.batch_sharding(self.mesh)
        # freeze labels pair with freeze_net_a (:515-521)
        freeze = S.cascade_freeze_labels(self.model) if cfg.freeze_net_a else None
        optimizer = S.make_optimizer(self.model, learning_rate=cfg.learning_rate,
                                     weight_decay=cfg.weight_decay, freeze_labels=freeze,
                                     kind=cfg.optimizer, grad_accum=cfg.grad_accum)
        if plan is not None:
            optimizer.distribute(plan)
        self.state = S.TrainState(self.model, optimizer, plan=plan)
        step = STEP.make_pyfer_train_step(
            self.model, optimizer, delta1=cfg.delta1, delta2=cfg.delta2,
            freeze=cfg.freeze_net_a, packed=cfg.feed_dtype == "packed", mesh=self.mesh)
        self.train_step = AOT.maybe_wrap_train_step("pyfer", self.model, step, mesh=self.mesh)
        self.eval_step = STEP.make_pyfer_eval_step(self.model)
        self.logger = MetricLogger(cfg.log_dir, run_name="pyfer")
        self.ckpt = C.CheckpointManager(cfg.ckpt_dir, monitor="mean_dose_score", mode="max")
        self.best_val = -np.inf

    def validate(self, val_ds: OpenKBPDataset) -> Dict[str, float]:
        """The batch-1 full-volume sweep (train_light_pyfer.py:154-179):
        mean_dose_score (negated, to maximize) and val_loss; over a 'data'
        axis, several patients a batch (_mesh_val_metrics)."""
        if self.mesh is not None and self.mesh.size("data") > 1:
            def eval_fn(batch):
                out = self.eval_step(batch)
                return out["dose_score_mean"], out["val_loss_mean"], out["n_valid"]

            return _mesh_val_metrics(eval_fn, val_ds, self.mesh, self.batch_sharding,
                                     self.device)
        return _full_volume_validation(self.eval_step, val_ds, self.device)

    def batches(self, train_ds: OpenKBPDataset, epoch: int):
        """Epoch ``epoch``'s batches on the device; on a mesh, this process's
        rows of each global batch, a short last batch dropped."""
        rows = _feed_rows(self.batch_sharding)
        return device_prefetch(
            _train_batches(self.cfg, train_ds, epoch, drop_last=self.mesh is not None,
                           process_rows=rows),
            device=self.device, sharding=self.batch_sharding, local_rows=rows is not None)

    @_drains_checkpoints
    def fit(self, train_ds: OpenKBPDataset, val_ds: Optional[OpenKBPDataset] = None, *,
            resume: bool = True,
            on_validation: Optional[Callable[[int, Dict[str, float]], bool]] = None) -> None:
        """Train. ``on_validation(epoch, metrics) -> stop`` runs after each
        validation; True ends the fit (the HPO hook)."""
        cfg = self.cfg
        start_epoch = 0
        if resume:
            restored, start_epoch = _try_resume(
                self.ckpt, {"state": self.state, "epoch": 0},
                run_config=_resume_guard_config(cfg, self.model))
            if restored is not None:
                self.state = restored["state"]
                self.logger.log_text(f"resumed from epoch {start_epoch - 1}")
        timer = EpochTimer()
        global_step = int(self.state.step)
        for epoch in range(start_epoch, cfg.max_epochs):
            timer.reset()
            epoch_losses: List[torch.Tensor] = []
            feed = self.batches(train_ds, epoch)
            with trace(cfg.profile_dir if epoch == start_epoch else None), contextlib.closing(feed):
                for batch in _timed_batches(feed, timer):
                    timer.tick()
                    self.state, loss = self.train_step(self.state, batch)
                    epoch_losses.append(loss)
                    timer.tock("train")
                    global_step += 1
                    if _stop_requested(cfg, global_step):
                        break
            mean_loss = _host_mean(epoch_losses)
            self.logger.log({"train_mean_loss": mean_loss,
                             "moving_loss": float(self.state.moving_loss)}, epoch + 1)
            if val_ds is not None and (epoch + 1) % cfg.check_val == 0:
                timer.tick()
                vm = self.validate(val_ds)
                timer.tock("val")
                self.logger.log(vm, epoch + 1)
                self.best_val = max(self.best_val, vm["mean_dose_score"])
                self.ckpt.save(epoch, {"state": self.state, "epoch": epoch},
                               {"mean_dose_score": vm["mean_dose_score"]})
                if on_validation is not None and on_validation(epoch + 1, dict(vm)):
                    self.logger.log_text(f"early-stopped at epoch {epoch + 1}")
                    return
            _save_epoch_slots(self.ckpt, cfg, epoch, global_step,
                              {"state": self.state, "epoch": epoch})
            self.logger.log_text(f"epoch {epoch + 1}: {timer.report()}")
            if _stop_requested(cfg, global_step):
                break

    def test(self, test_ds: OpenKBPDataset, *, device_metrics: bool = False,
             plots_dir: Optional[str] = None) -> Dict[str, Any]:
        """OpenKBP scoring sweep (train_light_pyfer.py:199-287)."""
        results = evaluate_dose_model(lambda batch: self.eval_step(batch)["prediction"],
                                      test_ds, device_metrics=device_metrics,
                                      plots_dir=plots_dir, device=self.device)
        self.logger.log({"mean_dose_metric": results["mean_dose_score"],
                         "std_dose_metric": results["std_dose_score"],
                         "mean_dvh_metric": results["mean_dvh_score"]}, int(self.state.step))
        return results


def evaluate_dose_model(predict_fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                        ds: OpenKBPDataset, *, with_ivs: bool = True,
                        device_metrics: bool = False, plots_dir: Optional[str] = None,
                        plots_every: int = 8, device: str | torch.device = "cuda"
                        ) -> Dict[str, Any]:
    """The OpenKBP test sweep (dose, DVH and IVS, evaluate_openKBP.py:149-222;
    :657-737). ``predict_fn`` maps an NDHWC {'input', 'gt'} batch on
    ``device`` to the post-processed Gy prediction (1, D, H, W, 1).

    ``device_metrics`` scores each patient on the device, so only scalars
    (and the IVS curve) leave it; per-structure detail comes from the host
    path only. Through pipeline_map, patient i+1's work is queued before
    patient i's results are read. ``plots_dir`` writes per-patient DVH
    figures and slice triptychs (host predictions only, and matplotlib)."""
    if plots_dir and device_metrics:
        raise ValueError("plots_dir needs host predictions; use device_metrics=False")
    dev = resolve_device(device)
    dose_scores, dvh_scores, ivs_curves = [], [], []
    per_patient: Dict[str, Dict] = {}

    def produce(p):
        batch = {"input": torch.from_numpy(p.model_input[None]).to(dev),
                 "gt": torch.from_numpy(p.gt[None]).to(dev)}
        pred = predict_fn(batch)
        if device_metrics:
            return p, to_host(M.patient_scores_device(pred[0, ..., 0], p, with_ivs=with_ivs,
                                                       sync=False))
        return p, to_host({"pred": pred})

    def consume(staged):
        p, wait = staged
        out = wait()
        if device_metrics:
            ds_score = float(out["dose_dif"])
            dvh = {"dvh_dif": float(out["dvh_dif"]), "detail": {}}
            if with_ivs:
                ivs_curves.append(out["ivs"].numpy())
        else:
            pred = out["pred"].numpy()[0, ..., 0]
            ds_score = M.dose_score(pred, p.real_dose, p.dose_mask)
            dvh = M.dvh_score_for_patient(pred, p.real_dose, p.structures, p.spacing)
            if with_ivs:
                ivs_curves.append(M.ivs_sweep(pred, p.real_dose))
            if plots_dir:
                from pathlib import Path

                from dose_prediction_tpu_torch.evaluation.plots import (
                    plot_dvh,
                    save_slice_triptychs,
                )

                plot_dvh(pred, p.real_dose, p.structures,
                         Path(plots_dir) / f"dvh_{p.patient_id}.png")
                save_slice_triptychs(pred, p.real_dose, Path(plots_dir) / p.patient_id,
                                     every=plots_every)
        dose_scores.append(ds_score)
        if np.isfinite(dvh["dvh_dif"]):
            dvh_scores.append(dvh["dvh_dif"])
        per_patient[p.patient_id] = {"dose_dif": ds_score, "dvh_dif": dvh["dvh_dif"],
                                     **dvh["detail"]}

    for _ in pipeline_map(produce, consume, ds.patients):
        pass
    return {
        "mean_dose_score": float(np.mean(dose_scores)),
        "std_dose_score": float(np.std(dose_scores)),
        "mean_dvh_score": float(np.mean(dvh_scores)) if dvh_scores else float("nan"),
        "ivs": np.mean(np.stack(ivs_curves), axis=0).tolist() if ivs_curves else None,
        "per_patient": per_patient,
    }


class HDUNetTrainer:
    """The HD-UNet baseline (train_light_hdunet.py; :897-1009): masked-L1
    training, the batch-1 full-volume validation scored as the ×70 masked
    MAE (mean_dose_score, :127-163), best slots on mean_dose_score=max, an
    every-epoch 'last' slot with resume, and the OpenKBP test sweep
    (:165-186)."""

    def __init__(self, cfg: TrainConfig, *, model: Optional[HDUNet] = None,
                 example_shape: Sequence[int] = (1, 128, 128, 128, 9)):
        _refuse_mesh(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.model = model if model is not None else seeded(cfg.seed, lambda: HDUNet(
            in_ch=example_shape[-1], device=self.device))
        optimizer = S.make_optimizer(self.model, learning_rate=cfg.learning_rate,
                                     weight_decay=cfg.weight_decay)
        self.state = S.TrainState(self.model, optimizer)
        self.train_step = STEP.make_simple_dose_train_step(self.model, optimizer,
                                                           packed=cfg.feed_dtype == "packed")
        self.eval_step = STEP.make_simple_dose_eval_step(self.model)
        self.logger = MetricLogger(cfg.log_dir, run_name="hdunet")
        self.ckpt = C.CheckpointManager(cfg.ckpt_dir, monitor="mean_dose_score", mode="max")

    def validate(self, val_ds: OpenKBPDataset) -> Dict[str, float]:
        """mean_dose_score (negated, to maximize) and the masked-L1 val_loss
        over the cohort, one full volume a batch."""
        return _full_volume_validation(self.eval_step, val_ds, self.device)

    @_drains_checkpoints
    def fit(self, train_ds: OpenKBPDataset, val_ds: Optional[OpenKBPDataset] = None, *,
            resume: bool = True) -> None:
        cfg = self.cfg
        start_epoch = 0
        if resume:
            restored, start_epoch = _try_resume(
                self.ckpt, {"state": self.state, "epoch": 0},
                run_config=_resume_guard_config(cfg, self.model))
            if restored is not None:
                self.state = restored["state"]
                self.logger.log_text(f"resumed from epoch {start_epoch - 1}")
        global_step = int(self.state.step)
        for epoch in range(start_epoch, cfg.max_epochs):
            losses = []
            feed = device_prefetch(_train_batches(cfg, train_ds, epoch), device=self.device)
            with trace(cfg.profile_dir if epoch == start_epoch else None), contextlib.closing(feed):
                for batch in feed:
                    self.state, loss = self.train_step(self.state, batch)
                    losses.append(loss)
                    global_step += 1
                    if _stop_requested(cfg, global_step):
                        break
            self.logger.log({"train_mean_loss": _host_mean(losses)}, epoch + 1)
            if val_ds is not None and (epoch + 1) % cfg.check_val == 0:
                metrics = self.validate(val_ds)
                self.logger.log(metrics, epoch + 1)
                self.ckpt.save(epoch, {"state": self.state, "epoch": epoch},
                               {"mean_dose_score": metrics["mean_dose_score"]})
            _save_epoch_slots(self.ckpt, cfg, epoch, global_step,
                              {"state": self.state, "epoch": epoch})
            if _stop_requested(cfg, global_step):
                break

    def test(self, test_ds: OpenKBPDataset, *, with_ivs: bool = True,
             device_metrics: bool = False, plots_dir: Optional[str] = None) -> Dict[str, Any]:
        """OpenKBP test sweep (train_light_hdunet.py:165-186)."""
        return evaluate_dose_model(lambda batch: self.eval_step(batch)["prediction"], test_ds,
                                   with_ivs=with_ivs, device_metrics=device_metrics,
                                   plots_dir=plots_dir, device=self.device)


class CascadeC3DTrainer:
    """The C3D baseline (train_light_c3d.py; :740-895): masked-L1 cascade
    loss; split encoder/decoder rates when cfg.lr_encoder or lr_decoder is
    set, and cfg.scheduler picks multistep, cosine or plateau (the last per
    epoch on the moving train loss, train_light_c3d.py:239-241)."""

    def __init__(self, cfg: TrainConfig, *, model: Optional[CascadeC3D] = None,
                 example_shape: Sequence[int] = (1, 128, 128, 128, 9),
                 schedule: Optional[S.Schedule] = None,
                 plateau: Optional[S.ReduceLROnPlateau] = None):
        _refuse_mesh(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.model = model if model is not None else seeded(
            cfg.seed, lambda: CascadeC3D(device=self.device))
        if plateau is None and cfg.scheduler == "plateau":
            plateau = S.ReduceLROnPlateau(base_lr=cfg.learning_rate)
        self.plateau = plateau
        split = cfg.lr_encoder is not None or cfg.lr_decoder is not None

        def sched_of(base_lr):
            if schedule is not None:
                return schedule
            if cfg.scheduler == "multistep":
                return S.multistep_schedule(base_lr, cfg.milestones, cfg.gamma)
            if cfg.scheduler == "cosine":
                return S.cosine_schedule(
                    base_lr, cfg.t_max if cfg.t_max is not None else cfg.max_epochs, cfg.eta_min)
            return base_lr

        if plateau is not None:
            if split:
                raise ValueError("plateau + split encoder/decoder LRs is not supported "
                                 "(single injected lr)")
            plateau.lr = cfg.learning_rate
            optimizer = S.make_plateau_optimizer(self.model, base_lr=cfg.learning_rate,
                                                 weight_decay=cfg.weight_decay)
        elif split:
            optimizer = S.make_split_lr_optimizer(
                self.model,
                lr_encoder=sched_of(cfg.lr_encoder if cfg.lr_encoder is not None
                                    else cfg.learning_rate),
                lr_decoder=sched_of(cfg.lr_decoder if cfg.lr_decoder is not None
                                    else cfg.learning_rate),
                weight_decay=cfg.weight_decay)
        else:
            optimizer = S.make_optimizer(self.model, learning_rate=sched_of(cfg.learning_rate),
                                         weight_decay=cfg.weight_decay)
        self.state = S.TrainState(self.model, optimizer)
        self.train_step = STEP.make_cascade_c3d_train_step(self.model, optimizer,
                                                           packed=cfg.feed_dtype == "packed")
        self.logger = MetricLogger(cfg.log_dir, run_name="c3d")
        self.ckpt = C.CheckpointManager(cfg.ckpt_dir, monitor="mean_dose_score", mode="max")

    @torch.no_grad()
    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """net_B's head on an NDHWC input, NDHWC out (the JAX ``_predict``)."""
        self.model.eval()
        _, pred_b = self.model(STEP.to_ncdhw(x))
        return pred_b.permute(0, 2, 3, 4, 1)

    @_drains_checkpoints
    def fit(self, train_ds: OpenKBPDataset, val_ds: Optional[OpenKBPDataset] = None, *,
            resume: bool = True):
        cfg = self.cfg
        start_epoch = 0
        if resume:
            restored, start_epoch = _try_resume(
                self.ckpt, {"state": self.state, "epoch": 0},
                run_config=_resume_guard_config(cfg, self.model))
            if restored is not None:
                self.state = restored["state"]
                self.logger.log_text(f"resumed from epoch {start_epoch - 1}")
        global_step = int(self.state.step)
        # the whole-run best survives a resume: it lives in its slot
        # (network_trainer.py:69)
        best_train_loss = float("inf")
        if resume:
            prev = self.ckpt.restore_named("best_train_loss")
            if prev is not None:
                best_train_loss = float(prev["loss"])
        for epoch in range(start_epoch, cfg.max_epochs):
            losses = []
            feed = device_prefetch(_train_batches(cfg, train_ds, epoch), device=self.device)
            with trace(cfg.profile_dir if epoch == start_epoch else None), contextlib.closing(feed):
                for batch in feed:
                    self.state, loss = self.train_step(self.state, batch)
                    losses.append(loss)
                    global_step += 1
                    if _stop_requested(cfg, global_step):
                        break
            mean_loss = _host_mean(losses)
            self.logger.log({"train_mean_loss": mean_loss}, epoch + 1)
            # NetworkTrainer's 'best_train_loss' slot (network_trainer.py:171-175)
            if mean_loss < best_train_loss:
                best_train_loss = mean_loss
                self.ckpt.save_named("best_train_loss", {"state": self.state, "epoch": epoch,
                                                         "loss": float(mean_loss)})
            if val_ds is not None and (epoch + 1) % cfg.check_val == 0:
                scores = []
                for batch in dose_batches(val_ds, batch_size=1, shuffle=False, augment=False):
                    pred = self.predict(batch["input"].to(self.device)).cpu().numpy()
                    gt = batch["gt"].numpy()
                    post = M.postprocess_prediction(pred[..., 0], gt[..., 1])
                    scores.append(M.dose_score(post, 70 * gt[..., 0], gt[..., 1]))
                mds = -float(np.mean(scores))
                self.logger.log({"mean_dose_score": mds}, epoch + 1)
                self.ckpt.save(epoch, {"state": self.state, "epoch": epoch},
                               {"mean_dose_score": mds})
            if self.plateau is not None:
                new_lr = self.plateau.step(float(self.state.moving_loss))
                if new_lr != S.get_learning_rate(self.state.optimizer):
                    S.set_learning_rate(self.state.optimizer, new_lr)
                    self.logger.log({"lr": new_lr}, epoch + 1)
            _save_epoch_slots(self.ckpt, cfg, epoch, global_step,
                              {"state": self.state, "epoch": epoch})
            if _stop_requested(cfg, global_step):
                break

    def test(self, test_ds: OpenKBPDataset, *, with_ivs: bool = True,
             device_metrics: bool = False, plots_dir: Optional[str] = None) -> Dict[str, Any]:
        """OpenKBP test sweep (train_light_c3d.py:245-322)."""
        def predict_fn(batch):
            return M.postprocess_prediction(self.predict(batch["input"]),
                                            batch["gt"][..., 1:2])

        return evaluate_dose_model(predict_fn, test_ds, with_ivs=with_ivs,
                                   device_metrics=device_metrics, plots_dir=plots_dir,
                                   device=self.device)


class TranSegTrainer:
    """The OAR-TranSeg trainer (train_light_transeg.py; :1010-1186): DiceCE
    on crops, and a sliding-window validation at the crop's ROI with Dice,
    HD95 and the DiceCE val loss the best slot watches. Without ``model``
    it builds the full-width TranSeg of ``block_family`` and ``k7_mode``."""

    def __init__(self, cfg: TrainConfig, *, model: Optional[torch.nn.Module] = None,
                 crop: Sequence[int] = (96, 96, 96), num_classes: int = 8,
                 pretrained_params: Optional[Dict[str, torch.Tensor]] = None,
                 block_family: str = "seg", k7_mode: str = "dense"):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.crop = tuple(crop)
        self.num_classes = num_classes
        self.model = model if model is not None else seeded(cfg.seed, lambda: TranSeg(
            out_ch=num_classes, img_size=self.crop, remat_blocks=cfg.remat_blocks,
            block_family=block_family, k7_mode=k7_mode, device=self.device))
        if pretrained_params is not None:
            # shape-matched partial restore (train_light_transeg.py:126-146),
            # on whole leaves before a mesh splits them (:1029-1032)
            merged, _ = C.merge_partial(self.model.state_dict(), pretrained_params)
            self.model.load_state_dict(merged, strict=True)
        self.mesh = self.batch_sharding = plan = None
        if cfg.mesh_shape:
            from dose_prediction_tpu_torch.parallel import mesh as PM

            # as PyferTrainer: the ViT on its heads and decoder4's convs by
            # output channel over 'model', BatchNorm over the global batch
            self.mesh = _build_mesh(cfg.mesh_shape, self.device)
            _check_mesh_batch(cfg, self.mesh)
            plan = PM.shard_params(self.model, self.mesh)
            self.batch_sharding = PM.batch_sharding(self.mesh)
        optimizer = S.make_optimizer(self.model, learning_rate=cfg.learning_rate,
                                     weight_decay=cfg.weight_decay)
        if plan is not None:
            optimizer.distribute(plan)
        self.state = S.TrainState(self.model, optimizer, plan=plan)
        self.train_step = AOT.maybe_wrap_train_step(
            "transeg", self.model, STEP.make_transeg_train_step(self.model, optimizer,
                                                                mesh=self.mesh),
            mesh=self.mesh)
        self.logger = MetricLogger(cfg.log_dir, run_name="transeg")
        self.ckpt = C.CheckpointManager(cfg.ckpt_dir, monitor="val_loss", mode="min")

    @torch.no_grad()
    def sliding_logits(self, volume: torch.Tensor, *, sw_batch_size: int = 4) -> torch.Tensor:
        """The eval-mode sliding-window logits ``(1, num_classes, D, H, W)`` of
        a ``(1, 1, D, H, W)`` CT on the device at the crop's ROI. On a mesh
        whose 'data' axis is above 1, the window batch is split over it
        (sliding_window_inference_sharded; every ``sw_batch_size`` runs the
        same sweep, as the JAX trainer's one program, :1069-1093); on a
        'model'-only mesh, the local engine over the sharded model. Every
        rank returns the same logits."""
        self.model.eval()
        if self.mesh is not None and self.mesh.size("data") > 1:
            return sliding_window_inference_sharded(volume, self.model, self.mesh,
                                                    roi_size=self.crop,
                                                    out_channels=self.num_classes)
        return sliding_window_inference(volume, self.model, roi_size=self.crop,
                                        sw_batch_size=sw_batch_size,
                                        out_channels=self.num_classes)

    def validate(self, val_ds: OpenKBPDataset, *, sw_batch_size: int = 4):
        """(Dice, HD95, val loss) over the cohort (train_light_transeg.py:205-242):
        the val loss is the DiceCE of the sliding-window logits
        (``sliding_logits``)."""
        dices, hds, vlosses = [], [], []

        @torch.no_grad()
        def produce(p):
            gt_labels = np.asarray(p.oars_label_encoded)
            vol = torch.from_numpy(np.ascontiguousarray(p.ct[None, None], np.float32))
            logits = self.sliding_logits(vol.to(self.device), sw_batch_size=sw_batch_size)
            labels = torch.from_numpy(gt_labels[None].astype(np.int64)).to(self.device)
            vloss = L.dice_ce_loss(logits, labels)
            return p, gt_labels, to_host({"labels": logits.argmax(dim=1), "vloss": vloss})

        def consume(staged):
            p, gt_labels, wait = staged
            out = wait()
            vlosses.append(float(out["vloss"]))
            d, h = M.seg_metrics_per_class(out["labels"].numpy()[0], gt_labels,
                                           self.num_classes, p.spacing)
            dices.append(np.nanmean(d))
            hds.append(np.nanmean(h))

        for _ in pipeline_map(produce, consume, val_ds.patients):
            pass
        return float(np.nanmean(dices)), float(np.nanmean(hds)), float(np.mean(vlosses))

    def batches(self, train_ds: OpenKBPDataset, epoch: int, *, num_samples: int = 4):
        """Epoch ``epoch``'s crops on the device (:1117-1130): ``num_samples``
        a patient, drawn from ``seed + epoch``; on a mesh, this process's rows
        of each global batch, a short last batch dropped."""
        cfg = self.cfg
        rows = _feed_rows(self.batch_sharding)
        return device_prefetch(seg_batches(
            train_ds, crop=self.crop, num_samples=num_samples, batch_size=cfg.batch_size,
            seed=cfg.seed + epoch, drop_last=self.mesh is not None,
            num_samples_per_epoch=cfg.samples_per_epoch, process_rows=rows,
            # seg has no packed format: 'packed' ships the bf16 CT
            feed_dtype="bfloat16" if cfg.feed_dtype in ("bfloat16", "packed") else "float32"),
            device=self.device, sharding=self.batch_sharding, local_rows=rows is not None)

    @_drains_checkpoints
    def fit(self, train_ds, val_ds=None, *, num_samples: int = 4, resume: bool = True):
        cfg = self.cfg
        start_epoch = 0
        if resume:
            restored, start_epoch = _try_resume(
                self.ckpt, {"state": self.state, "epoch": 0},
                run_config=_resume_guard_config(cfg, self.model))
            if restored is not None:
                self.state = restored["state"]
                self.logger.log_text(f"resumed from epoch {start_epoch - 1}")
        global_step = int(self.state.step)
        for epoch in range(start_epoch, cfg.max_epochs):
            losses = []
            feed = self.batches(train_ds, epoch, num_samples=num_samples)
            with trace(cfg.profile_dir if epoch == start_epoch else None), contextlib.closing(feed):
                for batch in feed:
                    self.state, loss = self.train_step(self.state, batch)
                    losses.append(loss)
                    global_step += 1
                    if _stop_requested(cfg, global_step):
                        break
            self.logger.log({"train_loss": _host_mean(losses)}, epoch + 1)
            if val_ds is not None and (epoch + 1) % cfg.check_val == 0:
                dice, hd95, val_loss = self.validate(val_ds)
                self.logger.log({"dice_metric": dice, "hd95_metric": hd95,
                                 "val_loss": val_loss}, epoch + 1)
                self.ckpt.save(epoch, {"state": self.state, "epoch": epoch},
                               {"val_loss": val_loss})
            _save_epoch_slots(self.ckpt, cfg, epoch, global_step,
                              {"state": self.state, "epoch": epoch})
            if _stop_requested(cfg, global_step):
                break


class UNETRSegTrainer(TranSegTrainer):
    """Seg mode_model=0: the plain UNETR on TranSegTrainer's DiceCE and
    sliding-window harness (train_light_transeg.py:93-107; :1188-1200)."""

    def __init__(self, cfg: TrainConfig, *, model: Optional[UNETR] = None,
                 crop: Sequence[int] = (96, 96, 96), num_classes: int = 8,
                 pretrained_params: Optional[Dict[str, torch.Tensor]] = None):
        if model is None:
            model = seeded(cfg.seed, lambda: UNETR(out_ch=num_classes, img_size=tuple(crop),
                                                   device=resolve_device(cfg.device)))
        super().__init__(cfg, model=model, crop=crop, num_classes=num_classes,
                         pretrained_params=pretrained_params)


class DoseGANTrainer:
    """DoseGAN (train_light_dosegan.py; :1315-1451): one critic and one
    generator update a batch (STEP.make_dosegan_train_steps), the batch-1
    full-volume generator validation scored as the unmasked L1 val_loss and
    the ×70 masked MAE (mean_dose_score, :157-198), best slots on
    mean_dose_score=max, an every-epoch 'last' slot of ``{"g", "d",
    "epoch"}`` with resume, and the OpenKBP test sweep (:207-225).

    Defaults are the reference's (:199-205,298): ngf = ndf = 64, the L1
    weight 10, both nets Adam at 2e-4 with b1 0.5. The critic is
    unconditional (one dose channel in). Without ``generator`` or
    ``discriminator`` each is built from the seed (the critic from seed +
    1, as the JAX trainer draws its keys)."""

    def __init__(self, cfg: TrainConfig, *, ngf: int = 64, ndf: int = 64,
                 generator: Optional[UnetGenerator3D] = None,
                 discriminator: Optional[NLayerDiscriminator] = None,
                 example_shape: Sequence[int] = (1, 128, 128, 128, 9),
                 l1_weight: float = 10.0, gan_lr: float = 2e-4):
        _refuse_mesh(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.gen = generator if generator is not None else seeded(cfg.seed, lambda: UnetGenerator3D(
            in_ch=example_shape[-1], out_ch=1, ngf=ngf, device=self.device))
        self.disc = discriminator if discriminator is not None else seeded(
            cfg.seed + 1, lambda: NLayerDiscriminator(in_ch=1, ndf=ndf, device=self.device))
        g_opt = S.make_optimizer(self.gen, learning_rate=gan_lr, b1=0.5)
        d_opt = S.make_optimizer(self.disc, learning_rate=gan_lr, b1=0.5)
        self.g_state = S.TrainState(self.gen, g_opt)
        self.d_state = S.TrainState(self.disc, d_opt)
        self.step = STEP.make_dosegan_train_steps(self.gen, self.disc, g_opt, d_opt,
                                                  l1_weight=l1_weight,
                                                  packed=cfg.feed_dtype == "packed")
        self.eval_step = STEP.make_dosegan_eval_step(self.gen)
        self.logger = MetricLogger(cfg.log_dir, run_name="dosegan")
        self.ckpt = C.CheckpointManager(cfg.ckpt_dir, monitor="mean_dose_score", mode="max")

    def _tree(self, epoch: int) -> Dict[str, Any]:
        return {"g": self.g_state, "d": self.d_state, "epoch": epoch}

    def validate(self, val_ds: OpenKBPDataset) -> Dict[str, float]:
        """mean_dose_score (negated, to maximize) and the unmasked L1
        val_loss over the cohort, one full volume a batch."""
        return _full_volume_validation(self.eval_step, val_ds, self.device)

    @_drains_checkpoints
    def fit(self, train_ds: OpenKBPDataset, val_ds: Optional[OpenKBPDataset] = None, *,
            resume: bool = True) -> None:
        cfg = self.cfg
        start_epoch = 0
        if resume:
            restored, start_epoch = _try_resume(
                self.ckpt, self._tree(0),
                run_config=_resume_guard_config(cfg, self.gen, self.disc))
            if restored is not None:
                self.g_state, self.d_state = restored["g"], restored["d"]
                self.logger.log_text(f"resumed from epoch {start_epoch - 1}")
        global_step = int(self.g_state.step)
        for epoch in range(start_epoch, cfg.max_epochs):
            g_losses, d_losses = [], []
            feed = device_prefetch(_train_batches(cfg, train_ds, epoch), device=self.device)
            with trace(cfg.profile_dir if epoch == start_epoch else None), contextlib.closing(feed):
                for batch in feed:
                    self.g_state, self.d_state, info = self.step(self.g_state, self.d_state, batch)
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

    def test(self, test_ds: OpenKBPDataset, *, with_ivs: bool = True,
             device_metrics: bool = False, plots_dir: Optional[str] = None) -> Dict[str, Any]:
        """OpenKBP test sweep (train_light_dosegan.py:207-225)."""
        return evaluate_dose_model(lambda batch: self.eval_step(batch)["prediction"], test_ds,
                                   with_ivs=with_ivs, device_metrics=device_metrics,
                                   plots_dir=plots_dir, device=self.device)


class ExpModelTrainer(_SlidingDose):
    """The experiments zoo's harness (train_light_exp_models.py TestModel;
    :1202-1320): any model returning a deep-supervision output list trains
    with non-cascade GenLoss (``huber`` optional, :193) under AdamW at
    cfg.learning_rate and cfg.weight_decay; validation and test run the
    sliding window with roi = the full example size and a ×80 dose scale
    (:222-236,271-280); best slots on mean_dose_score=max, an every-epoch
    'last' slot and resume (:372-374,412). Without ``model`` it trains the
    exp generator (models/experiments.py::exp_generator) from cfg.seed."""

    def __init__(self, cfg: TrainConfig, model: Optional[torch.nn.Module] = None, *,
                 example_shape: Sequence[int] = (1, 128, 128, 128, 9), huber: bool = False,
                 val_scale: float = 80.0):
        from dose_prediction_tpu_torch.models.experiments import exp_generator

        _refuse_mesh(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.val_scale = val_scale
        self.roi_size = tuple(example_shape[1:4])
        self.model = model if model is not None else seeded(cfg.seed, lambda: exp_generator(
            img_size=tuple(example_shape[1:4]), device=self.device))
        optimizer = S.make_optimizer(self.model, learning_rate=cfg.learning_rate,
                                     weight_decay=cfg.weight_decay)
        self.state = S.TrainState(self.model, optimizer)
        self.train_step = STEP.make_deep_supervision_train_step(
            self.model, optimizer, delta1=cfg.delta1, delta2=cfg.delta2, huber=huber,
            packed=cfg.feed_dtype == "packed")
        self.logger = MetricLogger(cfg.log_dir, run_name="exp_model")
        self.ckpt = C.CheckpointManager(cfg.ckpt_dir, monitor="mean_dose_score", mode="max")

    @_drains_checkpoints
    def fit(self, train_ds: OpenKBPDataset, val_ds: Optional[OpenKBPDataset] = None, *,
            resume: bool = True) -> None:
        cfg = self.cfg
        start_epoch = 0
        if resume:
            restored, start_epoch = _try_resume(
                self.ckpt, {"state": self.state, "epoch": 0},
                run_config=_resume_guard_config(cfg, self.model))
            if restored is not None:
                self.state = restored["state"]
                self.logger.log_text(f"resumed from epoch {start_epoch - 1}")
        global_step = int(self.state.step)
        for epoch in range(start_epoch, cfg.max_epochs):
            losses = []
            feed = device_prefetch(_train_batches(cfg, train_ds, epoch), device=self.device)
            with trace(cfg.profile_dir if epoch == start_epoch else None), contextlib.closing(feed):
                for batch in feed:
                    self.state, loss = self.train_step(self.state, batch)
                    losses.append(loss)
                    global_step += 1
                    if _stop_requested(cfg, global_step):
                        break
            self.logger.log({"train_mean_loss": _host_mean(losses)}, epoch + 1)
            if val_ds is not None and (epoch + 1) % cfg.check_val == 0:
                metrics = self.validate(val_ds)
                self.logger.log(metrics, epoch + 1)
                self.ckpt.save(epoch, {"state": self.state, "epoch": epoch},
                               {"mean_dose_score": metrics["mean_dose_score"]})
            _save_epoch_slots(self.ckpt, cfg, epoch, global_step,
                              {"state": self.state, "epoch": epoch})
            if _stop_requested(cfg, global_step):
                break
