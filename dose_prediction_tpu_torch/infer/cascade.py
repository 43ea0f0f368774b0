"""The linked serve cascade: CT → OAR segmentation (sliding-window or one
dense forward) → one-hot masks → concat(PTV, OARs, CT) → DOSE-PYFER dose map
(counterpart of dose_prediction_tpu/infer/cascade.py; reference
LinkedNet.test_step, train_light_linked_model.py:138-176).

Volumes cross the stage boundaries channels-last (NDHWC), as in the JAX
package; each stage permutes once to NCDHW on the way in and once back on the
way out. Like the JAX package, no inter-stage axis permutes of the
reference (:157-165) are applied.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch.func import functional_call

from dose_prediction_tpu_torch.evaluation.metrics import postprocess_prediction
from dose_prediction_tpu_torch.infer.aot import GraphPool, LazyAOTStage
from dose_prediction_tpu_torch.infer.sliding_window import sliding_window_inference


def make_cascade_stages(seg_model: torch.nn.Module, dose_model: torch.nn.Module, *,
                        num_oar_classes: int = 8, roi_size: Sequence[int] = (96, 96, 96),
                        sw_batch_size: int = 4, overlap: float = 0.25,
                        dose_scale: float = 70.0, seg_mode: str = "sliding"):
    """The two cascade stages, as in the JAX package:
    ``stage1(seg_vars, ct, ptv) -> structures`` (seg + one-hot + 9-channel
    concat) and ``stage2(dose_vars, structures, dose_mask) -> dose_gy``.

    ``seg_vars`` / ``dose_vars`` are the models' state dicts (name → tensor;
    ``model.state_dict()`` gives them), applied with ``torch.func
    .functional_call`` as the JAX stages apply their variables. Volumes are
    ``(1, D, H, W, C)``; the models run in eval mode, without autograd, in
    the dtype of the volumes they are given.

    ``seg_mode``: 'sliding', the reference's sweep of overlapping ROI
    windows (:152-154); or 'dense', one seg forward over the whole volume,
    for a TranSeg built with ``trained_grid`` = (roi / patch)³ so that its
    position embedding resizes. Dense equals sliding only where the ROI
    covers the volume (JAX cascade.py:54-61)."""
    if seg_mode not in ("sliding", "dense"):
        raise ValueError(f"unknown seg_mode {seg_mode!r} (want 'sliding' or 'dense')")
    seg_model.eval()
    dose_model.eval()

    @torch.inference_mode()
    def stage1(seg_vars: Mapping[str, torch.Tensor], ct: torch.Tensor,
               ptv: torch.Tensor) -> torch.Tensor:
        volume = ct.permute(0, 4, 1, 2, 3)
        if seg_mode == "dense":
            logits = functional_call(seg_model, seg_vars, (volume.contiguous(),))
        else:
            logits = sliding_window_inference(
                volume, lambda windows: functional_call(seg_model, seg_vars, (windows,)),
                roi_size=roi_size, sw_batch_size=sw_batch_size, overlap=overlap,
                out_channels=num_oar_classes)
        labels = logits.argmax(dim=1)                      # (1, D, H, W)
        # one-hot (channels-last), background dropped (:157-160)
        oars = F.one_hot(labels, num_oar_classes)[..., 1:].to(ct.dtype)
        # 9-channel dose input = (PTV, 7 OARs, CT) (:167)
        return torch.cat([ptv, oars, ct], dim=-1)

    @torch.inference_mode()
    def stage2(dose_vars: Mapping[str, torch.Tensor], structures: torch.Tensor,
               dose_mask: torch.Tensor) -> torch.Tensor:
        _, preds_b = functional_call(dose_model, dose_vars,
                                     (structures.permute(0, 4, 1, 2, 3).contiguous(),))
        # mask out-of-region and negative voxels, scale to Gy (:171-173)
        return postprocess_prediction(preds_b[0].permute(0, 2, 3, 4, 1), dose_mask,
                                      scale=dose_scale)

    return stage1, stage2


def make_cascade_fn(seg_model: torch.nn.Module, seg_variables: Mapping[str, torch.Tensor],
                    dose_model: torch.nn.Module, dose_variables: Mapping[str, torch.Tensor], *,
                    num_oar_classes: int = 8, roi_size: Sequence[int] = (96, 96, 96),
                    sw_batch_size: int = 4, overlap: float = 0.25, dose_scale: float = 70.0,
                    seg_mode: str = "sliding", aot: bool = False,
                    input_dtype: torch.dtype | None = None
                    ) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """The linked serve program (counterpart of the JAX make_cascade_fn,
    infer/cascade.py:95-167): ``run(ct, ptv, dose_mask) -> dose_gy``, with
    the models' state dicts bound. The three volumes are ``(1, D, H, W, 1)``;
    ``dose_gy`` is ``(1, D, H, W, 1)`` in Gy, masked and clamped as the
    reference post-processes it (:171-173).

    ``input_dtype`` casts ct, ptv and dose_mask before dispatch; the models
    compute in that dtype with float32 parameters. ``run`` launches stage 1
    and then stage 2 asynchronously, with no host synchronisation between
    them.

    ``aot=True`` serves each stage as a CUDA graph captured at its first
    call (infer/aot.py::LazyAOTStage, named 'stage1', or 'stage1_dense' in
    dense mode, and 'stage2', sharing one graph memory pool). It needs CUDA
    tensors and raises on others; under ``DPT_NO_AOT=1`` it runs the eager
    stages. ``run.stages`` holds the stages it calls. The JAX function's
    ``fuse`` (one XLA program for both stages, optimised across them) has
    no counterpart: one CUDA graph of both stages would replay the same
    kernels as the two graphs and optimise nothing across them."""
    stage1, stage2 = make_cascade_stages(
        seg_model, dose_model, num_oar_classes=num_oar_classes, roi_size=roi_size,
        sw_batch_size=sw_batch_size, overlap=overlap, dose_scale=dose_scale, seg_mode=seg_mode)

    def cast(x: torch.Tensor) -> torch.Tensor:
        return x if input_dtype is None else x.to(input_dtype)

    if aot:
        pool = GraphPool()
        stage1 = LazyAOTStage("stage1_dense" if seg_mode == "dense" else "stage1", stage1,
                              pool=pool)
        stage2 = LazyAOTStage("stage2", stage2, pool=pool)

    def run(ct: torch.Tensor, ptv: torch.Tensor, dose_mask: torch.Tensor) -> torch.Tensor:
        return stage2(dose_variables, stage1(seg_variables, cast(ct), cast(ptv)), cast(dose_mask))

    run.stages = (stage1, stage2)
    return run
