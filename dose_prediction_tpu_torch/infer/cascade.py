"""The linked serve cascade: CT → sliding-window OAR segmentation → one-hot
masks → concat(PTV, OARs, CT) → DOSE-PYFER dose map (counterpart of
dose_prediction_tpu/infer/cascade.py::make_cascade_stages, sliding mode;
reference LinkedNet.test_step, train_light_linked_model.py:138-176).

Volumes cross the stage boundaries channels-last (NDHWC), as in the JAX
package; each stage permutes once to NCDHW on the way in and once back on the
way out. Like the JAX package, no inter-stage axis permutes of the
reference (:157-165) are applied.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch.func import functional_call

from dose_prediction_tpu_torch.evaluation.metrics import postprocess_prediction
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
    the dtype of the volumes they are given. Only ``seg_mode='sliding'`` is
    ported."""
    if seg_mode != "sliding":
        raise ValueError(f"seg_mode {seg_mode!r} is not ported; only 'sliding' is")
    seg_model.eval()
    dose_model.eval()

    @torch.inference_mode()
    def stage1(seg_vars: Mapping[str, torch.Tensor], ct: torch.Tensor,
               ptv: torch.Tensor) -> torch.Tensor:
        logits = sliding_window_inference(
            ct.permute(0, 4, 1, 2, 3),
            lambda windows: functional_call(seg_model, seg_vars, (windows,)),
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
