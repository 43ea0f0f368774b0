"""Linked-model evaluation: the end-to-end serve path as a harness
(counterpart of dose_prediction_tpu/train/linked.py; reference
train_light_linked_model.py LinkedNet :65-130 and test_step :138-228).

A trained TranSeg (any block family and k7 mode) and a trained DOSE-PYFER
are composed through make_cascade_fn; each patient of a cohort runs the
full cascade and is scored (dose score, DVH score, IVS curve), with DVH
plots and slice triptychs on request. The caller loads the weights by
name, as the JAX package does, not by the reference's positional key zip
(:83-97).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from dose_prediction_tpu_torch.evaluation import metrics as M
from dose_prediction_tpu_torch.infer.cascade import make_cascade_fn
from dose_prediction_tpu_torch.infer.pipeline import pipeline_map
from dose_prediction_tpu_torch.models import DosePyfer
from dose_prediction_tpu_torch.train.trainers import to_host
from dose_prediction_tpu_torch.utils.logging import MetricLogger


class LinkedModel:
    """A trained seg model and a trained DOSE-PYFER, weights loaded, composed
    for full-cascade inference. The seg model carries its own block family
    and k7 mode, and in ``seg_mode='dense'`` its ``trained_grid`` (roi / 16
    for a ROI-trained checkpoint); the CLI builds both from a checkpoint's
    slot. ``serve_dtype='bfloat16'`` casts the volumes, so that the cascade
    computes in bf16 with float32 parameters, and on a CUDA device serves
    through the captured stages (make_cascade_fn(aot=True)), as the JAX class
    serves through its shipped executables. On the CPU, and in float32, it
    runs the eager stages."""

    def __init__(self, seg_model: torch.nn.Module, dose_model: DosePyfer, *,
                 roi_size: Sequence[int] = (96, 96, 96), sw_batch_size: int = 4,
                 seg_mode: str = "sliding", serve_dtype: str = "float32"):
        if serve_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown serve_dtype {serve_dtype!r}")
        self.seg_model, self.dose_model = seg_model, dose_model
        self.device = next(seg_model.parameters()).device
        self.run = make_cascade_fn(
            seg_model, seg_model.state_dict(), dose_model, dose_model.state_dict(),
            roi_size=roi_size, sw_batch_size=sw_batch_size, seg_mode=seg_mode,
            aot=serve_dtype == "bfloat16" and self.device.type == "cuda",
            input_dtype=torch.bfloat16 if serve_dtype == "bfloat16" else None)

    def _request(self, patient) -> torch.Tensor:
        def volume(a):
            return torch.from_numpy(np.ascontiguousarray(a[None, ..., None])).to(self.device)

        return self.run(volume(patient.ct), volume(patient.ptv), volume(patient.dose_mask))

    def predict_patient(self, patient) -> np.ndarray:
        """Full cascade on one patient record → dose map in Gy (D, H, W),
        float32."""
        return self._request(patient).float().cpu().numpy()[0, ..., 0]

    def evaluate(self, ds, *, log_dir: Optional[str] = None, plots_dir: Optional[str] = None,
                 with_ivs: bool = True) -> Dict[str, Any]:
        """The reference test loop (:138-228): per-patient dose and DVH
        scores and the IVS curve, DVH plots and slice error maps when
        ``plots_dir`` is given (matplotlib). Through pipeline_map, patient
        i+1's cascade is queued before patient i's prediction is read."""
        dose_scores, dvh_scores, ivs_curves = [], [], []
        per_patient: Dict[str, Dict] = {}

        def produce(p):
            return p, to_host({"pred": self._request(p)})

        def consume(staged):
            p, wait = staged
            pred = wait()["pred"].float().numpy()[0, ..., 0]
            score = M.dose_score(pred, p.real_dose, p.dose_mask)
            dvh = M.dvh_score_for_patient(pred, p.real_dose, p.structures, p.spacing)
            dose_scores.append(score)
            if np.isfinite(dvh["dvh_dif"]):
                dvh_scores.append(dvh["dvh_dif"])
            if with_ivs:
                ivs_curves.append(M.ivs_sweep(pred, p.real_dose))
            per_patient[p.patient_id] = {"dose_dif": score, "dvh_dif": dvh["dvh_dif"]}
            if plots_dir:
                from dose_prediction_tpu_torch.evaluation.plots import (
                    plot_dvh,
                    save_slice_triptychs,
                )

                plot_dvh(pred, p.real_dose, p.structures,
                         Path(plots_dir) / f"dvh_{p.patient_id}.png")
                save_slice_triptychs(pred, p.real_dose, Path(plots_dir) / p.patient_id, every=8)

        for _ in pipeline_map(produce, consume, ds.patients):
            pass
        results = {
            "mean_dose_score": float(np.mean(dose_scores)),
            "std_dose_score": float(np.std(dose_scores)),
            "mean_dvh_score": float(np.mean(dvh_scores)) if dvh_scores else float("nan"),
            "ivs": np.mean(np.stack(ivs_curves), axis=0).tolist() if ivs_curves else None,
            "per_patient": per_patient,
        }
        if log_dir:
            MetricLogger(log_dir, run_name="linked").log(
                {"mean_dose_metric": results["mean_dose_score"],
                 "mean_dvh_metric": results["mean_dvh_score"]}, 0)
        return results
