"""A 1-deep dispatch pipeline for the serve path (counterpart of
dose_prediction_tpu/infer/pipeline.py::pipeline_map, :35-49).

On the card the overlap comes from CUDA's asynchronous launches: ``produce``
queues item i+1's kernels (for example a cascade request, which returns as
soon as its launches are queued) before ``consume`` waits for item i. On one
stream, ``consume`` must wait on an event that ``produce`` recorded after
item i's launches (``torch.cuda.Event.synchronize``): ``torch.cuda
.synchronize()``, or a host read that queues a kernel or a copy behind item
i+1's launches, waits for item i+1 as well, and the overlap is lost.

``StreamingCascade`` (JAX :51-100) places the cascade's two stages on two
cards and streams patients through that pipeline: card A segments patient
i+1 while card B computes patient i's dose, so a sweep approaches the
slower stage's time instead of the sum. With one card both stages share
it and run one after the other: the same results, no overlap.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Sequence, Tuple

import torch


def pipeline_map(produce: Callable[[Any], Any], consume: Callable[[Any], Any],
                 items: Iterable[Any]) -> Iterator[Any]:
    """Yield ``consume(produce(item))`` for each item, in order, calling
    ``produce`` on item i+1 before ``consume`` on item i."""
    pending = None
    for item in items:
        produced = produce(item)
        if pending is not None:
            yield consume(pending)
        pending = produced
    if pending is not None:
        yield consume(pending)


class StreamingCascade:
    """The linked cascade with its stages on two devices. The arguments are
    make_cascade_fn's; ``seg_device`` and ``dose_device`` default to
    ``cuda:0`` and ``cuda:{1 % device_count}`` (a missing card raises;
    ``'cpu'`` for both runs on the CPU). The state dicts are copied to their
    stage's device once. Inputs are ``(1, D, H, W, 1)`` volumes on any
    device; each dose map comes back on ``dose_device``."""

    def __init__(self, seg_model: torch.nn.Module, seg_variables, dose_model: torch.nn.Module,
                 dose_variables, *, seg_device=None, dose_device=None,
                 num_oar_classes: int = 8, roi_size: Sequence[int] = (96, 96, 96),
                 sw_batch_size: int = 4, overlap: float = 0.25, dose_scale: float = 70.0,
                 seg_mode: str = "sliding"):
        from dose_prediction_tpu_torch.device import resolve_device
        from dose_prediction_tpu_torch.infer.cascade import make_cascade_stages

        self.seg_device = resolve_device("cuda:0" if seg_device is None else seg_device)
        if dose_device is None:
            dose_device = f"cuda:{1 % max(torch.cuda.device_count(), 1)}"
        self.dose_device = resolve_device(dose_device)
        self._stage1, self._stage2 = make_cascade_stages(
            seg_model, dose_model, num_oar_classes=num_oar_classes, roi_size=roi_size,
            sw_batch_size=sw_batch_size, overlap=overlap, dose_scale=dose_scale,
            seg_mode=seg_mode)
        self._seg_vars = {k: v.to(self.seg_device) for k, v in seg_variables.items()}
        self._dose_vars = {k: v.to(self.dose_device) for k, v in dose_variables.items()}

    def _seg(self, inputs: Tuple[Any, Any, Any]):
        ct, ptv, dose_mask = inputs
        structures = self._stage1(self._seg_vars, ct.to(self.seg_device),
                                  ptv.to(self.seg_device))
        # the A -> B hop, queued on A right behind this patient's stage 1: a
        # copy queued after the next patient's sweep would wait for it
        return (structures.to(self.dose_device, non_blocking=True),
                dose_mask.to(self.dose_device, non_blocking=True))

    def _dose(self, staged):
        structures, dose_mask = staged
        return self._stage2(self._dose_vars, structures, dose_mask)

    def run_one(self, ct: torch.Tensor, ptv: torch.Tensor, dose_mask: torch.Tensor):
        """One patient, through both stages in turn."""
        return self._dose(self._seg((ct, ptv, dose_mask)))

    def run_stream(self, patients: Iterable[Tuple[Any, Any, Any]]) -> Iterator[Any]:
        """Stream ``(ct, ptv, dose_mask)`` triples through pipeline_map; yields
        the dose maps in order, patient i+1's segmentation queued on the seg
        device before patient i's dose."""
        return pipeline_map(self._seg, self._dose, patients)
