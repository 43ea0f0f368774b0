"""A 1-deep dispatch pipeline for the serve path (counterpart of
dose_prediction_tpu/infer/pipeline.py::pipeline_map, :35-49).

On the card the overlap comes from CUDA's asynchronous launches: ``produce``
queues item i+1's kernels (for example a cascade request, which returns as
soon as its launches are queued) before ``consume`` waits for item i. On one
stream, ``consume`` must wait on an event that ``produce`` recorded after
item i's launches (``torch.cuda.Event.synchronize``): ``torch.cuda
.synchronize()``, or a host read that queues a kernel or a copy behind item
i+1's launches, waits for item i+1 as well, and the overlap is lost. The JAX
module's ``StreamingCascade``, the two stages placed on two devices, is not
ported.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator


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
