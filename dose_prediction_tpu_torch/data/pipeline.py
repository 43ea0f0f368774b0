"""Host→card training feed: shuffled epochs, host-side augmentation, and a
prefetch through pinned memory on a CUDA copy stream; counterpart of
dose_prediction_tpu/data/pipeline.py (_local_row_range :27, dose_batches
:42, seg_batches :125, linked_batches :240, device_prefetch :298).

The builders draw from ``np.random.default_rng(seed)`` in the JAX builders'
order, so one seed gives both packages the same batches, bit for bit. They
yield dicts of CPU torch tensors with the JAX builders' keys, channels-last
layouts and dtypes (float32, bfloat16, uint8). Not ported yet: the sharded
feed (``host_to_global``, ``device_prefetch(sharding=..., local_rows=...)``),
which waits for torch.distributed.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from dose_prediction_tpu_torch.data.openkbp import OpenKBPDataset
from dose_prediction_tpu_torch.data.transforms import (
    apply_dose_augment,
    apply_seg_augment,
    augment_dose_sample,
    augment_seg_sample,
    draw_augment_decisions,
    draw_seg_aug_decisions,
    seg_crop_starts,
)
from dose_prediction_tpu_torch.device import resolve_device

Batch = Dict[str, torch.Tensor]
# how long device_prefetch waits for its worker to end after the consumer
# stops: the worker finishes the batch in its hands first (a 128³ float32
# batch is built in well under a second)
JOIN_TIMEOUT_S = 60.0


def _local_row_range(batch_size: int, process_rows) -> tuple:
    """The [lo, hi) rows of a global batch owned by this process.

    ``process_rows`` is (process_index, process_count): the contiguous equal
    split, process p owning rows [p·per, (p+1)·per)."""
    pid, num = process_rows
    if batch_size % num:
        raise ValueError(
            f"global batch {batch_size} does not divide over {num} processes")
    per = batch_size // num
    return pid * per, (pid + 1) * per


def _epoch_order(n: int, rng: np.random.Generator, shuffle: bool,
                 num_samples_per_epoch: int | None) -> np.ndarray:
    order = np.arange(n)
    if shuffle:
        rng.shuffle(order)
    if num_samples_per_epoch is not None:
        reps = -(-num_samples_per_epoch // len(order))
        order = np.tile(order, reps)[:num_samples_per_epoch]
    return order


def dose_batches(
    dataset: OpenKBPDataset,
    *,
    batch_size: int = 1,
    shuffle: bool = True,
    augment: bool = True,
    seed: int = 0,
    drop_last: bool = False,
    num_samples_per_epoch: int | None = None,
    native_bf16: bool = False,
    process_rows=None,
) -> Iterator[Batch]:
    """One epoch of {'input': (N,D,H,W,9), 'gt': (N,D,H,W,2)} batches.

    ``num_samples_per_epoch`` reproduces the legacy loader's index-wraparound
    sampling (dataloader_OpenKBP_C3D.py:129-134): an epoch longer (or
    shorter) than the dataset cycles through it modulo its length.

    ``process_rows=(process_index, process_count)`` builds only this
    process's contiguous row slice of each global batch: non-owned rows
    consume the identical augmentation draws but skip the dataset and the
    augmentation. Partial tail batches are dropped.

    ``native_bf16=True`` augments through the fused C++ gather
    (native/dose_io.cpp::dose_io_augment_dose_bf16) and yields bfloat16
    batches: one pass instead of several numpy copies, and half the
    host→card payload. The decisions are drawn once and shared with the
    numpy chain, which runs if the library is unavailable or declines.
    """
    rng = np.random.default_rng(seed)
    order = _epoch_order(len(dataset), rng, shuffle, num_samples_per_epoch)
    lo, hi = (None, None)
    if process_rows is not None:
        lo, hi = _local_row_range(batch_size, process_rows)
    for i in range(0, len(order), batch_size):
        idx = order[i:i + batch_size]
        if (drop_last or process_rows is not None) and len(idx) < batch_size:
            return
        inputs, gts = [], []
        for r, j in enumerate(idx):
            if lo is not None and not (lo <= r < hi):
                if augment:
                    draw_augment_decisions(rng)  # stream parity with owners
                continue
            p = dataset[int(j)]
            inp, gt = p.model_input, p.gt
            if augment and native_bf16 and inp.shape[0] == inp.shape[1]:
                from dose_prediction_tpu_torch.data import native as N

                decisions = draw_augment_decisions(rng)
                out = N.augment_dose_bf16(inp, gt, decisions=decisions)
                if out is not None:
                    inputs.append(out[0])
                    gts.append(out[1])
                    continue
                inp, gt = apply_dose_augment(inp, gt, *decisions)
            elif augment:
                inp, gt = augment_dose_sample(inp, gt, rng)
            inp, gt = torch.from_numpy(inp), torch.from_numpy(gt)
            if native_bf16:
                inp, gt = inp.to(torch.bfloat16), gt.to(torch.bfloat16)
            inputs.append(inp)
            gts.append(gt)
        yield {"input": torch.stack(inputs), "gt": torch.stack(gts)}


def seg_batches(
    dataset: OpenKBPDataset,
    *,
    crop: Sequence[int] = (96, 96, 96),
    num_samples: int = 4,
    batch_size: int = 4,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = False,
    feed_dtype: str = "float32",
    num_samples_per_epoch: int | None = None,
    process_rows=None,
) -> Iterator[Batch]:
    """Seg epochs: pos/neg crops ×num_samples per patient, batched
    ({'ct': (N,*crop,1), 'labels': (N,*crop) uint8}).

    ``process_rows=(process_index, process_count)``: yield only this
    process's contiguous row slice of each global batch. Crop starts and
    augment decisions are drawn for every global row (they depend on
    per-patient data, so every process walks one rng stream); partial tail
    batches are dropped.

    Labels ship as uint8 and ``feed_dtype='bfloat16'`` ships the CT window
    as bf16, through the fused native crop+augment gather when the library
    is available and the volume needs no padding (the decisions share the
    numpy chain's stream either way). ``num_samples_per_epoch`` is the legacy
    wraparound epoch sizing counted in patient visits."""
    rng = np.random.default_rng(seed)
    ct_dtype = torch.bfloat16 if feed_dtype == "bfloat16" else torch.float32
    order = _epoch_order(len(dataset), rng, shuffle, num_samples_per_epoch)
    use_native = False
    if feed_dtype == "bfloat16":
        from dose_prediction_tpu_torch.data import native as N

        use_native = N.native_available()
    lo, hi = (None, None)
    if process_rows is not None:
        lo, hi = _local_row_range(batch_size, process_rows)
    buf_ct: List[torch.Tensor] = []
    buf_lab: List[torch.Tensor] = []
    gpos = 0  # position of the next crop within the GLOBAL batch

    def owned() -> bool:
        return lo is None or (lo <= gpos < hi)

    def batch_ready() -> bool:
        # the global batch is full when gpos wraps; the local buffer then
        # holds this process's slice of it (the whole batch when lo is None)
        return gpos == 0 and bool(buf_ct)

    def keep(cvol, clab: np.ndarray) -> None:
        if not torch.is_tensor(cvol):
            cvol = torch.from_numpy(np.ascontiguousarray(cvol)).to(ct_dtype)
        buf_ct.append(cvol[..., None])
        buf_lab.append(torch.from_numpy(np.ascontiguousarray(clab, np.uint8)))

    def flush() -> Batch:
        batch = {"ct": torch.stack(buf_ct), "labels": torch.stack(buf_lab)}
        buf_ct.clear()
        buf_lab.clear()
        return batch

    for j in order:
        p = dataset[int(j)]
        if use_native and all(s >= c for s, c in zip(p.ct.shape, crop)):
            labels_u8 = np.ascontiguousarray(p.oars_label_encoded, np.uint8)
            ct_f32 = np.ascontiguousarray(p.ct, np.float32)
            starts = seg_crop_starts(ct_f32.shape, labels_u8, rng,
                                     crop=crop, num_samples=num_samples)
            for start in starts:
                decisions = draw_seg_aug_decisions(rng)
                if owned():
                    res = N.augment_seg_bf16(ct_f32, labels_u8, start, crop, decisions)
                    if res is None:
                        sl = tuple(slice(s, s + c) for s, c in zip(start, crop))
                        res = apply_seg_augment(ct_f32[sl], labels_u8[sl], *decisions)
                    keep(*res)
                gpos = (gpos + 1) % batch_size
                if batch_ready():
                    yield flush()
            continue
        # numpy chain: augment_seg_sample fuses draws with application, so
        # non-owned crops still compute (stream parity is what matters)
        for cvol, clab in augment_seg_sample(p.ct, p.oars_label_encoded.astype(np.float32),
                                             rng, crop=crop, num_samples=num_samples):
            if owned():
                keep(cvol, clab)
            gpos = (gpos + 1) % batch_size
            if batch_ready():
                yield flush()
    if buf_ct and not drop_last and process_rows is None:
        yield flush()


def linked_batches(
    dataset: OpenKBPDataset,
    *,
    batch_size: int = 1,
    shuffle: bool = True,
    seed: int = 0,
) -> Iterator[Batch]:
    """Linked-model batches (dataloader_OpenKBP_linked_monai.py:203-209):
    Input = (CT, PTV) 2ch; GT = (label-encoded OARs, dose, dose_mask) 3ch."""
    rng = np.random.default_rng(seed)
    order = _epoch_order(len(dataset), rng, shuffle, None)
    for i in range(0, len(order), batch_size):
        inputs, gts = [], []
        for j in order[i:i + batch_size]:
            p = dataset[int(j)]
            inputs.append(np.stack([p.ct, p.ptv], axis=-1).astype(np.float32))
            gts.append(np.stack([
                p.oars_label_encoded.astype(np.float32), p.dose, p.dose_mask,
            ], axis=-1).astype(np.float32))
        yield {"input": torch.from_numpy(np.stack(inputs)),
               "gt": torch.from_numpy(np.stack(gts))}


def device_prefetch(iterator: Iterator[Batch], *, size: int = 2,
                    device: str | torch.device = "cuda") -> Iterator[Batch]:
    """Build batches in a worker thread and keep ``size`` of them on the card
    ahead of compute (the JAX package's device_prefetch, as
    pin_memory + a copy stream).

    On a CUDA device the worker pins each tensor and copies it with
    ``non_blocking=True`` on a side stream, then records an event there.
    The consumer makes its current stream wait on that event and calls
    ``record_stream`` on each tensor, so the caching allocator does not
    reuse a batch's memory while the compute stream still reads it. On the
    CPU (``device='cpu'``) the tensors are passed on with no stream.

    An exception in the worker is raised in the consumer. When the consumer
    stops early (a break, ``close()``, an exception), the worker is released,
    the staged batches are dropped and the generator waits for the worker
    thread to end (at most ``JOIN_TIMEOUT_S``), so that once ``close()``
    returns no batch is held in its hands."""
    dev = resolve_device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err: List[BaseException] = []
    stop = threading.Event()
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(batch: Batch):
        if copy_stream is None:
            return {k: v.to(dev) for k, v in batch.items()}, None
        with torch.cuda.stream(copy_stream):
            out = {k: v.pin_memory().to(dev, non_blocking=True) for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return out, ready

    def offer(item) -> bool:
        """put() that gives up when the consumer abandoned the generator: a
        blocking put would keep ``size`` batches on the card after an early
        break."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in iterator:
                if not offer(put(batch)):
                    return
        except BaseException as e:  # raised again in the consumer
            err.append(e)
        finally:
            offer(sentinel)

    t = threading.Thread(target=worker, name="device_prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            batch, ready = item
            if ready is not None:
                compute = torch.cuda.current_stream(dev)
                compute.wait_event(ready)
                for v in batch.values():
                    v.record_stream(compute)
            yield batch
    finally:
        # normal exit, an early break or an exception in the consumer:
        # release the worker and every staged batch
        # the worker gives up within one offer() timeout once ``stop`` is
        # set, after the batch in its hands; wait for that, so that it holds
        # nothing, then drop the staged batches. Draining first would free a
        # slot to a blocked put, and the worker would build one batch more.
        stop.set()
        t.join(JOIN_TIMEOUT_S)
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
