"""Several processes on torch.distributed (counterpart of
dose_prediction_tpu/parallel/multihost.py).

One process per device: ``initialize`` joins this process to the group, and
a mesh over every process (``global_mesh``) gives the trainers their data
and model axes (parallel/mesh.py). Where a JAX process passes its shard of a
batch and gets back one global array, a process here keeps its own rows on
its own device (data/pipeline.py::device_prefetch).

The backend follows from the device: NCCL for 'cuda', gloo for 'cpu'. An
explicit ``backend='gloo'`` serves several processes on one card (NCCL
refuses two ranks on one device); parallel/collectives.py uses only the two
collectives gloo runs on CUDA tensors.

Typical use (one process per device):

    from dose_prediction_tpu_torch.parallel import multihost as MH
    dev = MH.initialize("10.0.0.1:29500", num_processes=4, process_id=rank)
    mesh = MH.global_mesh({"data": 2, "model": 2})

With no arguments ``initialize`` reads torch's environment (``env://``:
MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), as a launcher such as torchrun
sets it.
"""

from __future__ import annotations

import datetime
import os
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from dose_prediction_tpu_torch.device import resolve_device
from dose_prediction_tpu_torch.parallel.mesh import Mesh, create_mesh

# how long a collective or the rendezvous waits for the other ranks
TIMEOUT = datetime.timedelta(seconds=600)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: str | torch.device = "cuda", backend: Optional[str] = None
               ) -> torch.device:
    """Join this process to the group and return its device.

    ``coordinator_address`` is rank 0's ``host:port`` (a TCP rendezvous);
    with it, pass the world size and this process's rank. Without it the
    environment names them (module docstring). On 'cuda' the device is
    ``LOCAL_RANK`` (or the rank) modulo the cards this process sees, made
    current; the backend is NCCL there, gloo on the CPU, unless
    ``backend`` says otherwise."""
    dev = resolve_device(device)
    if coordinator_address is None:
        init_method = "env://"
        rank = int(os.environ.get("RANK", 0))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
        rank = process_id
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {} if coordinator_address is None else dict(world_size=num_processes,
                                                         rank=process_id)
    dist.init_process_group(backend, init_method=init_method, timeout=TIMEOUT, **kwargs)
    return dev


def global_mesh(axis_sizes: Mapping[str, int], *, device: Optional[torch.device] = None
                ) -> Mesh:
    """A mesh over every process of the group: the axes' product must equal
    the world size. Put 'data' first, so that 'model', the last axis, varies
    fastest over the ranks (the ranks of one host, on a cluster)."""
    return create_mesh(axis_sizes, device=device)


def process_slice(n_items: int) -> slice:
    """The contiguous slice of a length-``n_items`` dataset owned by this
    process (an equal split; ``n_items`` must divide over the processes)."""
    num = dist.get_world_size() if dist.is_initialized() else 1
    pid = dist.get_rank() if dist.is_initialized() else 0
    if n_items % num:
        raise ValueError(f"{n_items} items do not split over {num} processes")
    per = n_items // num
    return slice(pid * per, (pid + 1) * per)
