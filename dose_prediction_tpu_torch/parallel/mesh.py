"""Device mesh and sharding rules on torch.distributed (counterpart of
dose_prediction_tpu/parallel/mesh.py).

- A ``Mesh`` over ('data', 'model'): a ``DeviceMesh`` of the processes, one
  device each, with one process group per axis. Axes of size 1 are kept, as
  in JAX, so that one rule set works from one process up; an axis a mesh
  does not name has size 1.
- Data parallelism: the batch's rows are split over 'data'. The masked
  losses divide by the mask count of the global batch
  (train/losses.py), gradients are summed over 'data' after the backward
  (train/state.py), and BatchNorm takes the global batch's statistics
  (parallel/sharded.py).
- Tensor parallelism, Megatron's splits over 'model' (``VIT_TP_RULES``):
  the output features of the ViT's ``qkv`` and ``linear1`` (and
  ``linear1``'s bias), the input features of ``out_proj`` and ``linear2``,
  and the output channels of the ``skip4`` / ``decoder4`` convs. Everything
  else is replicated.

Where GSPMD places the collectives in the JAX package, the port runs them
itself (parallel/collectives.py), and ``shard_params`` swaps the modules
that compute on a split leaf for their sharded forms (parallel/sharded.py).

The rules select the leaves the JAX rules select, on the same logical axis,
in torch layouts: a ``Linear`` weight is (out, in) where the JAX kernel is
(in, out), a conv weight (O, I, k…) and a transposed conv's (I, O, k…)
(core/torch_import.py), whose output channels are dim 1. An axis that does
not divide its dimension is dropped, as at mesh.py:80-99.

One layout differs on purpose. GSPMD's ``P(None, 'model')`` cuts the fused
(qkv, heads, head_dim) output axis of ``qkv`` into contiguous parts, which
cross the q|k|v boundary; XLA then inserts whatever collectives that
layout needs. The port computes attention on each rank's own heads, so a
'model' rank holds the q, k and v rows of its heads: ``qkv`` is split by
head (``Shard.blocks`` = 3), and ``qkv`` and ``out_proj`` are split only
where the heads divide over the axis. The numbers are those of the
unsharded step; a checkpoint holds whole leaves under the single-device
names either way.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from dose_prediction_tpu_torch.parallel import collectives as C


class Mesh:
    """Processes arranged over named axes; this process's device.

    ``shape`` keeps the axes in the order given (the last varies fastest
    over the ranks, as a JAX mesh reshapes its device list)."""

    def __init__(self, device_mesh, shape: Dict[str, int], device: torch.device):
        self.device_mesh = device_mesh
        self.shape = dict(shape)
        self.device = device

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def group(self, axis: str):
        """The axis's process group, None where the axis has size 1."""
        return self.device_mesh.get_group(axis) if self.size(axis) > 1 else None

    def index(self, axis: str) -> int:
        """This process's coordinate on ``axis``."""
        return self.device_mesh.get_local_rank(axis) if self.size(axis) > 1 else 0

    @property
    def writes(self) -> bool:
        """Whether this process writes what the mesh writes once (rank 0)."""
        return dist.get_rank() == 0

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device})"


def _world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def create_mesh(axis_sizes: Mapping[str, int], *, device: Optional[torch.device] = None
                ) -> Mesh:
    """A mesh of {'data': n_dp, 'model': n_tp} over the processes of the
    default group (multihost.initialize); the product must equal their
    count. ``device`` is this process's (the current CUDA device by
    default, where there is one, else the CPU)."""
    sizes = {str(k): int(v) for k, v in axis_sizes.items()}
    if not sizes or any(v < 1 for v in sizes.values()):
        raise ValueError(f"mesh axes must have sizes of at least 1, got {dict(axis_sizes)}")
    total, have = math.prod(sizes.values()), _world_size()
    if total != have:
        raise ValueError(f"mesh wants {total} devices, have {have} (one per process of "
                         "torch.distributed's default group)")
    if not dist.is_initialized():
        raise ValueError("create_mesh needs torch.distributed initialised "
                         "(parallel/multihost.py::initialize)")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(device.type, tuple(sizes.values()),
                                   mesh_dim_names=tuple(sizes))
    return Mesh(device_mesh, sizes, device)


# ---------------------------------------------------------------------------
# sharding rules: (parameter-name regex, Split); first match wins; default
# replicated
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Split:
    """A rule's logical split: ``feature`` 'out' or 'in' of a Linear or conv
    leaf over the mesh axis ``axis``."""

    axis: str
    feature: str


VIT_TP_RULES: Tuple[Tuple[str, Split], ...] = (
    (r".*attn\.qkv\.weight$", Split("model", "out")),
    (r".*attn\.out_proj\.weight$", Split("model", "in")),
    (r".*mlp\.linear1\.weight$", Split("model", "out")),
    (r".*mlp\.linear1\.bias$", Split("model", "out")),
    (r".*mlp\.linear2\.weight$", Split("model", "in")),
    # wide conv weights: output channels, the stage at the top level (TranSeg,
    # UNETR) or below it (DOSE-PYFER's net_B); a norm's weight there has no
    # feature dim (_feature_dim), as the JAX rule names kernels only
    (r"(^|.*\.)(skip4|decoder4)\..*\.weight$", Split("model", "out")),
)


@dataclasses.dataclass(frozen=True)
class Shard:
    """A leaf split over the mesh axis ``axis``: dim ``dim`` (torch layout)
    in ``size`` equal parts, or, with ``blocks`` > 1, each of ``blocks``
    equal blocks of the dim in ``size`` parts alike (``qkv``: q, k and v,
    each by head)."""

    axis: str
    dim: int
    size: int
    blocks: int = 1

    def whole_shape(self, local_shape) -> Tuple[int, ...]:
        s = list(local_shape)
        s[self.dim] *= self.size
        return tuple(s)

    def local_shape(self, whole_shape) -> Tuple[int, ...]:
        s = list(whole_shape)
        s[self.dim] //= self.size
        return tuple(s)

    def _part(self, whole: torch.Tensor, index: int) -> torch.Tensor:
        """The view of ``whole`` that part ``index`` holds, with the dim as
        (blocks, n)."""
        s = tuple(whole.shape)
        v = whole.view(s[:self.dim] + (self.blocks, s[self.dim] // self.blocks) + s[self.dim + 1:])
        n = v.shape[self.dim + 1] // self.size
        return v.narrow(self.dim + 1, index * n, n)

    def take(self, whole: torch.Tensor, index: int) -> torch.Tensor:
        """Part ``index`` of ``whole``, in memory of its own."""
        part = self._part(whole.contiguous(), index)
        return part.reshape(self.local_shape(whole.shape)).clone()

    def put(self, whole: torch.Tensor, local: torch.Tensor, index: int) -> None:
        """Write ``local`` into its part of ``whole`` (contiguous)."""
        part = self._part(whole, index)
        part.copy_(local.reshape(part.shape))

    def gather(self, local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        """The whole leaf on every rank of the axis (no autograd)."""
        whole = local.new_zeros(self.whole_shape(local.shape))
        self.put(whole, local.detach(), mesh.index(self.axis))
        return C.all_reduce_(whole, mesh.group(self.axis))


def _spec_for_path(path: str, rules: Sequence[Tuple[str, Split]]) -> Optional[Split]:
    for pattern, split in rules:
        if re.match(pattern, path):
            return split
    return None


def _feature_dim(module: nn.Module, leaf: str, feature: str) -> Optional[int]:
    """The torch dim of ``feature`` in ``module``'s ``leaf``; None where the
    module has none (a norm's weight, say: the JAX rules name kernels)."""
    if isinstance(module, nn.Linear):
        return {"out": 0, "in": 1}[feature] if leaf == "weight" else \
            (0 if feature == "out" else None)
    if leaf != "weight":
        return None
    if isinstance(module, nn.ConvTranspose3d):
        return {"out": 1, "in": 0}[feature]
    if isinstance(module, nn.Conv3d):
        return {"out": 0, "in": 1}[feature]
    return None


def param_shardings(model: nn.Module, mesh: Mesh,
                    rules: Sequence[Tuple[str, Split]] = ()) -> Dict[str, Shard]:
    """The split leaves of ``model`` by name (every other leaf is
    replicated), from ``rules`` matched against the parameter names. A split
    whose axis the mesh lacks or has at size 1, or whose axis does not
    divide the dimension (for attention, the heads), is dropped."""
    from dose_prediction_tpu_torch.nn.vit import SABlock

    modules = dict(model.named_modules())
    out: Dict[str, Shard] = {}
    for name, p in model.named_parameters():
        split = _spec_for_path(name, rules)
        if split is None or mesh.size(split.axis) <= 1:
            continue
        owner, _, leaf = name.rpartition(".")
        dim = _feature_dim(modules[owner], leaf, split.feature)
        if dim is None or dim >= p.ndim:
            continue
        size = mesh.size(split.axis)
        parent, _, child = owner.rpartition(".")
        block = modules.get(parent)
        if isinstance(block, SABlock) and child in ("qkv", "out_proj"):
            if block.heads % size:
                continue
            out[name] = Shard(split.axis, dim, size, 3 if child == "qkv" else 1)
        elif p.shape[dim] % size == 0:
            out[name] = Shard(split.axis, dim, size)
    return out


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A batch's rows split over the mesh axis ``axis`` (JAX's NamedSharding
    of ``P(axis)``); a feed with no sharding ships the whole batch to every
    process, as ``P()`` would."""

    mesh: Mesh
    axis: str = "data"

    def rows(self, n: int) -> slice:
        """This process's rows of a global batch of ``n``."""
        parts = self.mesh.size(self.axis)
        if n % parts:
            raise ValueError(f"global batch {n} does not divide over the {parts} "
                             f"'{self.axis}' ranks")
        per = n // parts
        i = self.mesh.index(self.axis)
        return slice(i * per, (i + 1) * per)


def batch_sharding(mesh: Mesh, *, axis: str = "data") -> Sharding:
    """The leading (batch) dim over ``axis``."""
    return Sharding(mesh, axis)


class ShardPlan:
    """What ``shard_params`` split: each split leaf's ``Shard`` by name and by
    parameter, with the conversions a checkpoint needs between this
    process's parts and whole leaves under the single-device names."""

    def __init__(self, mesh: Mesh, shards: Dict[str, Shard], model: nn.Module):
        self.mesh = mesh
        self.shards = dict(shards)
        self._by_param = {id(p): shards[n] for n, p in model.named_parameters() if n in shards}

    def shard_of(self, p: torch.Tensor) -> Optional[Shard]:
        return self._by_param.get(id(p))

    def whole_model_state(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """``model.state_dict()`` with every split leaf gathered whole
        (a collective: every rank calls it)."""
        sd = model.state_dict()
        return {k: self.shards[k].gather(v, self.mesh) if k in self.shards else v
                for k, v in sd.items()}

    def local_model_state(self, saved: Mapping[str, torch.Tensor], model: nn.Module
                          ) -> Dict[str, torch.Tensor]:
        """This process's parts of a state dict of whole leaves."""
        mine = model.state_dict()
        out = dict(saved)
        for k, shard in self.shards.items():
            if k not in saved:
                continue
            want = shard.whole_shape(mine[k].shape)
            if tuple(saved[k].shape) != want:
                raise ValueError(f"checkpoint shapes do not match the model: {k} "
                                 f"{tuple(saved[k].shape)}, want {want}")
            out[k] = shard.take(saved[k], self.mesh.index(shard.axis))
        return out

    def _optimizer_leaves(self, optimizer) -> list:
        return [self.shard_of(p) for g in optimizer.param_groups for p in g["params"]]

    def whole_optimizer_state(self, optimizer) -> dict:
        """``optimizer.state_dict()`` with each split leaf's state gathered
        whole (a collective)."""
        sd = optimizer.state_dict()
        shards = self._optimizer_leaves(optimizer)
        params = [p for g in optimizer.param_groups for p in g["params"]]
        state = {}
        for i, st in sd["state"].items():
            shard = shards[i]
            state[i] = {k: shard.gather(v, self.mesh)
                        if shard is not None and torch.is_tensor(v)
                        and v.shape == params[i].shape else v
                        for k, v in st.items()}
        return {**sd, "state": state}

    def local_optimizer_state(self, saved: dict, optimizer) -> dict:
        """This process's parts of an optimizer state of whole leaves."""
        shards = self._optimizer_leaves(optimizer)
        params = [p for g in optimizer.param_groups for p in g["params"]]
        state = {}
        for i, st in saved.get("state", {}).items():
            shard = shards[i] if i < len(shards) else None
            state[i] = {k: shard.take(v, self.mesh.index(shard.axis))
                        if shard is not None and torch.is_tensor(v)
                        and tuple(v.shape) == shard.whole_shape(params[i].shape) else v
                        for k, v in st.items()}
        return {**saved, "state": state}


def _broadcast_state(model: nn.Module) -> None:
    """Every parameter and buffer from rank 0 of the default group, so that
    replicas start alike whatever each process built."""
    if dist.get_world_size() == 1:
        return
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=0)


def shard_params(model: nn.Module, mesh: Mesh,
                 rules: Sequence[Tuple[str, Split]] = VIT_TP_RULES) -> ShardPlan:
    """Shard ``model`` over ``mesh`` in place: its state broadcast from rank 0,
    each split leaf cut to this process's part, and the modules that compute
    on one swapped for their sharded forms (parallel/sharded.py); with a
    'data' axis above 1, BatchNorm on the global batch. Call it before the
    optimizer is made: split leaves are new parameters. Raises where a rule
    splits a leaf that no sharded module computes on."""
    from dose_prediction_tpu_torch.parallel import sharded

    _broadcast_state(model)
    shards = param_shardings(model, mesh, rules)
    sharded.swap_modules(model, mesh, shards)
    return ShardPlan(mesh, shards, model)
