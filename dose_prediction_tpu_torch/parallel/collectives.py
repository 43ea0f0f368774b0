"""The collectives that stand where GSPMD inserts its own in the JAX package
(parallel/mesh.py there lets XLA place them).

Everything here is built on ``all_reduce`` (sum) and ``broadcast`` alone:
gloo supports only those two on CUDA tensors, and two ranks that share one
card run on gloo (NCCL refuses two ranks on one device). A gather is an
all-reduce into a zeroed buffer in which each rank writes its slot, which is
exact, since x + 0 = x. One code path so serves NCCL, gloo on CUDA and gloo
on the CPU.

A ``group`` of None stands for an axis of size 1: every function is then the
identity, and launches nothing.

- ``copy_to_model`` and ``reduce_from_model``, the Megatron pair: identity
  forward with an all-reduce backward (the input of a column-parallel
  layer), and all-reduce forward with an identity backward (the output of a
  row-parallel one). The layers after them run alike on every rank of the
  axis, so their gradient is the same on each.
- ``gather_channels``: a tensor-parallel conv's output channels made whole
  on every rank; the backward keeps this rank's slot of the gradient.
- ``data_sum``: a sum over the ``data`` axis whose backward is a sum too,
  for statistics of the global batch (BatchNorm): each data rank's loss is
  its share of the global loss, so the gradient of a value that every rank
  reads is the sum of theirs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed import ProcessGroup


def all_reduce_(t: torch.Tensor, group: Optional[ProcessGroup]) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (no autograd); ``t`` is returned."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def index(group: Optional[ProcessGroup]) -> int:
    """This process's position in ``group`` (0 for an axis of size 1)."""
    return 0 if group is None else dist.get_rank(group)


def gather(local: torch.Tensor, dim: int, group: Optional[ProcessGroup]) -> torch.Tensor:
    """The whole tensor from each rank's equal contiguous part of ``dim``, in
    rank order (no autograd)."""
    if group is None:
        return local
    n = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = n * group.size()
    full = local.new_zeros(shape)
    full.narrow(dim, index(group) * n, n).copy_(local)
    return all_reduce_(full, group)


def barrier(device: torch.device) -> None:
    """Wait for every rank of the default group: a one-element all-reduce on
    ``device``, read on the host."""
    t = torch.zeros(1, device=device)
    dist.all_reduce(t)
    t.item()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _DataSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n, ctx.index = dim, x.shape[dim], index(group)
        return gather(x.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n).contiguous(), None, None


def copy_to_model(x: torch.Tensor, group: Optional[ProcessGroup]) -> torch.Tensor:
    """Identity forward, all-reduce backward (Megatron's f)."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Optional[ProcessGroup]) -> torch.Tensor:
    """All-reduce forward, identity backward (Megatron's g)."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def data_sum(x: torch.Tensor, group: Optional[ProcessGroup]) -> torch.Tensor:
    """All-reduce forward and backward (module docstring)."""
    return x if group is None else _DataSum.apply(x, group)


def gather_channels(x: torch.Tensor, group: Optional[ProcessGroup], dim: int = 1
                    ) -> torch.Tensor:
    """Each rank's channels of ``x`` gathered whole along ``dim``; the
    backward keeps this rank's slot."""
    return x if group is None else _GatherChannels.apply(x, dim, group)
