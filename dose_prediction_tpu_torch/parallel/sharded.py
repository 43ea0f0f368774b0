"""The sharded forms of the modules that compute on a split leaf
(parallel/mesh.py::shard_params puts them in place).

Each is the module itself, recast: the same parameters and buffers under the
same names and in the same order (so that a state dict and the optimizer's
leaf order are the single-device ones), with its split leaves cut to this
rank's part and a forward that runs the collectives GSPMD would insert.

- ``TPSelfAttention`` (nn/vit.py::SABlock): ``qkv`` holds this rank's heads'
  q, k and v rows; kernel K1 runs on those heads; ``out_proj`` holds their
  input columns, its partial sums are all-reduced in float32, then the
  replicated bias is added, once.
- ``TPMLP`` (nn/vit.py::MLPBlock): ``linear1`` column-split (weight rows and
  bias), ``linear2`` row-split as ``out_proj``.
- ``TPConv3d`` / ``TPConvTranspose3d``: this rank's output channels, then
  gathered whole before anything follows (the norm after skip4's and
  decoder4's convs then runs, through K2, on whole tensors, alike on each
  rank); the replicated bias is added after the gather, as ops/conv.py adds
  it.
- ``DataBatchNorm3d``: in training, the mean and variance of the global
  batch (the sums all-reduced over 'data'), as GSPMD computes BatchNorm over
  a batch-sharded array.

A module with no split leaf keeps its own forward, so a mesh whose axes have
size 1 runs today's model, op for op.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from dose_prediction_tpu_torch import ops
from dose_prediction_tpu_torch.core.config import FLAGS
from dose_prediction_tpu_torch.kernels import attention as k1
from dose_prediction_tpu_torch.nn import remat
from dose_prediction_tpu_torch.nn.layers import BatchNorm3d, Conv3d, ConvTranspose3d, _LinearF32Sum
from dose_prediction_tpu_torch.nn.vit import MLPBlock, SABlock
from dose_prediction_tpu_torch.ops.conv import add_bias
from dose_prediction_tpu_torch.ops.norm import _affine
from dose_prediction_tpu_torch.parallel import collectives as C


def _recast(module: nn.Module, cls: type, **attrs) -> nn.Module:
    """``module`` as an instance of its subclass ``cls``, sharing its
    parameters, buffers and submodules (their dicts, so their order too)."""
    new = cls.__new__(cls)
    new.__dict__.update(module.__dict__)
    new.__dict__.update(attrs)
    return new


def _cut(module: nn.Module, leaf: str, shard, index: int) -> None:
    """Replace ``module.<leaf>`` by this rank's part, as a new parameter in the
    same slot."""
    p = getattr(module, leaf)
    setattr(module, leaf, nn.Parameter(shard.take(p.detach(), index),
                                       requires_grad=p.requires_grad))


def row_parallel(linear: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """``linear`` with its input features split over ``group``: the partial
    products with a float32 result, summed over the group, then the
    replicated bias, rounded once to ``x``'s dtype (as nn/layers.py::Linear
    rounds a low-precision product)."""
    w = linear.weight.to(x.dtype)
    if x.dtype == torch.float32:
        partial = nn.functional.linear(x, w)
    else:
        partial = _LinearF32Sum.apply(x, w, w.new_zeros(w.shape[0], dtype=torch.float32))
    y = C.reduce_from_model(partial, group)
    if linear.bias is not None:
        y = y + linear.bias.float()
    return y.to(x.dtype)


class TPSelfAttention(SABlock):
    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = C.copy_to_model(x, self.group)
        n, l, _ = x.shape
        qkv = self.qkv(x).reshape(n, l, 3, self.heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)      # each (N, local heads, L, Dh)
        out = (k1.fused_attention if FLAGS.use_k1_attention else k1.plain_attention)(q, k, v)
        return row_parallel(self.out_proj, out.transpose(1, 2).reshape(n, l, -1), self.group)


class TPMLP(MLPBlock):
    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = ops.gelu(self.linear1(C.copy_to_model(x, self.group)))
        return row_parallel(self.linear2, h, self.group)


def _gathered(conv, x: torch.Tensor, y_local: torch.Tensor) -> torch.Tensor:
    y = C.gather_channels(y_local, conv.group)
    if conv.bias is None:
        return y
    if y.dtype == torch.float32:
        return y + conv.bias.view(1, -1, 1, 1, 1)
    return add_bias(y, conv.bias.float())


class TPConv3d(Conv3d):
    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = C.copy_to_model(x, self.group)
        return _gathered(self, x, ops.conv3d(x, self.weight, None, stride=self.stride,
                                             padding=self.padding, dilation=self.dilation,
                                             groups=self.groups))


class TPConvTranspose3d(ConvTranspose3d):
    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = C.copy_to_model(x, self.group)
        return _gathered(self, x, ops.conv_transpose3d(
            x, self.weight, None, stride=self.stride, padding=self.padding,
            output_padding=self.output_padding))


class DataBatchNorm3d(BatchNorm3d):
    """BatchNorm3d over the global batch of a 'data' axis (module
    docstring); every data rank holds an equal share of the rows."""

    group = None
    parts = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.float()
        dims, shape = (0, 2, 3, 4), (1, -1, 1, 1, 1)
        n = x.numel() // x.shape[1] * self.parts
        mean = C.data_sum(xf.sum(dim=dims), self.group) / n
        var = C.data_sum((xf - mean.reshape(shape)).square().sum(dim=dims), self.group) / n
        if remat.updates_batch_stats():
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * (var * (n / max(n - 1, 1))))
                self.num_batches_tracked.add_(1)
        y = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self.eps)
        return _affine(y, self.weight, self.bias).to(x.dtype)


def _replace(model: nn.Module, name: str, new: nn.Module) -> None:
    parent, _, child = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, child, new)


def swap_modules(model: nn.Module, mesh, shards: Dict[str, "object"]) -> None:
    """Cut ``model``'s split leaves (``shards``, by parameter name) to this
    rank's parts and recast the modules that compute on them; with a 'data'
    axis above 1, recast every BatchNorm3d as DataBatchNorm3d. Raises where
    a split leaf has no sharded form to compute on it."""
    done = set()
    for name, module in list(model.named_modules()):
        prefix = f"{name}." if name else ""
        own = {k[len(prefix):]: s for k, s in shards.items()
               if k.startswith(prefix) and "." in k[len(prefix):]
               and k[len(prefix):].count(".") == 1}
        if isinstance(module, SABlock) and own:
            want = {"qkv.weight", "out_proj.weight"}
            if set(own) != want:
                raise ValueError(f"{name}: attention splits {sorted(own)}, need {sorted(want)}")
            shard = own["qkv.weight"]
            index, group = mesh.index(shard.axis), mesh.group(shard.axis)
            _cut(module.qkv, "weight", shard, index)
            _cut(module.out_proj, "weight", own["out_proj.weight"], index)
            hidden = module.out_proj.out_features
            new = _recast(module, TPSelfAttention, group=group,
                          head_dim=hidden // module.heads, heads=module.heads // shard.size)
            _replace(model, name, new)
            done |= {prefix + k for k in own}
        elif isinstance(module, MLPBlock) and own:
            if not {"linear1.weight", "linear2.weight"} <= set(own) <= \
                    {"linear1.weight", "linear1.bias", "linear2.weight"}:
                raise ValueError(f"{name}: MLP splits {sorted(own)}, need linear1's rows "
                                 "and linear2's columns")
            group = mesh.group(own["linear1.weight"].axis)
            for k, shard in own.items():
                leaf_owner, leaf = k.split(".")
                _cut(getattr(module, leaf_owner), leaf, shard, mesh.index(shard.axis))
            _replace(model, name, _recast(module, TPMLP, group=group))
            done |= {prefix + k for k in own}
    for name, module in list(model.named_modules()):
        key = f"{name}.weight"
        if key in shards and key not in done and isinstance(module, (Conv3d, ConvTranspose3d)):
            shard = shards[key]
            out_dim = 1 if isinstance(module, ConvTranspose3d) else 0
            if shard.dim != out_dim:
                raise ValueError(f"{key}: a conv splits its output channels only")
            _cut(module, "weight", shard, mesh.index(shard.axis))
            cls = TPConvTranspose3d if isinstance(module, ConvTranspose3d) else TPConv3d
            _replace(model, name, _recast(module, cls, group=mesh.group(shard.axis),
                                          out_channels=module.out_channels // shard.size))
            done.add(key)
    left = sorted(set(shards) - done)
    if left:
        raise ValueError(f"no sharded module computes on {left[:5]}")
    if mesh.size("data") > 1:
        for name, module in list(model.named_modules()):
            if isinstance(module, BatchNorm3d) and not isinstance(module, DataBatchNorm3d):
                _replace(model, name, _recast(module, DataBatchNorm3d,
                                              group=mesh.group("data"),
                                              parts=mesh.size("data")))
