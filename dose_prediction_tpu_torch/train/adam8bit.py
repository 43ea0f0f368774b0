"""Block-wise 8-bit Adam (counterpart of dose_prediction_tpu/train/adam8bit.py,
the analogue of the reference's bitsandbytes Adam8bit,
train_light_pyfer.py:12,195).

Leaves of at least ``min_quantize_size`` elements keep their moments in
blocks of ``block_size``: the first moment as int8 with one float32 absmax
scale per block (``quantize``, adam8bit.py:49-57), the second, which is
non-negative, as uint8 codes of log(v + 1e-30) on a per-block log grid
(``quantize_log``, :66-82), whose bounds leave out the pad lanes of a
leaf's last block. Smaller leaves keep float32 moments. The update runs in
float32: dequantize, Adam(W), quantize again (:127-155).

The JAX package updates leaf by leaf and XLA fuses the loop; here every
quantized leaf lies, padded to whole blocks, in one flat buffer, so that
each step of the rule is one operation over all blocks. XLA fuses this;
it is no Pallas kernel, and this module is plain PyTorch.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from dose_prediction_tpu_torch.train.state import LearningRate, _Optimizer

# floor added before log(); in the normal float32 range (a subnormal could
# flush to zero and make log() return -inf), adam8bit.py:46
LOG_TINY = 1e-30


class Quantized(NamedTuple):
    """Signed linear block quantization (first moment)."""

    values: torch.Tensor   # int8, (n_blocks, block_size)
    scales: torch.Tensor   # float32, (n_blocks,)


class LogQuantized(NamedTuple):
    """Log-domain block quantization (second moment)."""

    values: torch.Tensor   # uint8, (n_blocks, block_size)
    lo: torch.Tensor       # float32, (n_blocks,) log-domain lower bound
    scale: torch.Tensor    # float32, (n_blocks,) log-domain step


def quantize(blocks: torch.Tensor) -> Quantized:
    """``blocks`` (n_blocks, block_size) float32 → int8 codes with
    ``absmax / 127`` scales (1 for an all-zero block); round half to even,
    clipped to ±127 before the cast."""
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return Quantized(q, scale[:, 0])


def dequantize(q: Quantized) -> torch.Tensor:
    return q.values.float() * q.scales[:, None]


def quantize_log(blocks: torch.Tensor, valid: torch.Tensor) -> LogQuantized:
    """``blocks`` (n_blocks, block_size) float32, ≥ 0, zero in pad lanes →
    uint8 codes of ``log(v + 1e-30)`` between each block's lowest and
    highest log over its ``valid`` lanes (the tail-block fix: a pad lane's
    log(1e-30) would stretch the grid over ~60 unused log units)."""
    z = torch.log(blocks.clamp_min(0.0) + LOG_TINY)
    inf = z.new_full((), float("inf"))        # made on the device: no copy from the host
    lo = torch.where(valid, z, inf).amin(dim=1, keepdim=True)
    hi = torch.where(valid, z, -inf).amax(dim=1, keepdim=True)
    scale = torch.clamp_min((hi - lo) / 255.0, 1e-12)
    q = torch.clamp(torch.round((z - lo) / scale), 0, 255).to(torch.uint8)
    return LogQuantized(q, lo[:, 0], scale[:, 0])


def dequantize_log(q: LogQuantized) -> torch.Tensor:
    z = q.values.float() * q.scale[:, None] + q.lo[:, None]
    return torch.clamp_min(torch.exp(z) - LOG_TINY, 0.0)


def _assign(dst, src) -> None:
    """Copy each tensor of ``src`` into the one of ``dst`` at its place."""
    for d, t in zip(dst, src):
        d.copy_(t)


class _Flat:
    """Views of a group of leaves in one flat float32 buffer, each leaf
    starting at a multiple of ``align`` elements."""

    def __init__(self, params: List[torch.Tensor], align: int):
        self.params = params
        self.offsets, n = [], 0
        for p in params:
            self.offsets.append(n)
            n += -(-p.numel() // align) * align
        self.numel = n
        self.buffers = {}

    def views(self, flat: torch.Tensor, idx=None) -> List[torch.Tensor]:
        idx = range(len(self.params)) if idx is None else idx
        return [flat[self.offsets[i]:self.offsets[i] + self.params[i].numel()]
                .view(self.params[i].shape) for i in idx]

    def gather(self, name: str, tensors: List[Optional[torch.Tensor]]) -> torch.Tensor:
        """The tensors in their slots of the buffer ``name``, zeros elsewhere
        (pad lanes and missing gradients)."""
        if name not in self.buffers:
            self.buffers[name] = self.params[0].new_zeros(self.numel, dtype=torch.float32)
        buf = self.buffers[name]
        buf.zero_()
        present = [i for i, t in enumerate(tensors) if t is not None]
        if present:
            torch._foreach_copy_(self.views(buf, present), [tensors[i] for i in present])
        return buf


class Adam8bit(_Optimizer):
    """Adam(W) with 8-bit block moments (adam8bit.py:85-155). Per update t:
    ``m ← b1·m + (1−b1)·g``; ``v ← b2·v + (1−b2)·g·g``;
    ``u = (m / (1−b1^t)) / (√(v / (1−b2^t)) + eps)`` (``1−b^t`` in
    float32 from a float32 t) ``+ wd·p``; ``p ← p − lr·u`` with the
    schedule at count t, as the JAX function calls it."""

    def __init__(self, params, *, lr: LearningRate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip_norm: Optional[float] = None, grad_accum: int = 1,
                 block_size: int = 2048, min_quantize_size: int = 4096):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay),
                         grad_clip_norm=grad_clip_norm, grad_accum=grad_accum)
        if len(self.param_groups) != 1:
            raise ValueError("Adam8bit takes one parameter group")
        self.block_size = block_size
        self.min_quantize_size = min_quantize_size
        self._layout = None
        self._wholes = {}        # a split leaf's whole value, by id (_whole)

    def _whole(self, params: List[torch.Tensor]) -> List[torch.Tensor]:
        """The leaves the rule runs over: on a mesh (``distribute``), each
        tensor-parallel leaf as a buffer of its whole shape kept for it, so
        that the blocks and their scales are the single-device ones; every
        other leaf as it is."""
        if self.plan is None or not self.plan.shards:
            return params
        out = []
        for p in params:
            shard = self.plan.shard_of(p)
            if shard is not None and id(p) not in self._wholes:
                self._wholes[id(p)] = p.new_zeros(shard.whole_shape(p.shape))
            out.append(p if shard is None else self._wholes[id(p)])
        return out

    def _init_layout(self, params: List[torch.Tensor]) -> None:
        """The flat buffers and the moments' initial state, the JAX init's
        quantization of zeros (adam8bit.py:109-119)."""
        bs = self.block_size
        quant = [i for i, p in enumerate(params) if p.numel() >= self.min_quantize_size]
        small = [i for i, p in enumerate(params) if p.numel() < self.min_quantize_size]
        lay = {"quant": quant, "small": small, "params": list(params)}
        if quant:
            flat = _Flat([params[i] for i in quant], bs)
            dev = params[0].device
            valid = torch.zeros(flat.numel, dtype=torch.bool, device=dev)
            for v in flat.views(valid):
                v.fill_(True)
            blocks = torch.zeros((flat.numel // bs, bs), device=dev)
            valid = valid.view(-1, bs)
            lay.update(qflat=flat, valid=valid, mu=quantize(blocks),
                       nu=quantize_log(blocks, valid))
        if small:
            flat = _Flat([params[i] for i in small], 1)
            zeros = params[0].new_zeros(flat.numel, dtype=torch.float32)
            lay.update(sflat=flat, mu_s=zeros, nu_s=zeros.clone())
        self._layout = lay

    def _scalars(self, group):
        t = torch.tensor(float(self.count), dtype=torch.float32)
        b1t, b2t = (float(1.0 - torch.tensor(b, dtype=torch.float32) ** t)
                    for b in (group["b1"], group["b2"]))
        return self.lr_at(group, self.count), b1t, b2t

    def _init_state(self, group, params):
        if self._layout is None:
            self._init_layout(self._whole(params))

    def _update(self, group, params, grads, scalars):
        local, params = params, self._whole(params)
        split = [i for i, (p, w) in enumerate(zip(local, params)) if p is not w]
        if split:
            # the update over whole leaves on every rank of their axis; each
            # then keeps its part
            mesh = self.plan.mesh
            grads = list(grads)
            for i in split:
                shard = self.plan.shard_of(local[i])
                params[i].copy_(shard.gather(local[i], mesh))
                if grads[i] is not None:
                    grads[i] = shard.gather(grads[i], mesh)
        self._update_whole(group, params, grads, scalars)
        for i in split:
            shard = self.plan.shard_of(local[i])
            local[i].copy_(shard.take(params[i], mesh.index(shard.axis)))

    def _update_whole(self, group, params, grads, scalars):
        lay = self._layout
        if [id(p) for p in params] != [id(p) for p in lay["params"]]:
            raise ValueError("Adam8bit: the trainable parameters changed after the first step")
        b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
        neg_lr, b1t, b2t = scalars

        def adam(m, v, g, flat, idx):
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            step = (m / b1t) / (torch.sqrt(v / b2t) + eps)
            if wd:
                step = step + wd * flat.gather("p", [params[i] for i in idx]).view(step.shape)
            torch._foreach_add_([params[i] for i in idx], flat.views((neg_lr * step).view(-1)))
            return m, v

        # the moments are written in place: a CUDA graph of the step reads
        # and writes them where they were when it was captured
        if lay["quant"]:
            idx, flat = lay["quant"], lay["qflat"]
            g = flat.gather("g", [grads[i] for i in idx]).view(lay["valid"].shape)
            m, v = adam(dequantize(lay["mu"]), dequantize_log(lay["nu"]), g, flat, idx)
            _assign(lay["mu"], quantize(m))
            _assign(lay["nu"], quantize_log(torch.where(lay["valid"], v, torch.zeros_like(v)),
                                            lay["valid"]))
        if lay["small"]:
            idx, flat = lay["small"], lay["sflat"]
            g = flat.gather("g", [grads[i] for i in idx])
            m, v = adam(lay["mu_s"], lay["nu_s"], g, flat, idx)
            _assign((lay["mu_s"], lay["nu_s"]), (m, v))

    def state_tensors(self) -> List[torch.Tensor]:
        """The base class's and the layout's moments (its scratch buffers are
        made with it and replaced with it)."""
        lay = self._layout
        if lay is None:
            return super().state_tensors()
        moments = [t for k in ("mu", "nu") if k in lay for t in lay[k]]
        return super().state_tensors() + moments + [lay[k] for k in ("mu_s", "nu_s") if k in lay]

    def state_dict(self) -> dict:
        """The base state dict with the 8-bit moments: the int8 and uint8
        codes and their float32 scales as they are (a restore is bit for
        bit); None before the first update."""
        sd = super().state_dict()
        lay = self._layout
        sd["moments"] = None if lay is None else {
            "quant": list(lay["quant"]), "small": list(lay["small"]),
            **{k: lay[k]._asdict() for k in ("mu", "nu") if k in lay},
            **{k: {"values": lay[k]} for k in ("mu_s", "nu_s") if k in lay}}
        return sd

    def _moment_shapes(self) -> dict:
        """(shape, dtype) of each moment tensor the first update makes for
        the trainable leaves, by name and field."""
        params, bs = self._whole(self._groups()[0][1]), self.block_size
        quant = [i for i, p in enumerate(params) if p.numel() >= self.min_quantize_size]
        small = [i for i, p in enumerate(params) if p.numel() < self.min_quantize_size]
        out = {"quant": quant, "small": small}
        if quant:
            n = sum(-(-params[i].numel() // bs) for i in quant)
            f32 = ((n,), torch.float32)
            out["mu"] = {"values": ((n, bs), torch.int8), "scales": f32}
            out["nu"] = {"values": ((n, bs), torch.uint8), "lo": f32, "scale": f32}
        if small:
            n = sum(params[i].numel() for i in small)
            out["mu_s"] = out["nu_s"] = {"values": ((n,), torch.float32)}
        return out

    def check_state_dict(self, state_dict: dict) -> None:
        super().check_state_dict(state_dict)
        saved = state_dict.get("moments")
        if saved is None:
            return
        want = self._moment_shapes()
        for k, fields in want.items():
            if k in ("quant", "small"):
                if saved.get(k) != fields:
                    raise ValueError(f"adam8bit state: {k} leaves {saved.get(k)}, want {fields}")
                continue
            for f, (shape, dtype) in fields.items():
                v = saved.get(k, {}).get(f)
                if v is None or tuple(v.shape) != shape or v.dtype != dtype:
                    got = None if v is None else (tuple(v.shape), v.dtype)
                    raise ValueError(f"adam8bit state {k}.{f}: {got}, want {(shape, dtype)}")

    def load_state_dict(self, state_dict: dict) -> None:
        super().load_state_dict(state_dict)
        saved = state_dict.get("moments")
        self._layout = None
        if saved is None:
            return
        params = self._whole(self._groups()[0][1])
        self._init_layout(params)
        lay, dev = self._layout, params[0].device
        for k, cls in (("mu", Quantized), ("nu", LogQuantized)):
            if k in lay:
                lay[k] = cls(**{f: v.to(dev) for f, v in saved[k].items()})
        for k in ("mu_s", "nu_s"):
            if k in lay:
                lay[k] = saved[k]["values"].to(dev)

    def moments(self, p: torch.Tensor):
        """The moments of trainable leaf ``p``: (Quantized, LogQuantized) of
        its blocks, or (m, v) in float32; None before the first update."""
        lay = self._layout
        if lay is None:
            return None
        p = self._wholes.get(id(p), p)
        i = next(i for i, q in enumerate(lay["params"]) if q is p)
        if i in lay["quant"]:
            j = lay["quant"].index(i)
            flat, bs = lay["qflat"], self.block_size
            rows = slice(flat.offsets[j] // bs, (flat.offsets[j] + p.numel() + bs - 1) // bs)
            return (Quantized(lay["mu"].values[rows], lay["mu"].scales[rows]),
                    LogQuantized(lay["nu"].values[rows], lay["nu"].lo[rows],
                                 lay["nu"].scale[rows]))
        j = lay["small"].index(i)
        return tuple(lay["sflat"].views(lay[k], [j])[0] for k in ("mu_s", "nu_s"))


def state_nbytes(optimizer: Adam8bit) -> int:
    """Bytes of the optimizer's moment state (adam8bit.py:158-163)."""
    lay = optimizer._layout
    if lay is None:
        return 0
    tensors = []
    if lay["quant"]:
        tensors += [*lay["mu"], *lay["nu"]]
    if lay["small"]:
        tensors += [lay["mu_s"], lay["nu_s"]]
    return sum(t.numel() * t.element_size() for t in tensors)
