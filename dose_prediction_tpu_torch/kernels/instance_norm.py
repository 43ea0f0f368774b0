"""K2: InstanceNorm3d + affine + activation on NCDHW tensors (counterpart of
dose_prediction_tpu/kernels/instance_norm.py::instance_norm_act).

The kernel (csrc/instance_norm.cu) replaces the Pallas kernel
dose_prediction_tpu/kernels/instance_norm.py:32 (``_kernel``, launched by
``pl.pallas_call`` at :83). On the H100 memory bandwidth bounds it (about 2
operations per element); its design, each (n, c) plane cut into chunks with
per-chunk partial moments merged before a normalize pass, is described in
the source. ``plain_instance_norm_act`` is the same function in PyTorch:
``ops.instance_norm`` (two-pass float32 statistics) followed by the
activation, which is the JAX kernel's own reference; the backward
recomputes it (kernels/autograd.py), as the JAX custom VJP (:124-144) does.
"""

from __future__ import annotations

import torch

from dose_prediction_tpu_torch.kernels import cuda_lib
from dose_prediction_tpu_torch.kernels.autograd import PlainBackward, needs_grad
from dose_prediction_tpu_torch.ops import get_act, instance_norm

ACT_CODES = {"identity": 0, "none": 0, "relu": 1, "leakyrelu": 2, "mish": 3, "gelu": 4}
CHUNK = 8192  # elements of one plane per block


def plain_instance_norm_act(x: torch.Tensor, scale: torch.Tensor | None = None,
                            bias: torch.Tensor | None = None, *, act: str = "identity",
                            eps: float = 1e-5) -> torch.Tensor:
    return get_act(act)(instance_norm(x, scale, bias, eps=eps))


def instance_norm_act(x: torch.Tensor, scale: torch.Tensor | None = None,
                      bias: torch.Tensor | None = None, *, act: str = "identity",
                      eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm3d over each (n, c) of ``(N, C, D, H, W)``, then
    ``* scale + bias`` (each optional, ``(C,)``) and ``act``: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. Differentiable (the
    backward recomputes the plain version)."""
    if needs_grad(x, scale, bias):
        return PlainBackward.apply(_direct, plain_instance_norm_act, instance_norm_act,
                                   {"act": act, "eps": eps}, x, scale, bias)
    return _direct(x, scale, bias, act=act, eps=eps)


def _direct(x: torch.Tensor, scale: torch.Tensor | None, bias: torch.Tensor | None, *,
            act: str, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return plain_instance_norm_act(x, scale, bias, act=act, eps=eps)
    cuda_lib.require_cuda(x, "instance_norm_act")
    if act.lower() not in ACT_CODES:
        raise ValueError(f"instance_norm_act: activation {act!r} not in {sorted(ACT_CODES)}")
    if x.ndim != 5:
        raise ValueError(f"instance_norm_act: expected (N, C, D, H, W), got {tuple(x.shape)}")
    n, c = x.shape[:2]
    s = x[0, 0].numel()
    if n * c > 65535 or s >= 2 ** 31:
        raise ValueError(f"instance_norm_act: shape {tuple(x.shape)} too large")
    params = []
    for name, p in (("scale", scale), ("bias", bias)):
        if p is not None:
            if p.numel() != c or p.device != x.device:
                raise ValueError(f"instance_norm_act: {name} must be ({c},) on {x.device}")
            p = p.float().contiguous()
        params.append(p)
    x = x.contiguous()
    out = torch.empty_like(x)
    nchunks = -(-s // CHUNK)
    partials = torch.empty(n * c * nchunks * 2, dtype=torch.float32, device=x.device)
    status = cuda_lib.library().dpt_instance_norm_fwd(
        x.data_ptr(), out.data_ptr(), partials.data_ptr(),
        *(None if p is None else p.data_ptr() for p in params),
        n * c, c, s, CHUNK, eps, ACT_CODES[act.lower()], cuda_lib.DTYPE_CODES[x.dtype],
        cuda_lib.stream_of(x))
    cuda_lib.check(status, "instance_norm_act")
    instance_norm_act.launches += 1
    return out


instance_norm_act.launches = 0
instance_norm_act.recomputes = 0
