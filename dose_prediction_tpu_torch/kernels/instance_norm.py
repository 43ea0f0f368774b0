"""K2: InstanceNorm3d + affine + activation on NCDHW tensors (counterpart of
dose_prediction_tpu/kernels/instance_norm.py::instance_norm_act).

The kernel (csrc/instance_norm.cu) replaces the Pallas kernel
dose_prediction_tpu/kernels/instance_norm.py:32 (``_kernel``, launched by
``pl.pallas_call`` at :83). On the H100 memory bandwidth bounds it (about 2
operations per element). Its single-read kernel cuts each (n, c) plane into
chunks, one per block, keeps each chunk in registers while the plane's
blocks exchange partial moments, and normalizes from registers: one read and
one write of the volume in one launch. It is safe only while the card holds
a plane's chunks resident at once, so ``plan`` sends a plane too large for
that, by shape and before any launch, to the two-kernel path (statistics,
then a second read to normalize); the source gives the design and the
argument. ``plain_instance_norm_act`` is the same function in PyTorch:
``ops.instance_norm`` (two-pass float32 statistics) and the activation in
float32, one rounding to the input dtype, as the Pallas kernel rounds; the
backward recomputes it (kernels/autograd.py), as the JAX custom VJP
(:124-144) does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dose_prediction_tpu_torch.kernels import cuda_lib
from dose_prediction_tpu_torch.kernels.autograd import PlainBackward, needs_grad
from dose_prediction_tpu_torch.ops import get_act, instance_norm

ACT_CODES = {"identity": 0, "none": 0, "relu": 1, "leakyrelu": 2, "mish": 3, "gelu": 4}
SINGLE_READ, TWO_KERNEL = "single_read", "two_kernel"


def plan(s: int, chunk: int, capacity: int) -> str:
    """The path for planes of ``s`` elements cut into chunks of ``chunk``,
    where ``capacity`` is how many blocks of the single-read kernel the card
    holds resident at once. That kernel needs a plane's chunks resident
    together; it is taken where a plane needs at most half of them, and a
    larger plane takes the two-kernel path."""
    return SINGLE_READ if -(-s // chunk) <= capacity // 2 else TWO_KERNEL


@functools.lru_cache(maxsize=None)
def capacity(device_index: int, dtype: torch.dtype, vector: bool) -> tuple[int, int]:
    """``(chunk, resident blocks)`` of the single-read kernel instantiated
    for ``dtype`` with 16-byte (``vector``) or scalar loads on the card: the
    elements of a plane one block holds, and the occupancy calculator's
    blocks per SM x the SM count."""
    chunk, blocks = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        cuda_lib.check(cuda_lib.library().dpt_instance_norm_capacity(
            cuda_lib.DTYPE_CODES[dtype], int(vector), ctypes.byref(chunk), ctypes.byref(blocks)),
            "instance_norm_act capacity")
    return chunk.value, blocks.value


def plain_instance_norm_act(x: torch.Tensor, scale: torch.Tensor | None = None,
                            bias: torch.Tensor | None = None, *, act: str = "identity",
                            eps: float = 1e-5) -> torch.Tensor:
    return get_act(act)(instance_norm(x.float(), scale, bias, eps=eps)).to(x.dtype)


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
    params = []
    for name, p in (("scale", scale), ("bias", bias)):
        if p is not None:
            if p.numel() != c or p.device != x.device:
                raise ValueError(f"instance_norm_act: {name} must be ({c},) on {x.device}")
            p = p.float().contiguous()
        params.append(p)
    x = x.contiguous()
    out = torch.empty_like(x)
    planes = n * c
    # 16-byte loads and stores need aligned data and planes of whole words
    vector = (s * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    chunk, resident = capacity(x.device.index, x.dtype, vector)
    path = plan(s, chunk, resident)
    nchunks = -(-s // chunk)
    if s >= 2 ** 31 or planes * nchunks >= 2 ** 31:
        raise ValueError(f"instance_norm_act: shape {tuple(x.shape)} too large")
    single = path == SINGLE_READ
    # float2 partial moments per chunk, then (single-read) the ticket and one
    # arrival counter per plane, which the C function zeroes
    work = torch.empty(2 * planes * nchunks + (1 + planes if single else 0),
                       dtype=torch.float32, device=x.device)
    counters = work.data_ptr() + 8 * planes * nchunks if single else None
    status = cuda_lib.library().dpt_instance_norm_fwd(
        x.data_ptr(), out.data_ptr(), work.data_ptr(), counters,
        *(None if p is None else p.data_ptr() for p in params),
        planes, c, s, chunk, eps, ACT_CODES[act.lower()], cuda_lib.DTYPE_CODES[x.dtype],
        int(vector), int(single), cuda_lib.stream_of(x))
    cuda_lib.check(status, "instance_norm_act")
    instance_norm_act.launches += 1
    if not single:
        instance_norm_act.two_kernel_launches += 1
    return out


instance_norm_act.launches = 0             # calls that launched, by either path
instance_norm_act.two_kernel_launches = 0  # of those, calls on the two-kernel path
instance_norm_act.recomputes = 0
