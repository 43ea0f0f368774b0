"""3D convolutions on NCDHW tensors (counterpart of the conv3d /
conv_transpose3d semantics of dose_prediction_tpu/ops/conv.py).

Both go to cuDNN through torch: the JAX package leaves these convolutions to
XLA, and its TPU-only rewrites (decomposed, lanefold, depth-phase, matmul)
have no counterpart here. Weights use torch layouts: (O, I, kD, kH, kW) for
conv3d and (I, O, kD, kH, kW) for conv_transpose3d. The weight and bias are
cast to the input's dtype, as the JAX layers cast their float32 params to
the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _cast(t: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype)


def conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride=1, padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """Conv3d with symmetric zero padding (PyTorch semantics)."""
    return F.conv3d(x, w.to(x.dtype), _cast(b, x.dtype), stride=stride,
                    padding=padding, dilation=dilation, groups=groups)


def conv_transpose3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                     stride=1, padding=0, output_padding=0) -> torch.Tensor:
    """ConvTranspose3d; ``w`` is (Cin, Cout, kD, kH, kW)."""
    return F.conv_transpose3d(x, w.to(x.dtype), _cast(b, x.dtype), stride=stride,
                              padding=padding, output_padding=output_padding)
