"""Dense-k7 → separable-k7 warm start (counterpart of
dose_prediction_tpu/nn/separable.py, on torch state dicts).

TranSeg(k7_mode='separable') replaces each k7 conv of the k7 branch with a
linear chain of three 1-D convs (nn/mdunet.py SeparableConv3d):

    y = w(h(d(x))) + bias

with ``d`` (k,1,1) carrying the channel mixing and ``h``/``w`` channel-
diagonal spatial profiles. A trained dense kernel K[d,h,w,ci,co] is
projected onto that family by a shared-profile HOSVD: b and c are the
leading left-singular vectors of K unfolded along h and along w; A is the
least-squares fit given them, A[d,ci,co] = Σ_{h,w} K[d,h,w,ci,co]·b[h]·c[w];
``h`` = b ⊗ I, ``w`` = c ⊗ I, and the dense bias goes to ``w``. Exact when K
is of the form A ⊗ b ⊗ c, an approximation otherwise: a warm start to
fine-tune. The relative residual ‖K − A⊗b⊗c‖ / ‖K‖ is returned per conv.
The arithmetic is the JAX module's, in float64 on the host, on the JAX
layout (kd, kh, kw, I, O); torch weights are (O, I, kd, kh, kw).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_CHAIN = re.compile(r"^(.*)\.([dhw])\.(weight|bias)$")


def project_dense_kernel(weight) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, float]:
    """``(d, h, w, rel_err)``: the chain's float32 torch weights, (co, ci, k,
    1, 1), (co, co, 1, k, 1) and (co, co, 1, 1, k), for a dense torch
    weight (co, ci, k, k, k)."""
    K = np.asarray(torch.as_tensor(weight).detach().cpu(), np.float64).transpose(2, 3, 4, 1, 0)
    k1, k2, k3, ci, co = K.shape
    b = np.linalg.svd(K.transpose(1, 0, 2, 3, 4).reshape(k2, -1), full_matrices=False)[0][:, 0]
    c = np.linalg.svd(K.transpose(2, 0, 1, 3, 4).reshape(k3, -1), full_matrices=False)[0][:, 0]
    # the dominant tap positive (the signs cancel through the chain)
    if b[np.argmax(np.abs(b))] < 0:
        b = -b
    if c[np.argmax(np.abs(c))] < 0:
        c = -c
    A = np.einsum("dhwio,h,w->dio", K, b, c)
    approx = np.einsum("dio,h,w->dhwio", A, b, c)
    denom = float(np.linalg.norm(K))
    rel_err = float(np.linalg.norm(K - approx)) / (denom if denom else 1.0)
    eye = np.eye(co)

    def torch_layout(jax_kernel):       # (kd, kh, kw, I, O) → (O, I, kd, kh, kw)
        return torch.from_numpy(np.ascontiguousarray(
            jax_kernel.transpose(4, 3, 0, 1, 2)).astype(np.float32))

    return (torch_layout(A[:, None, None]), torch_layout(b[None, :, None, None, None] * eye),
            torch_layout(c[None, None, :, None, None] * eye), rel_err)


def separabilize_state_dict(dense: Mapping[str, torch.Tensor],
                            separable_template: Mapping[str, torch.Tensor]
                            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, float]]:
    """A state dict for the separable model whose ``separable_template``
    (its own ``state_dict()``) is given, from the dense model's ``dense``.
    Every entry both share is copied; every ``<conv>.d/.h/.w`` chain is
    filled by projecting the dense ``<conv>.weight`` (its bias, or zeros, to
    ``.w.bias``). Returns (state dict, {dense conv module key: rel_err}).
    Raises KeyError where the dense state dict lacks a source."""
    out: Dict[str, torch.Tensor] = {}
    errors: Dict[str, float] = {}
    for key, ref in separable_template.items():
        m = _CHAIN.match(key)
        if m is None:
            if key not in dense:
                raise KeyError(f"{key}: missing in the dense source state dict")
            out[key] = dense[key].detach().clone()
            continue
        base = m[1]
        if f"{base}.weight" not in dense:
            raise KeyError(f"{key}: separable chain {base}.d/.h/.w has no dense source conv "
                           f"'{base}'")
        if base not in errors:
            d, h, w, errors[base] = project_dense_kernel(dense[f"{base}.weight"])
            bias = dense.get(f"{base}.bias")
            out.update({f"{base}.d.weight": d, f"{base}.h.weight": h, f"{base}.w.weight": w})
            if f"{base}.w.bias" in separable_template:
                out[f"{base}.w.bias"] = (bias.detach().float().clone() if bias is not None
                                         else torch.zeros(w.shape[0]))
    return {k: out[k].to(separable_template[k].device) for k in separable_template}, errors
