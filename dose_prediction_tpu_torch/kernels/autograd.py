"""Gradients of the kernels: forward through the kernel, backward through the
plain version (counterpart of the JAX kernels' ``jax.custom_vjp``s, whose
backward is the XLA reference: attention.py:74-89, instance_norm.py:124-144,
conv3d.py:156-182). The JAX package has no backward kernel, so neither has
the port yet.
"""

from __future__ import annotations

from typing import Callable

import torch


def needs_grad(*tensors: torch.Tensor | None) -> bool:
    """True when autograd records and some input requires a gradient; the
    wrappers take the autograd route only then."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


class PlainBackward(torch.autograd.Function):
    """``apply(direct, plain, wrapper, kwargs, *inputs)``: the forward is
    ``direct(*inputs, **kwargs)`` (the kernel on a CUDA tensor, the plain
    version on a CPU one); the backward recomputes ``plain(*inputs,
    **kwargs)`` under autograd and returns its vector-Jacobian product,
    adding one to ``wrapper.recomputes``. Inputs may be None."""

    @staticmethod
    def forward(ctx, direct: Callable, plain: Callable, wrapper, kwargs: dict,
                *inputs: torch.Tensor | None) -> torch.Tensor:
        ctx.plain, ctx.wrapper, ctx.kwargs = plain, wrapper, kwargs
        ctx.save_for_backward(*inputs)
        return direct(*inputs, **kwargs)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        wanted = ctx.needs_input_grad[4:]
        leaves = [None if t is None else t.detach().requires_grad_(w)
                  for t, w in zip(ctx.saved_tensors, wanted)]
        with torch.enable_grad():
            out = ctx.plain(*leaves, **ctx.kwargs)
        ctx.wrapper.recomputes += 1
        needed = [t for t, w in zip(leaves, wanted) if t is not None and w]
        grads = iter(torch.autograd.grad(out, needed, grad) if needed else ())
        return (None, None, None, None,
                *(next(grads) if t is not None and w else None for t, w in zip(leaves, wanted)))
