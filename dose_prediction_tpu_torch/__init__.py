"""PyTorch/CUDA port of dose_prediction_tpu for one NVIDIA H100.

Mirrors the JAX package's sub-packages (ops, nn, models, kernels, infer,
evaluation); the JAX package is the reference each module is held against.
Tensors are NCDHW inside; the cascade keeps the JAX package's NDHWC layout
at its boundary. Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU.
"""

from dose_prediction_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
