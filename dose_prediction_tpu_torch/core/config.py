"""Run-time flags (counterpart of dose_prediction_tpu/core/config.py; only
the flags the port reads)."""

from __future__ import annotations

import dataclasses
import os

K3_ON = ("1", "tight")


@dataclasses.dataclass
class Flags:
    # Route same-size k3 convs (C == C_out ∈ {16, 32, 64}, stride 1,
    # dilation 1, padding 1) through kernel K3 (kernels/conv3d.py): the
    # counterpart of the JAX package's use_pallas_conv3d, read from the same
    # variable with the same default, '0' (off). '1' and 'tight' both turn it
    # on: the TPU kernel's band width has no counterpart on Hopper.
    use_k3_conv3d: str = os.environ.get("DPT_PALLAS_CONV", "0")


FLAGS = Flags()
