"""Run-time flags (counterpart of dose_prediction_tpu/core/config.py; only
the flags the port reads). Each is read from the JAX package's variable with
its default, once at import; the models read ``FLAGS`` at each call."""

from __future__ import annotations

import dataclasses
import os

K3_ON = ("1", "tight")


@dataclasses.dataclass
class Flags:
    # Route the ViT's attention through kernel K1 (kernels/attention.py):
    # the counterpart of the JAX package's use_pallas_attention. '0' takes
    # K1's plain version (kernels/attention.py::plain_attention), the
    # counterpart of the einsum route the JAX package takes off the TPU.
    use_k1_attention: bool = os.environ.get("DPT_PALLAS_ATTENTION", "1") == "1"
    # Route InstanceNorm through kernel K2 (kernels/instance_norm.py): the
    # counterpart of the JAX package's use_pallas_instance_norm. '0' takes
    # ops.instance_norm. The JAX policy for 'auto' keys on the TPU's 128
    # lanes (K2 only at C >= 128 on a volume of 2^18 voxels or more). On the
    # H100 K2 wins at the narrowest width the models run: at (8, 16, 96³)
    # in bfloat16 it takes 0.1807 ms from a CUDA graph against
    # F.instance_norm's 1.4912 ms (chip_smoke.py, NVIDIA H100 80GB HBM3,
    # 700 W; PERF.md §6). So 'auto', like '1', means K2 at every width.
    use_k2_instance_norm: str = os.environ.get("DPT_PALLAS_IN", "auto")
    # Route same-size k3 convs (C == C_out ∈ {16, 32, 64}, stride 1,
    # dilation 1, padding 1) through kernel K3 (kernels/conv3d.py): the
    # counterpart of the JAX package's use_pallas_conv3d, read from the same
    # variable with the same default, '0' (off). '1' and 'tight' both turn it
    # on: the TPU kernel's band width has no counterpart on Hopper.
    use_k3_conv3d: str = os.environ.get("DPT_PALLAS_CONV", "0")

    def k2_instance_norm(self) -> bool:
        """Whether InstanceNorm takes K2 ('auto' and '1': yes; '0': no)."""
        return self.use_k2_instance_norm != "0"


FLAGS = Flags()
