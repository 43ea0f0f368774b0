"""3D primitives on NCDHW tensors with the JAX package's semantics."""

from dose_prediction_tpu_torch.ops.act import gelu, get_act, leaky_relu, mish, relu
from dose_prediction_tpu_torch.ops.conv import conv3d, conv_transpose3d
from dose_prediction_tpu_torch.ops.norm import batch_norm, instance_norm, layer_norm
from dose_prediction_tpu_torch.ops.resize import downsample_pyramid, resize3d, upsample3d

__all__ = [
    "batch_norm",
    "conv3d",
    "conv_transpose3d",
    "downsample_pyramid",
    "gelu",
    "get_act",
    "instance_norm",
    "layer_norm",
    "leaky_relu",
    "mish",
    "relu",
    "resize3d",
    "upsample3d",
]
