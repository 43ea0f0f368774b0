"""3D primitives on NCDHW tensors with the JAX package's semantics."""

from dose_prediction_tpu_torch.ops.act import gelu, get_act, leaky_relu, mish, prelu, relu
from dose_prediction_tpu_torch.ops.conv import avg_pool3d, conv3d, conv_transpose3d, max_pool3d
from dose_prediction_tpu_torch.ops.norm import batch_norm, group_norm, instance_norm, layer_norm
from dose_prediction_tpu_torch.ops.resize import downsample_pyramid, resize3d, upsample3d

__all__ = [
    "avg_pool3d",
    "batch_norm",
    "conv3d",
    "conv_transpose3d",
    "downsample_pyramid",
    "gelu",
    "group_norm",
    "get_act",
    "instance_norm",
    "layer_norm",
    "leaky_relu",
    "max_pool3d",
    "mish",
    "prelu",
    "relu",
    "resize3d",
    "upsample3d",
]
