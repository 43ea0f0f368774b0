"""Models of the serve cascade (C3D BaseUNet as net_A, DOSE-PYFER, OAR-TranSeg),
the C3D cascade that pretrains net_A, and the baselines: the plain UNETR
(seg) and HD-UNet (dose)."""

from dose_prediction_tpu_torch.models.c3d import BaseUNet, CascadeC3D
from dose_prediction_tpu_torch.models.dose_pyfer import DosePyfer
from dose_prediction_tpu_torch.models.hdunet import HDUNet
from dose_prediction_tpu_torch.models.transeg import TranSeg
from dose_prediction_tpu_torch.models.unetr import UNETR

__all__ = ["BaseUNet", "CascadeC3D", "DosePyfer", "HDUNet", "TranSeg", "UNETR"]
