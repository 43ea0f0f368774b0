"""Models of the serve cascade (C3D BaseUNet as net_A, DOSE-PYFER, OAR-TranSeg)
and the C3D cascade that pretrains net_A."""

from dose_prediction_tpu_torch.models.c3d import BaseUNet, CascadeC3D
from dose_prediction_tpu_torch.models.dose_pyfer import DosePyfer
from dose_prediction_tpu_torch.models.transeg import TranSeg

__all__ = ["BaseUNet", "CascadeC3D", "DosePyfer", "TranSeg"]
