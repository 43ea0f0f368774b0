"""Models of the serve cascade: C3D BaseUNet (net_A), DOSE-PYFER, OAR-TranSeg."""

from dose_prediction_tpu_torch.models.c3d import BaseUNet
from dose_prediction_tpu_torch.models.dose_pyfer import DosePyfer
from dose_prediction_tpu_torch.models.transeg import TranSeg

__all__ = ["BaseUNet", "DosePyfer", "TranSeg"]
