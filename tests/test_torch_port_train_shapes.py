"""The kernel shapes of the new train paths, counted on the CPU with meta
tensors, against the lists chip_smoke.py holds each kernel at on the card.

The full-width TranSeg on one 96³ crop and the full-width C3D cascade on a
128³ volume, and the zoo phase's train steps (UNETR and the 'old' TranSeg
on one 96³ crop, HD-UNet at 128³), bfloat16, run forward on the meta
device in training mode with the K3 routing on (no data, no arithmetic);
each kernel wrapper is replaced by its plain version and records its input
shapes. A backward launches no kernel (it recomputes the plain versions),
so these are the step's launches. Every shape must be in chip_smoke.py's
K1_SHAPES, K2_SHAPES or K3_SHAPES (K2 also in K2_F32_SHAPES for the zoo
models, whose float32 parity runs at these shapes), and the counts are
those PERF.md states.
"""

import collections
import sys
from pathlib import Path
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from dose_prediction_tpu_torch.core.config import FLAGS  # noqa: E402
from dose_prediction_tpu_torch.kernels import attention as k1  # noqa: E402
from dose_prediction_tpu_torch.kernels import conv3d as k3  # noqa: E402
from dose_prediction_tpu_torch.kernels import instance_norm as k2  # noqa: E402
from dose_prediction_tpu_torch.models import UNETR, CascadeC3D, HDUNet, TranSeg  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def kernel_shapes(model, shape):
    seen = collections.Counter()

    def record(name, plain):
        def fn(x, *args, **kwargs):
            seen[(name, tuple(x.shape))] += 1
            return plain(x, *args, **kwargs)
        return fn

    x = torch.empty(shape, device="meta", dtype=torch.bfloat16)
    with mock.patch.object(k1, "fused_attention", record("K1", k1.plain_attention)), \
            mock.patch.object(k2, "instance_norm_act", record("K2", k2.plain_instance_norm_act)), \
            mock.patch.object(k3, "conv3d_k3", record("K3", k3.plain_conv3d_k3)), \
            mock.patch.object(FLAGS, "use_k3_conv3d", "1"):
        model.train()
        model(x)
    return seen


@pytest.mark.parametrize("name,make,shape,calls", [
    ("transeg", lambda: TranSeg(out_ch=8, device="meta"), (1, 1, 96, 96, 96),
     {"K1": 12, "K2": 29, "K3": 10}),
    ("c3d", lambda: CascadeC3D(device="meta"), (1, 9, 128, 128, 128),
     {"K1": 0, "K2": 42, "K3": 6}),
    ("unetr", lambda: UNETR(out_ch=8, device="meta"), (1, 1, 96, 96, 96),
     {"K1": 12, "K2": 21, "K3": 10}),
    ("transeg-old", lambda: TranSeg(out_ch=8, block_family="old", device="meta"),
     (1, 1, 96, 96, 96), {"K1": 12, "K2": 9, "K3": 10}),
    ("hdunet", lambda: HDUNet(device="meta"), (1, 9, 128, 128, 128),
     {"K1": 0, "K2": 28, "K3": 3})])
def test_train_step_kernel_shapes_are_held_by_chip_smoke(name, make, shape, calls):
    seen = kernel_shapes(make(), shape)
    lists = {"K1": chip_smoke.K1_SHAPES, "K2": chip_smoke.K2_SHAPES, "K3": chip_smoke.K3_SHAPES}
    if name in ("unetr", "transeg-old", "hdunet"):
        lists["K2"] = [s for s in lists["K2"] if s in chip_smoke.K2_F32_SHAPES]
    unheld = sorted(key for key in seen if key[1] not in lists[key[0]])
    assert not unheld, f"{name}: shapes chip_smoke.py does not hold: {unheld}"
    totals = {k: sum(n for (kern, _), n in seen.items() if kern == k) for k in calls}
    assert totals == calls
    # appended, never reordered: the kernels line reads these three
    assert (chip_smoke.K1_SHAPES[0], chip_smoke.K2_SHAPES[0], chip_smoke.K3_SHAPES[3]) == (
        (8, 12, 216, 64), (8, 16, 96, 96, 96), (8, 16, 96, 96, 96))
