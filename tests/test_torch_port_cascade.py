"""The PyTorch port's serve cascade (infer/cascade.py) against the JAX
package's make_cascade_stages, on the CPU at a reduced size: a 48³ volume
with 32³ windows (overlap 0.25, so windows overlap and the last one is
clamped to the edge), reduced TranSeg and DOSE-PYFER
(test_torch_port_models.py), float32.

Stage 1: the PTV and CT channels are carried exactly, and the one-hot OAR
channels are identical at every voxel where the reference's top-two logits
differ by more than twice the 1e-3 logit tolerance. Closer to a tie, the
1e-4-level float difference between the two frameworks may decide the
label either way; such voxels must stay under 1 in 10,000.
Stage 2: given the same structures, the dose agrees to 1e-3 of the 70 Gy
scale.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu.core import torch_import as TI  # noqa: E402
from dose_prediction_tpu.infer.cascade import make_cascade_stages as jax_stages  # noqa: E402
from dose_prediction_tpu.infer.sliding_window import sliding_window_inference  # noqa: E402

from dose_prediction_tpu_torch.infer.cascade import make_cascade_stages  # noqa: E402

import test_torch_port_models as M  # noqa: E402  (seeded reduced models, JAX import)

VOL, ROI, SW, SCALE = 48, (32, 32, 32), 4, 70.0
TOL = 1e-3
REPO = Path(__file__).resolve().parent.parent


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ct = rng.standard_normal((1, VOL, VOL, VOL, 1)).astype(np.float32)
    ptv = (rng.random((1, VOL, VOL, VOL, 1)) < 0.1).astype(np.float32)
    mask = (rng.random((1, VOL, VOL, VOL, 1)) < 0.6).astype(np.float32)
    return ct, ptv, mask


@pytest.fixture(scope="module")
def cascade():
    seg, dose = M.port_seg(seed=0), M.port_dose(img=VOL, seed=1)
    seg_vars, _ = M.to_jax(seg, M.jax_seg(), TI.import_transeg, (1, *ROI, 1))
    dose_vars, _ = M.to_jax(dose, M.jax_dose(), TI.import_pyfer, (1, VOL, VOL, VOL, 9))
    j1, j2 = jax_stages(M.jax_seg(), M.jax_dose(), roi_size=ROI, sw_batch_size=SW,
                        dose_scale=SCALE)
    p1, p2 = make_cascade_stages(seg, dose, roi_size=ROI, sw_batch_size=SW, dose_scale=SCALE)
    ct, ptv, mask = _inputs()
    jax_struct = np.asarray(jax.jit(j1)(seg_vars, ct, ptv))
    port_struct = p1(seg.state_dict(), *(torch.from_numpy(a) for a in (ct, ptv))).numpy()

    def jax_logits(windows):
        return M.jax_seg().apply(seg_vars, windows, train=False, mutable=["batch_stats"])[0]

    logits = np.asarray(jax.jit(lambda v: sliding_window_inference(
        v, jax_logits, roi_size=ROI, sw_batch_size=SW, out_channels=8))(ct))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return dict(jax_struct=jax_struct, port_struct=port_struct, margin=top2[..., 1] - top2[..., 0],
                j2=jax.jit(j2), p2=p2, dose=dose, dose_vars=dose_vars, mask=mask)


def test_stage1_structures_match_jax(cascade):
    js, ps = cascade["jax_struct"], cascade["port_struct"]
    assert ps.shape == js.shape == (1, VOL, VOL, VOL, 9)
    np.testing.assert_array_equal(ps[..., 0], js[..., 0])       # PTV
    np.testing.assert_array_equal(ps[..., 8], js[..., 8])       # CT
    oars_p, oars_j = ps[..., 1:8], js[..., 1:8]
    assert set(np.unique(oars_p)) <= {0.0, 1.0} and oars_p.sum(-1).max() <= 1
    differ = np.any(oars_p != oars_j, axis=-1)
    assert not np.any(differ & (cascade["margin"] > 2 * TOL))
    assert differ.mean() < 1e-4
    assert len(np.unique(np.argmax(js, -1))) > 2                # several labels present


def test_stage2_dose_matches_jax(cascade):
    structures = np.array(cascade["jax_struct"])
    want = np.asarray(cascade["j2"](cascade["dose_vars"], structures, cascade["mask"]))
    got = cascade["p2"](cascade["dose"].state_dict(), torch.from_numpy(structures),
                        torch.from_numpy(cascade["mask"])).numpy()
    assert got.shape == want.shape == (1, VOL, VOL, VOL, 1)
    assert np.all(got[cascade["mask"] < 1] == 0) and np.all(got >= 0)
    assert np.abs(got - want).max() / SCALE <= TOL
    assert np.count_nonzero(want) > 0


def test_port_runs_without_jax(tmp_path):
    """The port imports neither jax nor the JAX package: run the reduced
    cascade (its stages, then make_cascade_fn), pipeline_map, a K3-routed
    conv, one DOSE-PYFER train step, one C3D cascade step with the split
    rates on a cosine schedule, every module of the data path (a synthetic
    cohort through the native reader, the bf16 dose and seg feeds, the
    packed feed through device_prefetch into a bf16 C3D step) and one
    TranSeg step with remat_blocks, adam8bit and grad_accum in a fresh
    interpreter and inspect sys.modules: no jax, flax, ml_dtypes or JAX
    package module."""
    script = textwrap.dedent(f"""
        import sys
        import torch
        from dose_prediction_tpu_torch.infer.cascade import make_cascade_fn, make_cascade_stages
        from dose_prediction_tpu_torch.infer.pipeline import pipeline_map
        from dose_prediction_tpu_torch.models import DosePyfer, TranSeg
        from dose_prediction_tpu_torch.nn.init import init_params
        cfg = {M.CFG!r}
        seg = init_params(TranSeg(img_size=32, device="cpu", **cfg),
                          torch.Generator().manual_seed(0))
        dose = init_params(DosePyfer(list_ch_A={M.LIST_CH!r}, img_size=48, device="cpu", **cfg),
                           torch.Generator().manual_seed(1))
        s1, s2 = make_cascade_stages(seg, dose, roi_size=(32, 32, 32), sw_batch_size=4)
        g = torch.Generator().manual_seed(2)
        ct = torch.randn((1, 48, 48, 48, 1), generator=g)
        ptv = (torch.rand((1, 48, 48, 48, 1), generator=g) < 0.1).float()
        mask = (torch.rand((1, 48, 48, 48, 1), generator=g) < 0.6).float()
        dose_gy = s2(dose.state_dict(), s1(seg.state_dict(), ct, ptv), mask)
        assert dose_gy.shape == (1, 48, 48, 48, 1) and bool(torch.isfinite(dose_gy).all())
        run = make_cascade_fn(seg, seg.state_dict(), dose, dose.state_dict(),
                              roi_size=(32, 32, 32), sw_batch_size=4)
        assert torch.equal(run(ct, ptv, mask), dose_gy)
        assert list(pipeline_map(lambda i: i, lambda i: -i, range(2))) == [0, -1]
        from dose_prediction_tpu_torch import ops
        from dose_prediction_tpu_torch.core.config import FLAGS
        from dose_prediction_tpu_torch.kernels.conv3d import conv3d_k3
        from dose_prediction_tpu_torch.train import state as S
        from dose_prediction_tpu_torch.train import steps
        y = ops.conv3d(torch.zeros(1, 16, 4, 4, 4), torch.zeros(16, 16, 3, 3, 3), padding=1,
                       method="k3")
        assert y.shape == (1, 16, 4, 4, 4) and FLAGS.use_k3_conv3d == "0"
        opt = S.make_optimizer(dose, learning_rate=1e-4,
                               freeze_labels=S.cascade_freeze_labels(dose))
        step = steps.make_pyfer_train_step(dose, opt)
        gt = torch.cat([torch.rand((1, 48, 48, 48, 1), generator=g), mask], dim=-1)
        state, loss = step(S.TrainState(dose, opt),
                           dict(input=s1(seg.state_dict(), ct, ptv), gt=gt))
        assert state.step == 1 and bool(torch.isfinite(loss))
        from dose_prediction_tpu_torch.models import CascadeC3D
        c3d = CascadeC3D(list_ch_A={M.LIST_CH!r}, list_ch_B={M.LIST_CH!r}, device="cpu")
        opt = S.make_split_lr_optimizer(c3d, lr_encoder=S.cosine_schedule(1e-4, 5),
                                        lr_decoder=1e-4)
        state, loss = steps.make_cascade_c3d_train_step(c3d, opt)(
            S.TrainState(c3d, opt), dict(input=s1(seg.state_dict(), ct, ptv)[:, :32, :32, :32],
                                         gt=gt[:, :32, :32, :32]))
        assert bool(torch.isfinite(loss))
        import importlib, pkgutil
        import dose_prediction_tpu_torch.data as D
        for info in pkgutil.iter_modules(D.__path__):
            importlib.import_module("dose_prediction_tpu_torch.data." + info.name)
        from dose_prediction_tpu_torch.data import native as N
        from dose_prediction_tpu_torch.data.openkbp import OpenKBPDataset
        from dose_prediction_tpu_torch.data.packed import packed_dose_batches
        from dose_prediction_tpu_torch.data.pipeline import device_prefetch, dose_batches, seg_batches
        from dose_prediction_tpu_torch.data.synthetic import make_synthetic_dataset
        ds = OpenKBPDataset(make_synthetic_dataset({str(tmp_path / "cohort")!r}, n_patients=2,
                                                   shape=(32, 32, 32)))
        assert N.native_available(), N.native_build_error()
        assert next(dose_batches(ds, native_bf16=True))["input"].dtype == torch.bfloat16
        assert next(seg_batches(ds, crop=(16, 16, 16), feed_dtype="bfloat16"))["ct"].dtype == torch.bfloat16
        packed = next(device_prefetch(packed_dose_batches(ds), device="cpu"))
        state, loss = steps.make_cascade_c3d_train_step(c3d, opt, packed=True, dtype=torch.bfloat16)(
            S.TrainState(c3d, opt), packed)
        assert bool(torch.isfinite(loss))
        seg_r = TranSeg(img_size=32, remat_blocks=True, device="cpu", **cfg)
        opt = S.make_optimizer(seg_r, learning_rate=1e-4, kind="adam8bit", grad_accum=2)
        state, loss = steps.make_transeg_train_step(seg_r, opt)(
            S.TrainState(seg_r, opt), dict(ct=ct[:, :32, :32, :32],
                                           labels=torch.zeros((1, 32, 32, 32), dtype=torch.uint8)))
        assert bool(torch.isfinite(loss))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "ml_dtypes",
                                            "dose_prediction_tpu"))
        print("FORBIDDEN", bad)
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                                       "PYTHONPATH": str(REPO),
                                                       "HOME": str(tmp_path),
                                                       "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout


def test_dense_mode_is_not_ported():
    """Dense mode is ported (tests/test_torch_port_dense.py); a seg mode the
    JAX package does not know is refused, as there."""
    seg, dose = torch.nn.Module(), torch.nn.Module()
    assert len(make_cascade_stages(seg, dose, seg_mode="dense")) == 2
    with pytest.raises(ValueError, match="unknown seg_mode"):
        make_cascade_stages(seg, dose, seg_mode="patchwise")
