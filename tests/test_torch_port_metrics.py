"""The port's OpenKBP and seg metrics against the JAX package's
(dose_prediction_tpu/evaluation/metrics.py) on the CPU.

The host half is a numpy copy: it must give exactly the JAX package's
numbers on the same seeded arrays. The device half runs on CPU tensors
against the jax functions at rel 1e-5 (both compute in float32, in their own
order of operations); its IVS thresholds equal jnp.linspace's bit for bit.
"""

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu.data.nifti import write_nifti as jax_write_nifti  # noqa: E402
from dose_prediction_tpu.evaluation import metrics as JM  # noqa: E402

from dose_prediction_tpu_torch.data.nifti import write_nifti  # noqa: E402
from dose_prediction_tpu_torch.data.openkbp import load_patient  # noqa: E402
from dose_prediction_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from dose_prediction_tpu_torch.evaluation import metrics as M  # noqa: E402
from dose_prediction_tpu_torch.evaluation import plots as P  # noqa: E402

REL = 1e-5
SHAPE = (12, 14, 10)
SPACING = (2.0, 1.5, 2.5)


def volumes(seed):
    rng = np.random.default_rng(seed)
    gt = (rng.random(SHAPE, dtype=np.float32) * 75).astype(np.float32)
    pred = (gt + rng.normal(0, 4, SHAPE)).astype(np.float32)
    mask = (rng.random(SHAPE) > 0.3).astype(np.float32)
    structs = {name: (rng.random(SHAPE) > 0.6 + 0.03 * i).astype(np.uint8)
               for i, name in enumerate(JM.STRUCTURE_NAMES)}
    structs["Larynx"][:] = 0          # an empty structure is skipped
    del structs["PTV56"]              # and so is an absent one
    return pred, gt, mask, structs


def close(a, b, rel=REL):
    return np.allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rel, atol=0)


def test_structure_names_are_the_jax_packages():
    assert (M.OAR_NAMES, M.PTV_NAMES, M.STRUCTURE_NAMES) == \
        (JM.OAR_NAMES, JM.PTV_NAMES, JM.STRUCTURE_NAMES)


@pytest.mark.parametrize("seed", [0, 1])
def test_host_dose_metrics_equal_the_jax_packages(seed):
    pred, gt, mask, structs = volumes(seed)
    assert M.dose_score(pred, gt, mask) == JM.dose_score(pred, gt, mask)
    assert M.dose_score(pred, gt) == JM.dose_score(pred, gt)
    assert M.ivs(pred, gt, 35.0, mask) == JM.ivs(pred, gt, 35.0, mask)
    assert np.array_equal(M.ivs_sweep(pred, gt), JM.ivs_sweep(pred, gt), equal_nan=True)
    for name, s in structs.items():
        mode = "target" if "PTV" in name else "OAR"
        if s.any():
            assert M.dvh_metrics(pred, s, mode=mode, spacing=SPACING) == \
                JM.dvh_metrics(pred, s, mode=mode, spacing=SPACING)
    assert M.dvh_score_for_patient(pred, gt, structs, SPACING) == \
        JM.dvh_score_for_patient(pred, gt, structs, SPACING)
    assert np.array_equal(M.postprocess_prediction(pred / 70, mask),
                          JM.postprocess_prediction(pred / 70, mask))


@pytest.mark.parametrize("seed", [0, 1])
def test_host_seg_metrics_equal_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 4, (16, 16, 16))
    pred = np.where(rng.random(gt.shape) > 0.2, gt, rng.integers(0, 4, gt.shape))
    pred[pred == 3] = 0                    # class 3 absent in the prediction: NaN
    d, h = M.seg_metrics_per_class(pred, gt, 5, SPACING)
    jd, jh = JM.seg_metrics_per_class(pred, gt, 5, SPACING)
    assert np.array_equal(d, jd, equal_nan=True) and np.array_equal(h, jh, equal_nan=True)
    assert M.dice_coefficient(pred, gt) == JM.dice_coefficient(pred, gt)
    assert M.hausdorff95(pred == 1, gt == 1) == JM.hausdorff95(pred == 1, gt == 1)


def test_score_prediction_dirs_equals_the_jax_packages(tmp_path):
    pattern = make_synthetic_dataset(tmp_path / "gt", n_patients=2, shape=(16, 16, 16), seed=3)
    gt_dir = str(tmp_path / "gt")
    rng = np.random.default_rng(4)
    for pdir in sorted((tmp_path / "gt").iterdir()):
        p = load_patient(str(pdir))
        pred = (p.real_dose + rng.normal(0, 2, p.real_dose.shape)).astype(np.float32)
        for root, write in (("port", write_nifti), ("jax", jax_write_nifti)):
            out = tmp_path / root / pdir.name
            out.mkdir(parents=True)
            write(out / "dose.nii.gz", pred, spacing=p.spacing)
    assert pattern
    port = M.score_prediction_dirs(str(tmp_path / "port"), gt_dir)
    ref = JM.score_prediction_dirs(str(tmp_path / "jax"), gt_dir)
    assert port == ref
    assert np.isfinite(port[0]) and np.isfinite(port[1])


def test_isodose_levels_are_jnp_linspace_bit_for_bit():
    for max_gy, n in ((70.0, 101), (80.0, 101), (60.0, 51), (75.0, 201)):
        assert np.array_equal(M.isodose_levels(max_gy, n).numpy(),
                              np.asarray(jnp.linspace(0.0, max_gy, n)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_percentile_matches_jax(seed):
    pred, _, _, structs = volumes(seed)
    for s in list(structs.values()) + [np.zeros(SHAPE, np.uint8)]:
        qs = [0.0, 1.0, 5.0, 37.5, 99.0, 100.0]
        got = M.masked_percentile_device(torch.from_numpy(pred), torch.from_numpy(s), qs)
        for q, g in zip(qs, got):
            ref = float(JM.masked_percentile_jax(jnp.asarray(pred), jnp.asarray(s), q))
            assert close(float(g), ref), (q, float(g), ref)
    empty = M.masked_percentile_device(torch.from_numpy(pred), torch.zeros(SHAPE), 50.0)
    assert float(empty) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_device_dvh_and_ivs_match_jax(seed):
    pred, gt, mask, structs = volumes(seed)
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    for name, s in structs.items():
        mode = "target" if "PTV" in name else "OAR"
        got = M.dvh_metrics_device(tp, torch.from_numpy(s), mode=mode, spacing=SPACING)
        ref = JM.dvh_metrics_jax(jnp.asarray(pred), jnp.asarray(s), mode=mode, spacing=SPACING)
        assert set(got) == set(ref)
        for k in ref:
            assert close(float(got[k]), float(ref[k])), (name, k)
    assert close(float(M.dose_score_device(tp, tg, torch.from_numpy(mask))),
                 float(JM.dose_score_jax(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask))))
    assert close(M.ivs_sweep_device(tp, tg).numpy(),
                 np.asarray(JM.ivs_sweep_jax(jnp.asarray(pred), jnp.asarray(gt))))
    post = M.postprocess_prediction(torch.from_numpy(pred / 70), torch.from_numpy(mask))
    assert np.array_equal(post.numpy(), np.asarray(JM.postprocess_prediction_jax(
        jnp.asarray(pred / 70), jnp.asarray(mask))))


def test_patient_scores_device_match_jax(tmp_path):
    make_synthetic_dataset(tmp_path, n_patients=1, shape=(16, 16, 16), seed=5)
    p = load_patient(str(next(tmp_path.iterdir())))
    rng = np.random.default_rng(6)
    pred = np.clip(p.real_dose + rng.normal(0, 3, p.real_dose.shape), 0, None).astype(np.float32)
    got = M.patient_scores_device(torch.from_numpy(pred), p)
    ref = JM.patient_scores_device(jnp.asarray(pred), p)
    assert close(got["dose_dif"], ref["dose_dif"]) and close(got["dvh_dif"], ref["dvh_dif"])
    assert close(got["ivs"], ref["ivs"])
    lazy = M.patient_scores_device(torch.from_numpy(pred), p, with_ivs=False, sync=False)
    assert set(lazy) == {"dose_dif", "dvh_dif"} and all(torch.is_tensor(v) for v in lazy.values())
    # the host path on the same prediction: the bars of tests/test_losses_metrics.py
    host = M.dvh_score_for_patient(pred, p.real_dose, p.structures, p.spacing)["dvh_dif"]
    assert abs(got["dvh_dif"] - host) <= 1e-3 * abs(host)


def test_plots_write_figures_or_refuse_without_matplotlib(tmp_path, monkeypatch):
    pred, gt, _, structs = volumes(0)
    P.plot_dvh(pred, gt, structs, tmp_path / "dvh.png")
    P.save_slice_triptychs(pred, gt, tmp_path / "slices", every=6)
    assert (tmp_path / "dvh.png").stat().st_size > 0
    assert sorted(f.name for f in (tmp_path / "slices").iterdir()) == ["0.jpg", "6.jpg"]
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("no matplotlib")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(P.PlotsUnavailable, match="matplotlib"):
        P.plot_dvh(pred, gt, structs, tmp_path / "dvh2.png")
