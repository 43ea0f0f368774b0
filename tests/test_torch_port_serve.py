"""The port's serve entry points against the JAX package on the CPU:
infer/cascade.py::make_cascade_fn and infer/pipeline.py::pipeline_map.

make_cascade_fn runs the reduced cascade of tests/test_torch_port_cascade.py
(48³ volumes, 32³ windows, sw batch 4, the same seeded weights in both
packages). float32, against the JAX make_cascade_fn with ``fuse`` False
and True (two XLA programs or one; the port has no ``fuse``: a CUDA graph
of both stages would optimise nothing across them): the dose to 1e-3 of
the 70 Gy scale.
``input_dtype=bfloat16``: the port casts the volumes and computes in bf16;
the JAX models are built with ``dtype=bfloat16``. A bf16 seg flips labels
near ties, and a flipped label moves the dose around it, so the voxels of
the two bf16 runs do not agree one by one. The bar is on the dose score's
measure, the mean absolute dose over the volume: the port's bf16 run may be
no further from the JAX float32 run than twice the JAX bf16 run is.
pipeline_map: the same outputs and the same order of calls as the JAX one.
"""

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu.core import torch_import as TI  # noqa: E402
from dose_prediction_tpu.infer.cascade import make_cascade_fn as jax_cascade_fn  # noqa: E402
from dose_prediction_tpu.infer.pipeline import pipeline_map as jax_pipeline_map  # noqa: E402

from dose_prediction_tpu_torch.infer.cascade import make_cascade_fn, make_cascade_stages  # noqa: E402
from dose_prediction_tpu_torch.infer.pipeline import pipeline_map  # noqa: E402

import test_torch_port_cascade as C  # noqa: E402  (the reduced cascade's geometry and inputs)
import test_torch_port_models as M  # noqa: E402  (seeded reduced models, JAX import)

GEOMETRY = dict(roi_size=C.ROI, sw_batch_size=C.SW, dose_scale=C.SCALE)


@pytest.fixture(scope="module")
def models():
    seg, dose = M.port_seg(seed=0), M.port_dose(img=C.VOL, seed=1)
    seg_vars, _ = M.to_jax(seg, M.jax_seg(), TI.import_transeg, (1, *C.ROI, 1))
    dose_vars, _ = M.to_jax(dose, M.jax_dose(), TI.import_pyfer, (1, C.VOL, C.VOL, C.VOL, 9))
    return seg, dose, seg_vars, dose_vars


_JAX_RUNS = {}


def _jax_run(models, *, dtype=jnp.float32, **kwargs):
    """The JAX cascade's dose, each configuration built and run once."""
    key = (str(dtype), tuple(sorted((k, str(v)) for k, v in kwargs.items())))
    if key not in _JAX_RUNS:
        _, _, seg_vars, dose_vars = models
        run = jax_cascade_fn(M.jax_seg(dtype=dtype), seg_vars, M.jax_dose(dtype), dose_vars,
                             **GEOMETRY, **kwargs)
        _JAX_RUNS[key] = np.asarray(run(*C._inputs()).astype(jnp.float32))
    return _JAX_RUNS[key]


def _port_run(models, **kwargs):
    seg, dose, _, _ = models
    run = make_cascade_fn(seg, seg.state_dict(), dose, dose.state_dict(), **GEOMETRY, **kwargs)
    return run(*(torch.from_numpy(a) for a in C._inputs()))


@pytest.mark.parametrize("fuse", [False, True])
def test_make_cascade_fn_matches_jax(models, fuse):
    want = _jax_run(models, fuse=fuse)
    got = _port_run(models)
    mask = C._inputs()[2]
    assert got.dtype == torch.float32 and got.shape == want.shape == (1, C.VOL, C.VOL, C.VOL, 1)
    got = got.numpy()
    assert np.all(got[mask < 1] == 0) and np.count_nonzero(want) > 0
    assert np.abs(got - want).max() / C.SCALE <= C.TOL


def test_make_cascade_fn_bf16_input_dtype_matches_jax(models):
    """The cast comes before dispatch: the run equals the port's stages on
    volumes cast to bf16, bit for bit, in bf16; then the dose-score bar."""
    got = _port_run(models, input_dtype=torch.bfloat16)
    seg, dose, _, _ = models
    s1, s2 = make_cascade_stages(seg, dose, **GEOMETRY)
    ct, ptv, mask = (torch.from_numpy(a).bfloat16() for a in C._inputs())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, s2(dose.state_dict(), s1(seg.state_dict(), ct, ptv), mask))
    want_f32 = _jax_run(models, fuse=False)
    want_bf16 = _jax_run(models, dtype=jnp.bfloat16, input_dtype=jnp.bfloat16)
    port_err = float(np.abs(got.float().numpy() - want_f32).mean())
    jax_err = float(np.abs(want_bf16 - want_f32).mean())
    print(f"mean |dose - JAX f32|: port bf16 {port_err} Gy, JAX bf16 {jax_err} Gy")
    assert port_err <= 2 * jax_err


def test_make_cascade_fn_aot_is_not_ported(models):
    """``aot`` does not run on the CPU: it captures CUDA graphs
    (infer/aot.py), and on CPU tensors it raises, naming the stage and the
    device, instead of running eager. The port takes no ``fuse``."""
    with pytest.raises(ValueError, match="'stage1'.*cpu"):
        _port_run(models, aot=True)
    with pytest.raises(TypeError, match="fuse"):
        _port_run(models, fuse=True)


@pytest.mark.parametrize("items", [[], [0], [0, 1, 2, 3]])
def test_pipeline_map_matches_jax(items):
    """produce(i + 1) is called before consume(i); results come in order."""
    def traced(fn_map):
        log = []

        def produce(i):
            log.append(("produce", i))
            return 10 * i + 1

        def consume(x):
            log.append(("consume", x))
            return -x

        return list(fn_map(produce, consume, iter(items))), log

    got, got_log = traced(pipeline_map)
    want, want_log = traced(jax_pipeline_map)
    assert got == want == [-(10 * i + 1) for i in items]
    assert got_log == want_log
    if len(items) > 1:
        assert got_log[:3] == [("produce", 0), ("produce", 1), ("consume", 1)]
