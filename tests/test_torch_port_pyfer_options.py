"""DOSE-PYFER's searched options in the port (models/dose_pyfer.py): the
DualDilatedBlock decoder stages (``multiS_conv=False``) and the ReLU
decoder (``act='relu'``), the choices the search space samples
(train/tune.py::PYFER_SEARCH_SPACE; tune_light_pyfer.py:160-168), against
the JAX package's DosePyfer of the same options on the CPU. The JAX
package's reference importer knows only the flagship's Conv31 stages, so
the weights go the other way: the JAX model's variable tree (from
jax.eval_shape, nothing compiled) filled with seeded values (kernels at
1/√fan-in, norm scales in [0.7, 1.3], BatchNorm statistics off 0/1), into
the port through weights.jax_to_torch (every leaf used, loaded strictly);
then every output within 1e-3 in float32 (the bar of test_golden_pyfer.py),
in eval mode and in train mode (the DualDilatedBlock's InstanceNorms and
the k7 BatchNorms of the Conv31 stages).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dose_prediction_tpu import models as jmodels  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.models import DosePyfer  # noqa: E402
from dose_prediction_tpu_torch.models.spec import model_spec  # noqa: E402

from test_torch_port_models import CFG, LIST_CH, SIZE, TOL, max_err, ncdhw  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

OPTIONS = [dict(multiS_conv=False, act="mish"), dict(multiS_conv=True, act="relu"),
           dict(multiS_conv=False, act="relu")]


def seeded_variables(jax_model, seed):
    """The JAX model's variables, filled with seeded values (module
    docstring)."""
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, SIZE, SIZE, SIZE, 9), np.float32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if path[0].key == "batch_stats":
            low, high = (-0.2, 0.2) if name == "mean" else (0.8, 1.3)
            return rng.uniform(low, high, shape).astype(np.float32)
        if name == "kernel":
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.7, 1.3, shape).astype(np.float32)
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("options", OPTIONS, ids=lambda o: f"multiS{o['multiS_conv']}-{o['act']}")
@pytest.mark.parametrize("train", [False, True])
def test_searched_options_forward_matches_jax(options, train):
    jax_model = jmodels.DosePyfer(out_ch=1, list_ch_A=LIST_CH, **CFG, **options)
    variables = seeded_variables(jax_model, 2)
    model = DosePyfer(list_ch_A=LIST_CH, img_size=SIZE, device="cpu", **CFG, **options)
    assert {k: model_spec(model)[k] for k in options} == options
    model.load_state_dict(weights.jax_to_torch(variables, model), strict=True)
    x = np.random.default_rng(3).standard_normal((1, SIZE, SIZE, SIZE, 9)).astype(np.float32)
    (ja, jbs), _ = jax.jit(lambda v, x: jax_model.apply(v, x, train=train,
                                                        mutable=["batch_stats"]))(variables, x)
    with torch.no_grad():
        ta, tbs = model.train(train)(ncdhw(x))
    assert max_err(ja, ta) <= TOL
    assert len(tbs) == len(jbs) == 4
    for scale, (jb, tb) in enumerate(zip(jbs, tbs)):
        assert max_err(jb, tb) <= TOL, f"deep-supervision scale {scale}"
