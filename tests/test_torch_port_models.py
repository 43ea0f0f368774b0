"""CPU parity of the PyTorch port's models (DosePyfer, TranSeg) against the
JAX package, and the weight carry-over in both directions.

The port's models are made from a seed (nn/init.py) with their norm affines
and BatchNorm statistics drawn away from 1/0 so those paths count; their
state dicts go into the JAX models through the existing
core/torch_import.py importers (import_pyfer / import_transeg), whose
merge must report no missing and no unused leaves; weights.jax_to_torch
must carry the JAX variables back and load strictly. The same numpy input
then runs through both. Reduced configurations of
tests/test_golden_pyfer.py:37-41 and tests/test_golden_transeg.py:38-39;
float32, max abs ≤ 1e-3 (the bar of test_golden_pyfer.py).

bfloat16: the port's model on a bf16 input against the JAX model built with
``dtype=jnp.bfloat16`` on the same input. Each output must satisfy
max|port − JAX bf16| ≤ 2 · max|JAX bf16 − JAX f32| + one bf16 ulp at the
largest |JAX f32| output: the packages may differ by no more than twice what
bf16 costs the reference itself (both round at different places: the JAX
decomposed convs round each depth tap, its Dense adds a float32 bias before
its one rounding), and the ulp floor is bf16's own resolution at the
output's scale, for an output where the reference's bf16 error happens to be
small.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu import models as jmodels  # noqa: E402
from dose_prediction_tpu.core import torch_import as TI  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.models import DosePyfer, TranSeg  # noqa: E402
from dose_prediction_tpu_torch.nn.init import init_params  # noqa: E402

LIST_CH = (-1, 2, 4, 8, 16, 32)
CFG = dict(feature_size=2, hidden_size=24, mlp_dim=48, num_layers=4, num_heads=2)
SIZE = 32
TOL = 1e-3


def seeded(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded init, then norm affines and BatchNorm statistics off 1/0."""
    g = torch.Generator().manual_seed(seed)
    init_params(model, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.uniform_(-0.2, 0.2, generator=g)
                m.running_var.uniform_(0.8, 1.3, generator=g)
            if isinstance(m, (torch.nn.InstanceNorm3d, torch.nn.BatchNorm3d,
                              torch.nn.LayerNorm)) and m.weight is not None:
                m.weight.uniform_(0.7, 1.3, generator=g)
                m.bias.uniform_(-0.2, 0.2, generator=g)
    return model.eval()


def port_dose(img=SIZE, seed=0):
    return seeded(DosePyfer(list_ch_A=LIST_CH, img_size=img, device="cpu", **CFG), seed)


def port_seg(out_ch=8, img=SIZE, seed=0):
    return seeded(TranSeg(out_ch=out_ch, img_size=img, device="cpu", **CFG), seed)


def jax_dose(dtype=jnp.float32):
    return jmodels.DosePyfer(out_ch=1, list_ch_A=LIST_CH, dtype=dtype, **CFG)


def jax_seg(out_ch=8, dtype=jnp.float32):
    return jmodels.TranSeg(out_ch=out_ch, dtype=dtype, **CFG)


def to_jax(port_model, jax_model, importer, in_shape):
    """JAX variables holding the port model's weights, plus merge stats.
    The target tree comes from jax.eval_shape, so nothing is compiled."""
    target = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct(in_shape, jnp.float32))
    sd = {k: v.detach().numpy() for k, v in port_model.state_dict().items()}
    return importer(sd, target, verbose=False)


def ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 4, 1, 2, 3)))


def max_err(jax_out, port_out):
    return float(np.abs(np.asarray(jax_out) - port_out.detach().numpy().transpose(0, 2, 3, 4, 1)).max())


@pytest.fixture(scope="module")
def dose_pair():
    model = port_dose()
    variables, stats = to_jax(model, jax_dose(), TI.import_pyfer, (1, SIZE, SIZE, SIZE, 9))
    return model, variables, stats


@pytest.fixture(scope="module")
def seg_pair():
    model = port_seg(out_ch=5)
    variables, stats = to_jax(model, jax_seg(5), TI.import_transeg, (1, SIZE, SIZE, SIZE, 1))
    return model, variables, stats


@pytest.mark.parametrize("pair", ["dose_pair", "seg_pair"])
def test_port_state_dict_imports_into_jax_with_no_missing_or_unused_leaves(request, pair):
    _, _, stats = request.getfixturevalue(pair)
    assert stats["missing"] == 0 and stats["unused"] == 0
    assert stats["copied"] == stats["inside"]


@pytest.mark.parametrize("pair,cls,kwargs", [
    ("dose_pair", DosePyfer, dict(list_ch_A=LIST_CH, img_size=SIZE)),
    ("seg_pair", TranSeg, dict(out_ch=5, img_size=SIZE))])
def test_jax_to_torch_loads_strictly_and_round_trips(request, pair, cls, kwargs):
    model, variables, _ = request.getfixturevalue(pair)
    sd = weights.jax_to_torch(jax.tree_util.tree_map(np.asarray, variables),
                              cls(device="cpu", **kwargs, **CFG))
    fresh = cls(device="cpu", **kwargs, **CFG)
    result = fresh.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    for key, value in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[key], value), key


def test_jax_to_torch_rejects_leftover_leaves(dose_pair):
    model, variables, _ = dose_pair
    tree = jax.tree_util.tree_map(np.asarray, variables)
    tree["params"]["extra"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="no port counterpart"):
        weights.jax_to_torch(tree, model)


def test_dose_pyfer_forward_matches_jax(dose_pair):
    """net_A's head and all four deep-supervision outputs."""
    model, variables, _ = dose_pair
    x = np.random.default_rng(0).standard_normal((1, SIZE, SIZE, SIZE, 9)).astype(np.float32)
    (ja, jbs), _ = jax.jit(lambda v, x: jax_dose().apply(v, x, train=False,
                                                         mutable=["batch_stats"]))(variables, x)
    with torch.no_grad():
        ta, tbs = model(ncdhw(x))
    assert max_err(ja, ta) <= TOL
    assert len(tbs) == len(jbs) == 4
    for scale, (jb, tb) in enumerate(zip(jbs, tbs)):
        assert tb.shape[2] == SIZE // 2 ** scale
        assert max_err(jb, tb) <= TOL, f"deep-supervision scale {scale}"


def test_transeg_forward_matches_jax(seg_pair):
    model, variables, _ = seg_pair
    x = np.random.default_rng(1).standard_normal((2, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    jl, _ = jax.jit(lambda v, x: jax_seg(5).apply(v, x, train=False,
                                                  mutable=["batch_stats"]))(variables, x)
    with torch.no_grad():
        tl = model(ncdhw(x))
    assert tl.shape == (2, 5, SIZE, SIZE, SIZE)
    assert max_err(jl, tl) <= TOL


def _flat(out):
    return [out] if not isinstance(out, (tuple, list)) else [a for o in out for a in _flat(o)]


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def assert_bf16_forward_matches_jax(model, jax_model, variables, x):
    """``jax_model(dtype)`` builds the JAX model; ``x`` is NDHWC float32."""
    xb = jnp.asarray(x, jnp.bfloat16)
    want = {}
    for name, dtype, xin in (("f32", jnp.float32, xb.astype(jnp.float32)),
                             ("bf16", jnp.bfloat16, xb)):
        out, _ = jax.jit(lambda v, x: jax_model(dtype).apply(
            v, x, train=False, mutable=["batch_stats"]))(variables, xin)
        want[name] = [np.asarray(o.astype(jnp.float32)) for o in _flat(out)]
    with torch.no_grad():
        got = _flat(model(ncdhw(np.asarray(xb.astype(jnp.float32))).bfloat16()))
    assert len(got) == len(want["bf16"])
    for i, (g, jb, jf) in enumerate(zip(got, want["bf16"], want["f32"])):
        assert g.dtype == torch.bfloat16
        port = g.float().numpy().transpose(0, 2, 3, 4, 1)
        ref_err = float(np.abs(jb - jf).max())
        err = float(np.abs(port - jb).max())
        tol = 2 * ref_err + _bf16_ulp(float(np.abs(jf).max()))
        print(f"output {i}: max|port - JAX bf16| {err:.5g}, tolerance {tol:.5g} "
              f"(max|JAX bf16 - JAX f32| {ref_err:.5g})")
        assert np.isfinite(port).all() and err <= tol, (
            f"output {i}: max|port - JAX bf16| {err} > {tol} (JAX bf16 - f32: {ref_err})")


def test_dose_pyfer_bf16_forward_matches_jax(dose_pair):
    """net_A's head and the four deep-supervision outputs, in bfloat16."""
    model, variables, _ = dose_pair
    x = np.random.default_rng(0).standard_normal((1, SIZE, SIZE, SIZE, 9)).astype(np.float32)
    assert_bf16_forward_matches_jax(model, jax_dose, variables, x)


def test_transeg_bf16_forward_matches_jax(seg_pair):
    model, variables, _ = seg_pair
    x = np.random.default_rng(1).standard_normal((2, SIZE, SIZE, SIZE, 1)).astype(np.float32)
    assert_bf16_forward_matches_jax(model, lambda dtype: jax_seg(5, dtype), variables, x)


def test_models_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible; the no-card behaviour cannot be shown here")
    with pytest.raises(RuntimeError, match="cuda"):
        DosePyfer(list_ch_A=LIST_CH, img_size=SIZE, **CFG)
    with pytest.raises(RuntimeError, match="cuda"):
        TranSeg(img_size=SIZE, **CFG)
