"""The port's dense seg mode against the JAX package on the CPU:
PatchEmbeddingBlock with ``trained_grid`` (JAX PatchEmbed3D), a reduced
TranSeg built for 32³ windows run on a 48³ volume (2³ → 3³ tokens), the
weight carry-over of its resized position embedding (reduced, both ways,
and at bench.py's full width, shapes only), and the dense ``stage1`` of
make_cascade_stages.

Inputs and weights are made with numpy or seeded torch (nn/init.py) and
carried by core/torch_import.py and weights.py; float32. Tolerances: the
patch embedding 1e-5 (one op order apart), the model 1e-3 (the bar of
test_golden_pyfer.py), stage 1 by the label-agreement rule of
tests/test_torch_port_cascade.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu import models as jmodels  # noqa: E402
from dose_prediction_tpu.core import torch_import as TI  # noqa: E402
from dose_prediction_tpu.infer.cascade import make_cascade_stages as jax_stages  # noqa: E402
from dose_prediction_tpu.nn.vit import PatchEmbed3D  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.infer.cascade import make_cascade_stages  # noqa: E402
from dose_prediction_tpu_torch.models import TranSeg  # noqa: E402
from dose_prediction_tpu_torch.nn.vit import PatchEmbeddingBlock  # noqa: E402

import test_torch_port_models as M  # noqa: E402  (seeded reduced models, JAX import)

VOL, TRAINED = 48, (2, 2, 2)          # 48³ volumes, weights for 32³ windows (16³ patches)
TOL = 1e-3


@pytest.mark.parametrize("size", [(12, 12, 12), (8, 12, 16), (8, 8, 8)])
def test_patch_embedding_resizes_its_position_embedding_as_jax(rng, size):
    """trained_grid (2, 2, 2) with 4³ patches: run at 3³ tokens, at an
    anisotropic (2, 3, 4) grid, and at the trained grid (no resize)."""
    c, patch, hidden = 2, 4, 16
    x = rng.standard_normal((2, *size, c)).astype(np.float32)         # NDHWC
    w = (rng.standard_normal((hidden, patch ** 3 * c)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(hidden) * 0.1).astype(np.float32)
    pos = rng.standard_normal((1, 8, hidden)).astype(np.float32)
    block = PatchEmbeddingBlock(c, 8, patch, hidden, trained_grid=TRAINED)
    with torch.no_grad():
        block.patch_embeddings[1].weight.copy_(torch.from_numpy(w))
        block.patch_embeddings[1].bias.copy_(torch.from_numpy(b))
        block.position_embeddings.copy_(torch.from_numpy(pos))
        got = block(torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy()))
    want = PatchEmbed3D(hidden, patch_size=patch, trained_grid=TRAINED).apply(
        {"params": {"proj": {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)},
                    "pos_embedding": jnp.asarray(pos)}}, jnp.asarray(x))
    assert got.shape == want.shape == (2, np.prod([s // patch for s in size]), hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_patch_embedding_without_trained_grid_refuses_another_grid():
    block = PatchEmbeddingBlock(1, 8, 4, 16)
    with pytest.raises(ValueError, match="trained_grid"):
        block(torch.zeros(1, 1, 12, 12, 12))


@pytest.fixture(scope="module")
def dense_seg():
    """A reduced TranSeg for 32³ windows, its weights in the JAX model of the
    same configuration, and the merge stats."""
    port = M.seeded(TranSeg(out_ch=8, trained_grid=TRAINED, device="cpu", **M.CFG), 0)
    jm = jmodels.TranSeg(out_ch=8, trained_grid=TRAINED, **M.CFG)
    variables, stats = M.to_jax(port, jm, TI.import_transeg, (1, VOL, VOL, VOL, 1))
    return port, jm, variables, stats


def test_trained_grid_transeg_weights_carry_both_ways(dense_seg):
    """import_transeg takes the port's state dict (a (1, 8, 24) position
    embedding) with no missing or unused leaves; jax_to_torch carries the
    JAX variables back and loads strictly."""
    port, _, variables, stats = dense_seg
    assert stats["missing"] == 0 and stats["unused"] == 0 and stats["copied"] == stats["inside"]
    assert variables["params"]["vit"]["patch_embedding"]["pos_embedding"].shape == (1, 8, 24)
    sd = weights.jax_to_torch(jax.tree_util.tree_map(np.asarray, variables), port)
    fresh = TranSeg(out_ch=8, trained_grid=TRAINED, device="cpu", **M.CFG)
    fresh.load_state_dict(sd, strict=True)
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_trained_grid_transeg_on_a_larger_volume_matches_jax(dense_seg, rng):
    port, jm, variables, _ = dense_seg
    x = rng.standard_normal((1, VOL, VOL, VOL, 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False,
                                                     mutable=["batch_stats"])[0])(variables, x))
    with torch.no_grad():
        got = port(M.ncdhw(x))
    assert got.shape == (1, 8, VOL, VOL, VOL)
    assert M.max_err(want, got) <= TOL


def test_dense_stage1_matches_jax(dense_seg, rng):
    """The one-hot OARs agree wherever the JAX logits' top two differ by more
    than twice the logit tolerance, and differ at under 1 in 10,000 voxels;
    PTV and CT are carried exactly."""
    port, jm, variables, _ = dense_seg
    ct = rng.standard_normal((1, VOL, VOL, VOL, 1)).astype(np.float32)
    ptv = (rng.random((1, VOL, VOL, VOL, 1)) < 0.1).astype(np.float32)
    j1, _ = jax_stages(jm, M.jax_dose(), seg_mode="dense")
    want = np.asarray(jax.jit(j1)(variables, ct, ptv))
    p1, _ = make_cascade_stages(port, torch.nn.Module(), seg_mode="dense")
    got = p1(port.state_dict(), torch.from_numpy(ct), torch.from_numpy(ptv)).numpy()
    assert got.shape == want.shape == (1, VOL, VOL, VOL, 9)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_array_equal(got[..., 8], want[..., 8])
    logits = np.asarray(jm.apply(variables, ct, train=False, mutable=["batch_stats"])[0])
    top2 = np.sort(logits, axis=-1)[..., -2:]
    differ = np.any(got[..., 1:8] != want[..., 1:8], axis=-1)
    assert not np.any(differ & (top2[..., 1] - top2[..., 0] > 2 * TOL))
    assert differ.mean() < 1e-4
    assert len(np.unique(np.argmax(want, -1))) > 2


def test_full_width_trained_grid_weights_carry_to_the_port():
    """bench.py's dense TranSeg (trained_grid (6, 6, 6), 12-layer ViT-768):
    jax_to_torch maps every JAX leaf, the (1, 216, 768) pos_embedding among
    them, onto the port's state dict, shape for shape, with none left over
    (shapes from jax.eval_shape at a 128³ input; zero arrays of those
    shapes stand in for the values)."""
    jm = jmodels.TranSeg(out_ch=8, trained_grid=(6, 6, 6))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 128, 128, 128, 1), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    assert zeros["params"]["vit"]["patch_embedding"]["pos_embedding"].shape == (1, 216, 768)
    port = TranSeg(out_ch=8, trained_grid=(6, 6, 6), device="meta")
    sd = weights.jax_to_torch(zeros, port)
    assert sd.keys() == port.state_dict().keys()
    assert sd["vit.patch_embedding.position_embeddings"].shape == (1, 216, 768)
    assert all(sd[k].shape == v.shape for k, v in port.state_dict().items())
