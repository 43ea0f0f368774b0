"""The port's zoo models against the JAX package on the CPU: TranSeg in
every block family (seg, old, ablation) and both k7 modes, the plain UNETR
and HD-UNet; the weights carried
across in both directions; reference checkpoints imported strictly; the
recorded configurations; remat_blocks with the BatchNorm families.

Reduced configurations (the CLI's ``small`` widths: TranSeg and UNETR with
feature size 2, a 4-layer ViT-24 with 2 heads, at 32³; HD-UNet with growth
rate 4 and 8 upsampling channels, at 32³ so that its fifth level is 2³).
The port's seeded weights (test_torch_port_models.seeded) go into JAX
through core/torch_import.py's importers, whose merge must report no
missing and no unused leaf; where the JAX package has no importer for a
module (the separable chains) through the port's own key maps, whose
leaves must equal the JAX init's. weights.jax_to_torch carries JAX
variables back and loads strictly.

Bars: float32 forward ≤ 1e-3 (test_golden_pyfer.py's) in eval and in train
mode. Reference import: the torch replicas of tests/test_golden_transeg.py
(``_TranSeg`` with the OldModels blocks, ``_UNETR``) and
tests/test_golden_hdunet_dosegan.py (``_torch_hdunet``), saved under their
Lightning prefixes, load into the port strictly and its forward equals the
replica's within 1e-5.
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
from dose_prediction_tpu_torch.core.torch_import import (  # noqa: E402
    load_reference_strict,
    load_torch_checkpoint,
)
from dose_prediction_tpu_torch.models import UNETR, HDUNet, TranSeg  # noqa: E402
from dose_prediction_tpu_torch.models.spec import model_spec  # noqa: E402

import test_golden_hdunet_dosegan as GH  # noqa: E402
import test_golden_transeg as GT  # noqa: E402
import test_torch_port_models as M  # noqa: E402
import test_torch_port_zoo_blocks as B  # noqa: E402

CFG, SIZE, TOL, REF_TOL = M.CFG, M.SIZE, M.TOL, 1e-5
HD = dict(growth_rate=4, upsample_chan=8)


def port_transeg(seed=0, **kw):
    return M.seeded(TranSeg(out_ch=5, img_size=SIZE, device="cpu", **CFG, **kw), seed)


def jax_transeg(block_family="seg", k7_mode="dense"):
    return jmodels.TranSeg(out_ch=5, block_family=block_family, k7_mode=k7_mode, **CFG)


def target(jax_model, channels):
    return jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, SIZE, SIZE, SIZE, channels), jnp.float32))


def imported(port, jax_model, importer, channels):
    """The port's weights as JAX variables through the JAX importer; its
    merge must have no missing and no unused leaf."""
    sd = {k: v.detach().numpy().copy() for k, v in port.state_dict().items()}
    variables, stats = importer(sd, target(jax_model, channels), verbose=False)
    assert stats["missing"] == 0 and stats["unused"] == 0
    assert stats["copied"] == stats["inside"] > 0
    return variables


def through_key_map(port, jax_model, key_map, channels):
    """The port's weights as JAX variables through the port's key map; the
    leaves must be the JAX init's, shape for shape."""
    variables = B.to_jax_variables(port, key_map)
    want = target(jax_model, channels)
    assert {c: B.leaf_shapes(v) for c, v in variables.items()} == \
        {c: B.leaf_shapes(v) for c, v in want.items()}
    return variables


def check_forward(port, jax_model, variables, channels, seed, train_modes=(False, True)):
    x = np.random.default_rng(seed).standard_normal(
        (2, SIZE, SIZE, SIZE, channels)).astype(np.float32)
    for train in train_modes:
        port.train(train)
        with torch.no_grad():
            got = port(M.ncdhw(x))
        want, _ = jax.jit(lambda v, x, train=train: jax_model.apply(
            v, x, train=train, mutable=["batch_stats"]))(variables, x)
        err = M.max_err(want, got)
        print(f"{type(port).__name__} train={train}: max abs err {err:.3g}")
        assert err <= TOL, (train, err)
    port.eval()


@pytest.mark.parametrize("family", ["seg", "old", "ablation"])
def test_transeg_family_imports_into_jax_and_matches(family):
    """Every family through the JAX importer (transeg_key_map covers the
    Models/, OldModels/ and ablation Conv31 names), eval and train mode."""
    port = port_transeg(seed=1, block_family=family)
    jm = jax_transeg(family)
    check_forward(port, jm, imported(port, jm, TI.import_transeg, 1), 1, seed=1)


@pytest.mark.parametrize("family", ["old", "seg", "ablation"])
def test_transeg_separable_matches_jax(family):
    port = port_transeg(seed=2, block_family=family, k7_mode="separable")
    jm = jax_transeg(family, "separable")
    check_forward(port, jm, through_key_map(port, jm, weights.transeg_key_map, 1), 1, seed=2)


def test_unetr_imports_into_jax_and_matches():
    port = M.seeded(UNETR(out_ch=5, img_size=SIZE, device="cpu", **CFG), seed=3)
    jm = jmodels.UNETR(out_ch=5, **CFG)
    check_forward(port, jm, imported(port, jm, TI.import_unetr, 1), 1, seed=3,
                  train_modes=(False,))


def test_hdunet_imports_into_jax_and_matches():
    port = M.seeded(HDUNet(device="cpu", **HD), seed=4)
    jm = jmodels.HDUNet(**HD)
    variables = imported(port, jm, TI.import_hdunet, 9)
    x = np.random.default_rng(4).standard_normal((1, SIZE, SIZE, SIZE, 9)).astype(np.float32)
    with torch.no_grad():
        got = port(M.ncdhw(x))
    assert got.shape == (1, 1, SIZE, SIZE, SIZE)
    assert M.max_err(jax.jit(jm.apply)(variables, x), got) <= TOL


def test_hdunet_default_widths_are_the_reference():
    """The full-width HD-UNet (growth 16, 64 upsampling channels) has the
    JAX model's leaves, shape for shape (no weights drawn)."""
    port = HDUNet(device="meta")
    assert B.leaf_shapes(B.to_jax_variables(
        port, weights.hdunet_key_map,
        {k: torch.empty(v.shape) for k, v in port.state_dict().items()})["params"]) == B.leaf_shapes(target(jmodels.HDUNet(), 9)["params"])


@pytest.mark.parametrize("make", [
    lambda: port_transeg(seed=5, block_family="old"),
    lambda: port_transeg(seed=5, block_family="ablation", k7_mode="separable"),
    lambda: M.seeded(UNETR(out_ch=5, img_size=SIZE, device="cpu", **CFG), seed=5),
    lambda: M.seeded(HDUNet(device="cpu", **HD), seed=5)],
    ids=["transeg-old", "transeg-ablation-separable", "unetr", "hdunet"])
def test_jax_to_torch_round_trips_strictly(make):
    model = make()
    key_map = weights._KEY_MAPS[type(model)]
    variables = B.to_jax_variables(model, key_map)
    fresh = type(model)(**{k: v for k, v in model.config.items()}, device="cpu")
    result = fresh.load_state_dict(weights.jax_to_torch(variables, fresh), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    for key, value in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[key], value), key


def save_reference(tmp_path, replica, prefix, container):
    path = tmp_path / "reference.ckpt"
    sd = {prefix + k: v for k, v in replica.state_dict().items()}
    torch.save({container: sd} if container else sd, path)
    return load_torch_checkpoint(str(path))


@pytest.mark.parametrize("kind,prefix,container", [
    ("transeg-old", "_model.", "state_dict"), ("transeg-old", "model.", None),
    ("unetr", "_model.", "state_dict"), ("hdunet", "model_.model.", "state_dict")])
def test_reference_checkpoints_load_strictly(tmp_path, kind, prefix, container):
    """The reference-layout replicas under their Lightning prefixes load
    into the port with every key, and the port's forward equals theirs."""
    torch.manual_seed(6)
    if kind == "hdunet":
        replica = GH._torch_hdunet(in_ch=9, g=4, up=8)
        port, channels = HDUNet(device="cpu", **HD), 9
    elif kind == "unetr":
        replica = GT._UNETR()
        port, channels = UNETR(out_ch=5, img_size=SIZE, device="cpu", **CFG), 1
    else:
        replica = GT._TranSeg("old")
        GT._randomize_batch_stats(replica, seed=6)
        port, channels = TranSeg(out_ch=5, img_size=SIZE, block_family="old", device="cpu",
                                 **CFG), 1
    load_reference_strict(port, save_reference(tmp_path, replica, prefix, container))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, channels, SIZE, SIZE, SIZE)).astype(np.float32))
    with torch.no_grad():
        want, got = replica.eval()(x), port.eval()(x)
    assert (got - want).abs().max().item() <= REF_TOL
    # strict: one entry missing, or one unexpected, fails and names it
    sd = dict(replica.state_dict())
    dropped = sorted(sd)[0]
    del sd[dropped]
    with pytest.raises(ValueError, match="1 missing"):
        load_reference_strict(port, sd)
    with pytest.raises(ValueError, match="1 unexpected"):
        load_reference_strict(port, {**replica.state_dict(), "extra.weight": torch.zeros(1)})


def test_model_spec_records_the_new_configurations():
    seg = TranSeg(block_family="old", k7_mode="separable", device="meta")
    assert {("block_family", "old"), ("k7_mode", "separable")} <= set(model_spec(seg).items())
    assert model_spec(UNETR(device="meta")) == dict(
        in_ch=1, out_ch=8, img_size=96, feature_size=16, hidden_size=768, mlp_dim=3072,
        num_layers=12, num_heads=12, patch_size=16, res_block=True, trained_grid=None)
    assert model_spec(HDUNet(device="meta")) == dict(in_ch=9, growth_rate=16, upsample_chan=64,
                                                     out_ch=1)
    with pytest.raises(ValueError, match="block_family"):
        TranSeg(block_family="dose", device="meta")


@pytest.mark.parametrize("family", ["old", "ablation"])
def test_remat_blocks_keeps_the_batchnorm_families(family):
    """remat_blocks: the same loss, gradients and BatchNorm statistics as
    without, bit for bit, with each statistic updated once."""
    runs = []
    for remat in (False, True):
        model = port_transeg(seed=7, block_family=family, remat_blocks=remat).train()
        x = M.ncdhw(np.random.default_rng(7).standard_normal(
            (1, SIZE, SIZE, SIZE, 1)).astype(np.float32))
        model(x).square().mean().backward()
        runs.append(({n: p.grad for n, p in model.named_parameters()},
                     {k: v for k, v in model.state_dict().items() if "running" in k}))
    (g0, s0), (g1, s1) = runs
    assert s0 and all(torch.equal(s0[k], s1[k]) for k in s0)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
