"""The port's zoo blocks against the JAX package on the CPU: the pooling,
group norm and PReLU ops, the three MDUNet block families with both k7
modes, the DualDilatedBlock, MultiScaleConv, UnetBasicBlock, UnetrUpBlock,
ModifiedUnetrUpBlock, the conv patch embed, and the separable warm start
(nn/separable.py).

Each port block is made from a seed with its norm affines and BatchNorm
statistics drawn away from 1/0 (test_torch_port_models.seeded); its state
dict goes into JAX variables through the port's own key maps
(weights.transeg_key_map / unetr_key_map, the inverse of jax_to_torch's),
and those must have exactly the leaves, and shapes, of the JAX module's
init. The same numpy input (NDHWC, 8³) then runs through both.

Bars: float32 forward ≤ 1e-3 (test_golden_pyfer.py's), in eval mode and in
train mode, where the BatchNorms' running statistics after the call must
agree to 1e-5 as well. Ops: max pooling exact; average pooling and PReLU
1e-6 and group norm 1e-5 in float32 (float32 statistics in another order),
average pooling one bf16 ulp (2⁻⁷ of the largest output) in bfloat16.
The separable shim: the port's chain weights and per-conv residuals equal
the JAX shim's to 1e-6, and on a rank-1 kernel (A ⊗ b ⊗ c) the residual is
below 1e-6 and the separable block's forward equals the dense block's to
1e-5 of its largest output.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dose_prediction_tpu import ops as jops  # noqa: E402
from dose_prediction_tpu.nn import mdunet as jmd  # noqa: E402
from dose_prediction_tpu.nn import separable as jsep  # noqa: E402
from dose_prediction_tpu.nn import unetr as jun  # noqa: E402
from dose_prediction_tpu.nn import vit as jvit  # noqa: E402

from dose_prediction_tpu_torch import ops, weights  # noqa: E402
from dose_prediction_tpu_torch.nn import mdunet, separable, unetr, vit  # noqa: E402

import test_torch_port_models as M  # noqa: E402  (seeded, ncdhw, max_err)

SIZE, TOL, STATS_TOL = 8, 1e-3, 1e-5


def to_jax_variables(state_dict, key_map):
    """{'params', 'batch_stats'} of numpy arrays from a port state dict:
    ``key_map`` maps a port module key to its flax path."""
    tree = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        module_key, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        if leaf == "num_batches_tracked":
            continue
        path, v = key_map(module_key), value.detach().numpy().copy()
        assert path is not None, key
        collection = "params"
        if leaf == "weight" and v.ndim == 5:
            v, leaf = v.transpose((2, 3, 4, 0, 1) if weights.is_transposed(module_key)
                                  else (2, 3, 4, 1, 0)), "kernel"
        elif leaf == "weight" and v.ndim == 2:
            v, leaf = v.T, "kernel"
        elif leaf == "weight":
            leaf = "scale"
        elif leaf in ("running_mean", "running_var"):
            collection, leaf = "batch_stats", leaf[len("running_"):]
        elif leaf == "position_embeddings":
            leaf = "pos_embedding"
        node = tree[collection]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(v)
    return {k: v for k, v in tree.items() if v}


def under(prefix: str, key_map, drop: int):
    """A key map for a block: ``key_map`` applied below ``prefix``, with the
    first ``drop`` path elements removed."""
    return lambda key: key_map((prefix + key).rstrip("."))[drop:]


def leaf_shapes(tree):
    return {"/".join(str(k.key) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def check_block(port, jax_module, key_map, inputs, *, train_modes=(False, True)):
    """The port block against the JAX module on ``inputs`` (NDHWC arrays),
    in each of ``train_modes`` (None: the module takes no train argument)."""
    variables = to_jax_variables(port.state_dict(), key_map)
    init = (jax_module.init if train_modes == (None,)
            else functools.partial(jax_module.init, train=False))
    target = jax.eval_shape(init, jax.random.PRNGKey(0), *inputs)
    assert {c: leaf_shapes(v) for c, v in variables.items()} == \
        {c: leaf_shapes(v) for c, v in target.items()}
    for train in train_modes:
        port.train(bool(train))
        with torch.no_grad():
            got = port(*[M.ncdhw(x) for x in inputs])
        if train is None:
            want = jax_module.apply(variables, *inputs)
        else:
            want, new = jax_module.apply(variables, *inputs, train=train,
                                         mutable=["batch_stats"])
        err = (M.max_err(want, got) if got.ndim == 5
               else float(np.abs(np.asarray(want) - got.numpy()).max()))
        assert err <= TOL, (train, err)
        if train and "batch_stats" in variables:
            moved = to_jax_variables(port.state_dict(), key_map)["batch_stats"]
            for name in leaf_shapes(moved):
                assert np.abs(_at(moved, name) - np.asarray(_at(new["batch_stats"], name))
                              ).max() <= STATS_TOL, name


def _at(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def inputs(*channels, seed=0, size=SIZE):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, size, size, size, c)).astype(np.float32) for c in channels]


# -- ops ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pools_match_jax(dtype):
    x = np.random.default_rng(0).standard_normal((2, 8, 10, 12, 3)).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x, jdtype)
    xt = M.ncdhw(np.asarray(xj.astype(jnp.float32))).to(dtype)
    for window, stride in ((2, None), (3, 2)):
        mx = ops.max_pool3d(xt, window, stride)
        assert mx.dtype == dtype
        assert np.array_equal(mx.float().numpy().transpose(0, 2, 3, 4, 1),
                              np.asarray(jops.max_pool3d(xj, window, stride).astype(jnp.float32)))
        av = ops.avg_pool3d(xt, window, stride)
        want = np.asarray(jops.avg_pool3d(xj, window, stride).astype(jnp.float32))
        tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7 * np.abs(want).max()
        assert av.dtype == dtype
        assert np.abs(av.float().numpy().transpose(0, 2, 3, 4, 1) - want).max() <= tol


@pytest.mark.parametrize("groups", [1, 2, 6])
def test_group_norm_matches_jax(groups):
    rng = np.random.default_rng(groups)
    x = (rng.standard_normal((2, 4, 5, 6, 6)) * 3 + 1).astype(np.float32)
    scale, bias = rng.random(6).astype(np.float32) + 0.5, rng.standard_normal(6).astype(np.float32)
    want = np.asarray(jops.group_norm(x, scale, bias, num_groups=groups))
    got = ops.group_norm(M.ncdhw(x), torch.from_numpy(scale), torch.from_numpy(bias),
                         num_groups=groups)
    assert np.abs(got.numpy().transpose(0, 2, 3, 4, 1) - want).max() <= 1e-5
    with pytest.raises(ValueError, match="divisible"):
        ops.group_norm(M.ncdhw(x), num_groups=4)


def test_prelu_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 4, 5, 6)).astype(np.float32)
    x[0, 0, 0, 0, :] = 0.0                  # x >= 0 keeps x, zeros included
    alpha = rng.random(6).astype(np.float32)
    want = np.asarray(jops.prelu(x, alpha))
    got = ops.prelu(M.ncdhw(x), torch.from_numpy(alpha))
    assert np.abs(got.numpy().transpose(0, 2, 3, 4, 1) - want).max() <= 1e-6
    scalar = ops.prelu(M.ncdhw(x), torch.tensor(0.25))
    assert np.abs(scalar.numpy().transpose(0, 2, 3, 4, 1)
                  - np.asarray(jops.prelu(x, 0.25))).max() <= 1e-6


# -- MDUNet families ------------------------------------------------------------

@pytest.mark.parametrize("k7_mode", ["dense", "separable"])
@pytest.mark.parametrize("family", ["seg", "dose", "ablation"])
def test_conv31_matches_jax(family, k7_mode):
    port = M.seeded(mdunet.MultiUnetBasicBlock(6, 4, "mish", family, k7_mode), seed=1)
    check_block(port, jmd.Conv31(4, act="mish", family=family, k7_mode=k7_mode),
                under("decoder2.conv_block.", weights.transeg_key_map, 2), inputs(6))


@pytest.mark.parametrize("family", ["seg", "dose", "ablation"])
def test_dual_dilated_block_matches_jax(family):
    port = M.seeded(mdunet.MultiUnetBasicBlock(6, 4, "mish", family, multiS_conv=False), seed=2)
    check_block(port, jmd.DualDilatedBlock(4, act="mish", family=family),
                under("decoder2.conv_block.", weights.transeg_key_map, 2), inputs(6))


def test_ablation_constructors_and_multiscale_conv_match_jax():
    port = M.seeded(mdunet.AblationConv31(5, 3), seed=3)
    assert isinstance(port, mdunet.Conv31) and hasattr(port.conv, "1")
    dual = mdunet.AblationDualDilatedBlock(5, 3)
    assert isinstance(dual.conv[1], torch.nn.BatchNorm3d) and hasattr(dual, "conv_7")
    ms = M.seeded(mdunet.MultiScaleConv(5, 3), seed=4)
    assert all(c.bias is None for c in (ms.conv3, ms.conv5, ms.conv7, ms.conv1))
    check_block(ms, jmd.MultiScaleConv(3), lambda key: (key,), inputs(5), train_modes=(None,))


def test_unknown_family_and_k7_mode_are_refused():
    with pytest.raises(ValueError, match="block family"):
        mdunet.Conv31(4, 2, family="old")
    with pytest.raises(ValueError, match="k7_mode"):
        mdunet.Conv31(4, 2, k7_mode="sparse")


# -- UNETR blocks -----------------------------------------------------------------

def test_unet_basic_block_matches_jax():
    port = M.seeded(unetr.UnetBasicBlock(5, 3), seed=5)
    check_block(port, jun.UnetBasicBlock(3),
                under("decoder2.conv_block.", weights.unetr_key_map, 2), inputs(5),
                train_modes=(None,))


@pytest.mark.parametrize("res_block", [True, False])
def test_unetr_up_block_matches_jax(res_block):
    port = M.seeded(unetr.UnetrUpBlock(6, 3, res_block), seed=6)
    x, skip = inputs(6, 3, seed=7, size=SIZE // 2)[0], inputs(3, seed=8)[0]
    check_block(port, jun.UnetrUpBlock(3, res_block=res_block),
                under("decoder2.", weights.unetr_key_map, 1), [x, skip], train_modes=(None,))


@pytest.mark.parametrize("family,k7_mode,multi", [
    ("dose", "dense", True), ("ablation", "separable", True), ("seg", "dense", False)])
def test_modified_unetr_up_block_matches_jax(family, k7_mode, multi):
    port = M.seeded(unetr.ModifiedUnetrUpBlock(6, 3, "relu", family, k7_mode, multi), seed=9)
    x, skip = inputs(6, seed=10, size=SIZE // 2)[0], inputs(3, seed=11)[0]
    check_block(port, jun.ModifiedUnetrUpBlock(3, act="relu", multiS_conv=multi, family=family,
                                               k7_mode=k7_mode),
                under("decoder2.", weights.transeg_key_map, 1), [x, skip])


def test_conv_patch_embed_matches_jax():
    port = M.seeded(vit.PatchEmbeddingBlock(3, 32, 16, 24, pos_embed="conv"), seed=12)
    assert isinstance(port.patch_embeddings, torch.nn.Conv3d)
    check_block(port, jvit.PatchEmbed3D(24, 16, "conv"),
                under("vit.patch_embedding.", weights.transeg_key_map, 2),
                inputs(3, seed=13, size=32), train_modes=(None,))
    with pytest.raises(ValueError, match="pos_embed"):
        vit.PatchEmbeddingBlock(3, 32, 16, 24, pos_embed="learned")


# -- the separable warm start -------------------------------------------------------

def test_separable_shim_matches_jax():
    """Chain weights and residuals of every k7 conv of a TranSeg decoder
    stage against JAX's separabilize_variables on the same dense weights."""
    dense = M.seeded(unetr.ModifiedUnetrUpBlock(6, 3, "relu", "seg"), seed=14)
    sep = unetr.ModifiedUnetrUpBlock(6, 3, "relu", "seg", "separable")
    sd, errors = separable.separabilize_state_dict(dense.state_dict(), sep.state_dict())
    sep.load_state_dict(sd, strict=True)
    key_map = under("decoder2.", weights.transeg_key_map, 1)
    jvars, jerrors = jsep.separabilize_variables(
        to_jax_variables(dense.state_dict(), key_map), to_jax_variables(sep.state_dict(),
                                                                        key_map))
    assert len(errors) == len(jerrors) == 2
    for base, err in errors.items():
        assert abs(err - jerrors["params/" + "/".join(key_map(base))]) <= 1e-6
    got, want = to_jax_variables(sep.state_dict(), key_map), jvars
    for name in leaf_shapes(want["params"]):
        assert np.abs(_at(got["params"], name) - np.asarray(_at(want["params"], name))).max() \
            <= 1e-6, name
    with pytest.raises(KeyError, match="dense source"):
        separable.separabilize_state_dict({}, sep.state_dict())


def test_separable_shim_is_exact_on_rank_one_kernels():
    rng = np.random.default_rng(15)
    dense = M.seeded(mdunet.ConvBlockK(3, 4, 7, "batch"), seed=15)
    with torch.no_grad():
        for i in (0, 3):
            a = rng.standard_normal((4, 3 if i == 0 else 4, 7))
            b, c = rng.standard_normal(7), rng.standard_normal(7)
            dense.conv[i].weight.copy_(torch.from_numpy(
                np.einsum("oid,h,w->oidhw", a, b, c).astype(np.float32)))
    sep = mdunet.ConvBlockK(3, 4, 7, "batch", separable=True)
    sd, errors = separable.separabilize_state_dict(dense.state_dict(), sep.state_dict())
    sep.load_state_dict(sd, strict=True)
    assert max(errors.values()) <= 1e-6
    x = M.ncdhw(inputs(3, seed=16, size=10)[0])
    with torch.no_grad():
        want = dense.eval()(x)
        assert (sep.eval()(x) - want).abs().max().item() <= 1e-5 * want.abs().max().item()
