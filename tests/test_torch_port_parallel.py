"""The port's mesh (dose_prediction_tpu_torch/parallel/mesh.py) in one
process on the CPU.

- The sharding rules against the JAX package's: JAX's ``param_shardings`` on
  a virtual CPU mesh (tests/conftest.py's 8 devices) over a tiny model, the
  port's over the same configuration, its leaves mapped to the JAX paths by
  the weights carry's name map (weights.walk_key_map, or the TranSeg and
  UNETR key maps) and its torch dims to the JAX dims. The models: the tiny
  DOSE-PYFER of __graft_entry__.py:81-84 (``skip4`` and ``decoder4`` below
  ``net_B``), and TranSeg (seg family, dense and separable k7) and UNETR at
  the JAX seg mesh tests' widths (tests/test_mesh_val.py:79-81), whose
  ``decoder4`` sits at the top level. On {'data': 4, 'model': 2} and
  {'data': 2, 'model': 3} (where 3 divides no conv's output channels) the
  two name the same leaves on the same logical axes and drop the same, and
  no norm scale; on {'data': 2, 'model': 4} they differ only where the
  port keeps attention whole because 4 does not divide the heads (the one
  layout difference mesh.py's docstring states).
- ``create_mesh``'s errors, the batch sharding's rows and
  ``device_prefetch(sharding=...)``.
- A gloo world of one process: ``PyferTrainer``, ``TranSegTrainer`` and
  ``UNETRSegTrainer`` with ``mesh_shape={'data': 1, 'model': 1}`` train,
  validate and write their slots bit for bit as the trainers without a
  mesh; the trainers without a mesh branch (ROADMAP queue 1 item 7.4)
  refuse one.

The two-process runs are in tests/test_torch_port_multihost.py.
"""
import socket

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu.models import UNETR as JUNETR  # noqa: E402
from dose_prediction_tpu.models import DosePyfer as JDosePyfer  # noqa: E402
from dose_prediction_tpu.models import TranSeg as JTranSeg  # noqa: E402
from dose_prediction_tpu.parallel import mesh as JPM  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.data.pipeline import device_prefetch, host_to_global  # noqa: E402
from dose_prediction_tpu_torch.models import UNETR, DosePyfer, TranSeg  # noqa: E402
from dose_prediction_tpu_torch.parallel import mesh as PM  # noqa: E402
from dose_prediction_tpu_torch.parallel import multihost as MH  # noqa: E402
from dose_prediction_tpu_torch.train import trainers as T  # noqa: E402

from test_torch_port_trainers import (  # noqa: E402,F401
    cohort32,
    jax_without_native,
    make_cohort,
    records,
)

TINY = dict(out_ch=1, list_ch_A=(-1, 4, 8, 16, 32, 64), feature_size=4, hidden_size=48,
            mlp_dim=96, num_layers=8, num_heads=6)
SEG_TINY = dict(out_ch=8, feature_size=2, hidden_size=24, mlp_dim=48, num_layers=2,
                num_heads=2)
# by model: (JAX model, port model, JAX input, heads, split convs under
# skip4 / decoder4): DOSE-PYFER skip4's transposed conv and decoder4's six;
# TranSeg decoder4's transposed conv, two k3 convs, two k7 convs (each a
# chain of three 1-D convs when separable) and the fuse; UNETR decoder4's
# transposed conv and its residual block's three convs
RULE_MODELS = {
    "pyfer": (lambda: JDosePyfer(**TINY),
              lambda: DosePyfer(img_size=32, device="cpu", **TINY),
              (1, 32, 32, 32, 9), TINY["num_heads"], 7),
    "transeg": (lambda: JTranSeg(**SEG_TINY),
                lambda: TranSeg(img_size=16, device="cpu", **SEG_TINY),
                (1, 16, 16, 16, 1), SEG_TINY["num_heads"], 6),
    "transeg_separable": (lambda: JTranSeg(k7_mode="separable", **SEG_TINY),
                          lambda: TranSeg(img_size=16, k7_mode="separable", device="cpu",
                                          **SEG_TINY),
                          (1, 16, 16, 16, 1), SEG_TINY["num_heads"], 10),
    "unetr": (lambda: JUNETR(**SEG_TINY),
              lambda: UNETR(img_size=16, device="cpu", **SEG_TINY),
              (1, 16, 16, 16, 1), SEG_TINY["num_heads"], 4),
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sized_mesh(shape, index=None):
    """A Mesh of ``shape`` for what needs only its sizes and this process's
    coordinates (no process group)."""
    mesh = PM.Mesh(None, shape, torch.device("cpu"))
    mesh.index = lambda axis: (index or {}).get(axis, 0)
    return mesh


def jax_assignments(kind, shape, devices):
    """{JAX path: ((dim, axis), ...)} of the split leaves of JAX's rules."""
    make, _, example, _, _ = RULE_MODELS[kind]
    shapes = jax.eval_shape(make().init, jax.random.PRNGKey(0), jnp.zeros(example))
    mesh = JPM.create_mesh(shape, devices=devices)
    tree = JPM.param_shardings(shapes["params"], mesh, JPM.VIT_TP_RULES)
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(tree)[0]:
        split = tuple((d, a) for d, a in enumerate(sh.spec) if a is not None)
        if split:
            out["/".join(str(getattr(p, "key", p)) for p in path)] = split
    return out


def jax_dim(module, ndim, dim):
    """The JAX layout's dim of a torch leaf's ``dim``: kernels (in, out) and
    (k.., I, O) against torch's (out, in), (O, I, k..) and, transposed,
    (I, O, k..)."""
    if ndim == 2:
        return 1 - dim
    if ndim == 5:
        out_dim = 1 if isinstance(module, torch.nn.ConvTranspose3d) else 0
        return 4 if dim == out_dim else 3
    return dim


def port_assignments(kind, shape):
    model = RULE_MODELS[kind][1]()
    key_map = weights._KEY_MAPS.get(type(model), lambda key: weights.walk_key_map(model, key))
    shards = PM.param_shardings(model, sized_mesh(shape), PM.VIT_TP_RULES)
    params = dict(model.named_parameters())
    out = {}
    for name, shard in shards.items():
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        ndim = params[name].ndim
        flax_leaf = {"bias": "bias"}.get(leaf, "kernel" if ndim > 1 else "scale")
        path = "/".join(key_map(owner) + (flax_leaf,))
        out[path] = ((jax_dim(module, ndim, shard.dim), shard.axis),)
    return out


@pytest.mark.parametrize("kind", list(RULE_MODELS))
@pytest.mark.parametrize("shape,n_devices", [({"data": 4, "model": 2}, 8),
                                             ({"data": 2, "model": 3}, 6),
                                             ({"data": 2, "model": 4}, 8)])
def test_rules_select_the_jax_leaves(shape, n_devices, kind):
    *_, heads, n_convs = RULE_MODELS[kind]
    layers = (TINY if kind == "pyfer" else SEG_TINY)["num_layers"]
    want = jax_assignments(kind, shape, jax.devices()[:n_devices])
    got = port_assignments(kind, shape)
    assert not [p for p in got if p.endswith("/scale")]       # no norm scale
    attention = {p for p in want if p.endswith(("attn/qkv/kernel", "attn/out_proj/kernel"))}
    if heads % shape["model"]:
        # the port keeps attention whole where the heads do not divide
        assert attention and not attention & set(got)
        want = {p: s for p, s in want.items() if p not in attention}
    assert got == want
    convs = [p for p in want if "skip4" in p or "decoder4" in p]
    if shape["model"] == 3:         # 3 divides no conv's output channels: dropped by both
        assert not convs and any("mlp/linear1" in p for p in got)
    else:   # the model's skip4 / decoder4 convs; five ViT leaves a layer
        assert len(convs) == n_convs and len(got) == n_convs + 5 * layers - \
            2 * layers * bool(heads % shape["model"])


def test_create_mesh_errors():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="mesh wants 2 devices, have 1"):
        PM.create_mesh({"data": 2})
    with pytest.raises(ValueError, match="mesh wants 4 devices, have 1"):
        MH.global_mesh({"data": 2, "model": 2})
    with pytest.raises(ValueError, match="at least 1"):
        PM.create_mesh({"data": 1, "model": 0})
    with pytest.raises(ValueError, match="torch.distributed initialised"):
        PM.create_mesh({"data": 1})


def test_batch_rows_and_sharded_prefetch():
    batch = {"input": torch.arange(24.0).reshape(4, 6), "gt": torch.arange(4)}
    mesh = sized_mesh({"data": 2, "model": 2}, {"data": 1, "model": 1})
    rows = PM.batch_sharding(mesh)
    assert rows.rows(4) == slice(2, 4)
    assert MH.process_slice(4) == slice(0, 4)
    with pytest.raises(ValueError, match="does not divide"):
        rows.rows(3)
    got = host_to_global(rows, batch["input"])
    assert torch.equal(got, batch["input"][2:])
    assert torch.equal(host_to_global(None, batch["input"]), batch["input"])
    assert torch.equal(host_to_global(rows, batch["input"][:2], local_rows=True),
                       batch["input"][:2])
    fed = list(device_prefetch(iter([batch]), device="cpu", sharding=rows))
    assert [torch.equal(fed[0][k], v[2:]) for k, v in batch.items()] == [True, True]
    mine = list(device_prefetch(iter([{k: v[2:] for k, v in batch.items()}]), device="cpu",
                                sharding=rows, local_rows=True))
    assert [torch.equal(mine[0][k], v[2:]) for k, v in batch.items()] == [True, True]
    whole = list(device_prefetch(iter([batch]), device="cpu"))
    assert torch.equal(whole[0]["input"], batch["input"])
    with pytest.raises(ValueError, match="local_rows"):
        list(device_prefetch(iter([batch]), device="cpu", local_rows=True))


@pytest.fixture
def world_of_one():
    MH.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_world_of_one_mesh_trains_bit_for_bit(tmp_path, cohort32, world_of_one):
    ds, _ = cohort32
    runs = {}
    for tag, mesh in (("plain", None), ("mesh", {"data": 1, "model": 1})):
        cfg = T.TrainConfig(max_epochs=2, check_val=1, learning_rate=1e-3, device="cpu",
                            mesh_shape=mesh, ckpt_dir=str(tmp_path / f"{tag}_ck"),
                            log_dir=str(tmp_path / f"{tag}_log"))
        model = T.seeded(0, lambda: DosePyfer(img_size=32, device="cpu", **TINY))
        tr = T.PyferTrainer(cfg, model=model, example_shape=(1, 32, 32, 32, 9))
        tr.fit(ds, ds, resume=False)
        runs[tag] = (tr, torch.load(tmp_path / f"{tag}_ck" / "last.pt", weights_only=True))
    (plain, slot_p), (mesh, slot_m) = runs["plain"], runs["mesh"]
    assert mesh.mesh.shape == {"data": 1, "model": 1} and mesh.state.plan.shards == {}
    assert plain.state.step == mesh.state.step == 4
    assert torch.equal(plain.state.moving_loss, mesh.state.moving_loss)
    assert plain.best_val == mesh.best_val
    a, b = plain.model.state_dict(), mesh.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert slot_p["moving_loss"] == slot_m["moving_loss"]
    assert all(torch.equal(slot_p["model"][k], slot_m["model"][k]) for k in slot_p["model"])
    assert all(torch.equal(x, slot_m["optimizer"]["state"][i][k])
               for i, st in slot_p["optimizer"]["state"].items() for k, x in st.items())


@pytest.fixture(scope="module")
def seg_cohort(tmp_path_factory):
    """Two 24³ patients, the JAX seg mesh tests' (tests/test_mesh_val.py:79)."""
    return make_cohort(tmp_path_factory.mktemp("seg_cohort"), 24)[0]


@pytest.mark.parametrize("kind", ["transeg", "unetr"])
def test_world_of_one_seg_mesh_trains_bit_for_bit(tmp_path, seg_cohort, world_of_one, kind):
    """The seg trainers on {'data': 1, 'model': 1}: the same steps, losses,
    validation, parameters and slots as without a mesh, bit for bit."""
    cls = T.TranSegTrainer if kind == "transeg" else T.UNETRSegTrainer
    runs = {}
    for tag, mesh in (("plain", None), ("mesh", {"data": 1, "model": 1})):
        cfg = T.TrainConfig(max_epochs=2, check_val=1, batch_size=2, learning_rate=1e-3,
                            device="cpu", mesh_shape=mesh, ckpt_dir=str(tmp_path / f"{tag}_ck"),
                            log_dir=str(tmp_path / f"{tag}_log"))
        tr = cls(cfg, model=T.seeded(0, RULE_MODELS[kind][1]), crop=(16, 16, 16))
        tr.fit(seg_cohort, seg_cohort, num_samples=2, resume=False)
        runs[tag] = (tr, torch.load(tmp_path / f"{tag}_ck" / "last.pt", weights_only=True),
                     records(cfg.log_dir))
    (plain, slot_p, rec_p), (mesh, slot_m, rec_m) = runs["plain"], runs["mesh"]
    assert mesh.mesh.shape == {"data": 1, "model": 1} and mesh.state.plan.shards == {}
    assert plain.state.step == mesh.state.step == 4
    assert torch.equal(plain.state.moving_loss, mesh.state.moving_loss)
    np.testing.assert_equal(rec_m, rec_p)       # a NaN HD95 equal to a NaN
    assert len(rec_p["val_loss"]) == 2
    a, b = plain.model.state_dict(), mesh.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(slot_p["model"][k], slot_m["model"][k]) for k in slot_p["model"])
    assert all(torch.equal(x, slot_m["optimizer"]["state"][i][k])
               for i, st in slot_p["optimizer"]["state"].items() for k, x in st.items())


def test_trainers_without_a_mesh_branch_refuse_one():
    """The C3D, HD-UNet, DoseGAN, exp and ViT-GAN trainers refuse a mesh with
    queue 1 item 7.4's message before they build anything; the seg trainers
    take one, and refuse a mesh that one process cannot fill."""
    from dose_prediction_tpu_torch.train.gan import VitGANTrainer

    cfg = T.TrainConfig(mesh_shape={"data": 2}, device="cpu")
    for cls in (T.CascadeC3DTrainer, T.HDUNetTrainer, T.DoseGANTrainer, T.ExpModelTrainer,
                VitGANTrainer):
        with pytest.raises(NotImplementedError, match="queue 1 item 7.4"):
            cls(cfg)
    for cls, kind in ((T.TranSegTrainer, "transeg"), (T.UNETRSegTrainer, "unetr")):
        with pytest.raises(ValueError, match="mesh wants 2 devices, have 1"):
            cls(cfg, model=RULE_MODELS[kind][1](), crop=(16, 16, 16))
