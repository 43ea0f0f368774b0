"""The port's experiments zoo (dose_prediction_tpu_torch/models/experiments.py)
against the JAX package's on the CPU, float32: the ViT generators, ResNet-10
and the zoo's blocks here, the zoo's models in
tests/test_torch_port_exp_zoo.py; the exp model's deep-supervision step
and ExpModelTrainer here too.

Sizes: a ViT of hidden size 24, 2 layers (12 for SharedUNetRModel, which
taps layers 2-10) and 2 heads, feature size 2, at 32³; the C3D widths
(-1, 2, 4, 8, 16, 32) (ResNet-10 at widths 4-32). The port's seeded
weights (test_torch_port_models.seeded: norms and BatchNorm statistics off
1/0) go into JAX: ``VitGenerator`` and ``ResNet3D`` through the JAX
package's own importers (core/torch_import.py::import_vitgen and
import_resnet10 of the port's ``state_dict()``), whose merge must report no
missing and no unused leaf; the other zoo models, which have no importer,
through the port's key map (weights.walk_key_map), whose leaves must be the
JAX init's, shape for shape. weights.jax_to_torch carries JAX variables
back and loads strictly.

Bar: forward within 1e-3 (tests/test_golden_pyfer.py's), in eval and in
train mode where the model has BatchNorm.

The deep-supervision step (train/steps.py::make_deep_supervision_train_step)
of the small exp generator (Conv31 stages, whose k7 branches hold
BatchNorm) on a seeded 32³ batch against the JAX package's, with the L1
and with the Huber reconstruction term: the loss within
rel 1e-5, the BatchNorm statistics it keeps within 1e-5 (the rule of
tests/test_torch_port_dosegan.py), each gradient leaf within max(1e-3, 2 ×
its largest departure in three noise runs) × its own max |g| (the rule of
tests/test_torch_port_vitgan.py). ExpModelTrainer for two epochs of one
step from the same weights in both packages: validation and test() before
any update at rel 1e-5 and 1e-4, the first epoch's loss at rel 1e-5, the
second's and the validations after updates by the noise rule of
tests/test_torch_port_trainers.py::check_epochs; an interrupted and resumed
fit ends bit for bit where an uninterrupted one ends.
"""

import contextlib
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu.core import torch_import as TI  # noqa: E402
from dose_prediction_tpu.models import experiments as JE  # noqa: E402
from dose_prediction_tpu.train import state as JS  # noqa: E402
from dose_prediction_tpu.train import steps as JSTEP  # noqa: E402
from dose_prediction_tpu.train import trainers as JT  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.core.checkpoint import restore_checkpoint  # noqa: E402
from dose_prediction_tpu_torch.models import experiments as E  # noqa: E402
from dose_prediction_tpu_torch.train import state as S  # noqa: E402
from dose_prediction_tpu_torch.train import steps  # noqa: E402
from dose_prediction_tpu_torch.train import trainers as T  # noqa: E402

import test_torch_port_models as M  # noqa: E402
import test_torch_port_trainers as TR  # noqa: E402
import test_torch_port_zoo_blocks as B  # noqa: E402
from test_torch_port_dosegan import buffers_close, channel_scaled_noise, recording  # noqa: E402
from test_torch_port_trainers import cohort32, jax_without_native  # noqa: E402,F401
from test_torch_port_zoo_train import initialized  # noqa: E402

SIZE, TOL = 32, 1e-3
VIT = dict(hidden_size=24, mlp_dim=48, num_layers=2, num_heads=2)
LIST_CH = (-1, 2, 4, 8, 16, 32)
DEV = "cpu"


def to_jax(module, state_dict=None):
    """JAX variables of ``module``'s state dict (or of ``state_dict``, keyed
    as ``module``'s) through weights.walk_key_map."""
    tree = {"params": {}, "batch_stats": {}}
    for key, value in (state_dict or module.state_dict()).items():
        module_key, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        v, collection = value.detach().numpy().copy(), "params"
        if leaf == "weight" and v.ndim == 5:
            transposed = isinstance(module.get_submodule(module_key), torch.nn.ConvTranspose3d)
            v, leaf = v.transpose((2, 3, 4, 0, 1) if transposed else (2, 3, 4, 1, 0)), "kernel"
        elif leaf == "weight" and v.ndim == 2:
            v, leaf = v.T, "kernel"
        elif leaf == "weight":
            leaf = "scale"
        elif leaf in ("running_mean", "running_var"):
            collection, leaf = "batch_stats", leaf[len("running_"):]
        elif leaf == "position_embeddings":
            leaf = "pos_embedding"
        node = tree[collection]
        for name in weights.walk_key_map(module, module_key):
            node = node.setdefault(name, {})
        node[leaf] = v
    return tree


def target(jax_model, *inputs, train=True):
    return jax.eval_shape(lambda *a: jax_model.init(jax.random.PRNGKey(0), *a, train=train)
                          if train is not None else jax_model.init(jax.random.PRNGKey(0), *a),
                          *inputs)


def same_leaves(variables, want):
    return {c: B.leaf_shapes(variables.get(c, {})) for c in ("params", "batch_stats")} == \
        {c: B.leaf_shapes(want.get(c, {})) for c in ("params", "batch_stats")}


def volume(channels, seed, n=1):
    return np.random.default_rng(seed).standard_normal(
        (n, SIZE, SIZE, SIZE, channels)).astype(np.float32)


def flat(out):
    return [out] if not isinstance(out, (tuple, list)) else [a for o in out for a in flat(o)]


def check_forward(port, jax_model, variables, x, train_modes=(False, True)):
    for train in train_modes:
        port.train(train)
        with torch.no_grad():
            got = flat(port(M.ncdhw(x)))
        want, _ = jax.jit(lambda v, x, train=train: jax_model.apply(
            v, x, train=train, mutable=["batch_stats"]))(variables, x)
        want = flat(want)
        assert len(got) == len(want)
        errs = [M.max_err(w, g) for w, g in zip(want, got)]
        print(f"{type(port).__name__} train={train}: max abs err by output {errs}")
        assert max(errs) <= TOL, (train, errs)
    port.eval()


def round_trips(model, variables):
    """weights.jax_to_torch of ``variables`` loads strictly into a fresh
    model of the same configuration and gives back ``model``'s tensors."""
    fresh = type(model)(**model.config, device=DEV)
    result = fresh.load_state_dict(weights.jax_to_torch(variables, fresh), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    for key, value in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[key], value), key


# -- VitGenerator and ResNet3D: through the JAX importers -----------------------

GENERATORS = {
    "vitgan": (lambda: E.vitgan_generator(small=True, img_size=SIZE, device=DEV),
               lambda: JE.vitgan_generator(small=True)),
    "exp": (lambda: E.exp_generator(small=True, img_size=SIZE, device=DEV),
            lambda: JE.exp_generator(small=True)),
    "exp-relu": (lambda: E.exp_generator(small=True, act="relu", img_size=SIZE, device=DEV),
                 lambda: JE.exp_generator(small=True, act="relu")),
    "plain-decoder": (lambda: E.VitGenerator(img_size=SIZE, feature_size=2, **VIT, device=DEV),
                      lambda: JE.VitGenerator(feature_size=2, **VIT)),
}


def imported(port, jax_model, importer, x):
    sd = {k: v.detach().numpy().copy() for k, v in port.state_dict().items()}
    variables, stats = importer(sd, target(jax_model, x), verbose=False)
    assert stats["missing"] == 0 and stats["unused"] == 0
    assert stats["copied"] == stats["inside"] > 0
    return jax.tree_util.tree_map(np.asarray, variables)


@pytest.mark.parametrize("name", GENERATORS)
def test_vit_generator_matches_jax(name):
    """Both PyMSCDecoder branches: ModifiedUnetrUpBlock stages (Conv31 or
    DualDilatedBlock), carried by the JAX importer, and the plain
    UnetrUpBlock ones, which the reference's generators do not use and
    import_vitgen does not map (carried by the port's key map)."""
    make, make_jax = GENERATORS[name]
    port, jm = M.seeded(make(), seed=1), make_jax()
    x = volume(9, seed=1)
    if name == "plain-decoder":      # import_vitgen maps the reference's stages only
        variables = to_jax(port)
        assert same_leaves(variables, target(jm, x))
    else:
        variables = imported(port, jm, TI.import_vitgen, x)
        assert same_leaves(to_jax(port), variables)
    round_trips(port, variables)
    check_forward(port, jm, variables, x,
                  train_modes=(False, True) if name == "exp" else (False,))


def test_resnet10_matches_jax():
    port = M.seeded(E.resnet10(widths=(4, 8, 16, 32), device=DEV), seed=2)
    jm = JE.ResNet3D(widths=(4, 8, 16, 32))
    x = volume(1, seed=2, n=2)
    variables = imported(port, jm, TI.import_resnet10, x)
    round_trips(port, variables)
    for train in (False, True):
        port.train(train)
        with torch.no_grad():
            got = port(M.ncdhw(x)).numpy()
        want, _ = jm.apply(variables, x, train=train, mutable=["batch_stats"])
        err = float(np.abs(np.asarray(want) - got).max())
        print(f"ResNet3D train={train}: max abs err {err:.3g}")
        assert got.shape == (2, 1) and err <= TOL


def test_resnet10_default_widths_are_the_reference():
    """MedicalNet's resnet_10: the JAX model's leaves, shape for shape."""
    port = E.resnet10(device="meta")
    names = {k for k in port.state_dict() if not k.endswith("num_batches_tracked")}
    assert {"conv1.weight", "bn1.running_var", "layer2.0.downsample.0.weight",
            "layer4.0.bn2.weight", "fc.weight", "fc.bias"} <= names
    assert "layer1.0.downsample.0.weight" not in names
    want = target(JE.resnet10(), jax.ShapeDtypeStruct((1, 64, 64, 64, 1), jnp.float32))
    assert same_leaves(to_jax(port, {k: torch.empty(v.shape)
                                     for k, v in port.state_dict().items()}), want)


# -- the zoo's blocks ----------------------------------------------------------

def block_case(name):
    c = 4
    two = [volume(c, 10), volume(c, 11)]
    enc4 = [volume(2, 12), volume(4, 13)[:, ::2, ::2, ::2], volume(8, 14)[:, ::4, ::4, ::4],
            volume(16, 15)[:, ::8, ::8, ::8]]
    enc5 = enc4 + [volume(32, 16)[:, ::16, ::16, ::16]]
    enc5 = [np.ascontiguousarray(e) for e in enc5]
    return {
        "AttGateExp": (E.AttGateExp(c), JE.AttGateExp(c), two),
        "MultiAttGate": (E.MultiAttGate(c), JE.MultiAttGate(c), two),
        "SharedEncoder": (E.SharedEncoder(3, LIST_CH), JE.SharedEncoder(LIST_CH),
                          [volume(3, 17)], None),
        "DilatedSharedEncoder": (E.DilatedSharedEncoder(3, LIST_CH),
                                 JE.DilatedSharedEncoder(LIST_CH), [volume(3, 17)]),
        "DilatedEncoder": (E.DilatedEncoder(3, LIST_CH), JE.DilatedEncoder(LIST_CH),
                           [volume(3, 17)]),
        "InitialEncoderA-1": (E.InitialEncoderA(3, 2, 4, 1), JE.InitialEncoderA(2, 4, 1),
                              [volume(3, 18)]),
        "InitialEncoderA-2": (E.InitialEncoderA(3, 2, 4, 2), JE.InitialEncoderA(2, 4, 2),
                              [volume(3, 18)]),
        "SharedDecoder": (E.SharedDecoder(LIST_CH), JE.SharedDecoder(LIST_CH),
                          [[np.ascontiguousarray(e) for e in enc4]], None),
        "DilatedSharedDecoder": (E.DilatedSharedDecoder(LIST_CH),
                                 JE.DilatedSharedDecoder(LIST_CH),
                                 [[np.ascontiguousarray(e) for e in enc4]]),
        "AttDecoder": (E.AttDecoder(LIST_CH), JE.AttDecoder(LIST_CH), [enc5]),
        "PureAttDecoder": (E.PureAttDecoder(LIST_CH), JE.PureAttDecoder(LIST_CH), [enc5]),
        "PureMultiAttDecoder": (E.PureMultiAttDecoder(LIST_CH), JE.PureMultiAttDecoder(LIST_CH),
                                [enc5]),
        "MonaiUNet": (E.MonaiUNet(3, 2, (2, 4, 8, 16, 32)), JE.MonaiUNet(2, (2, 4, 8, 16, 32)),
                      [volume(3, 19)], None),
    }[name]


BLOCKS = ["AttGateExp", "MultiAttGate", "SharedEncoder", "DilatedSharedEncoder",
          "DilatedEncoder", "InitialEncoderA-1", "InitialEncoderA-2", "SharedDecoder",
          "DilatedSharedDecoder", "AttDecoder", "PureAttDecoder", "PureMultiAttDecoder",
          "MonaiUNet"]


def _ncdhw_tree(x):
    return [_ncdhw_tree(a) for a in x] if isinstance(x, list) else M.ncdhw(x)


@pytest.mark.parametrize("name", BLOCKS)
def test_zoo_block_matches_jax(name):
    case = block_case(name)
    port, jm, inputs = case[:3]
    takes_train = len(case) == 3
    port = M.seeded(port, seed=3)
    variables = to_jax(port)
    want_shapes = target(jm, *inputs, train=False if takes_train else None)
    assert same_leaves(variables, want_shapes)
    for train in ((False, True) if takes_train else (False,)):
        port.train(train)
        with torch.no_grad():
            got = flat(port(*[_ncdhw_tree(x) for x in inputs]))
        if takes_train:
            want, _ = jm.apply(variables, *inputs, train=train, mutable=["batch_stats"])
        else:
            want = jm.apply(variables, *inputs)
        errs = [M.max_err(w, g) for w, g in zip(flat(want), got)]
        print(f"{name} train={train}: max abs err {errs}")
        assert len(flat(want)) == len(got) and max(errs) <= TOL, errs



# -- the deep-supervision step and ExpModelTrainer ------------------------------

LR, WD, NOISE_RUNS = 6.130697604327541e-4, 1.6303111017674179e-4, 3
# conv biases that feed a norm: the UNETR convs and the Conv31 branches'
ZERO_GRAD = re.compile(r"(conv_[37]\.0\.conv\.[03]|cov_\.conv\.0)\.bias$")


def exp_model(seed=5):
    return M.seeded(E.exp_generator(small=True, img_size=SIZE, device=DEV), seed=seed)


def seeded_batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, SIZE, SIZE, SIZE, 9)).astype(np.float32)
    mask = (rng.uniform(size=(1, SIZE, SIZE, SIZE, 1)) > 0.3).astype(np.float32)
    dose = rng.uniform(size=mask.shape).astype(np.float32) * mask
    return {"input": x, "gt": np.concatenate([dose, mask], axis=-1)}


@contextlib.contextmanager
def noise(seed):
    with TR.noisy_outputs(seed, 1e-6), channel_scaled_noise(seed + 100, 1e-6):
        yield


def port_ds_step(batch, noise_ctx=contextlib.nullcontext(), huber=False):
    model = exp_model()
    opt = S.make_optimizer(model, learning_rate=LR, weight_decay=WD)
    step = steps.make_deep_supervision_train_step(model, opt, delta1=10.0, delta2=8.0,
                                                  huber=huber)
    with noise_ctx:
        state, loss = step(S.TrainState(model, opt), {k: torch.from_numpy(v)
                                                      for k, v in batch.items()})
    assert state.step == 1
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return float(loss), grads, {k: v.numpy() for k, v in model.state_dict().items()}


def ds_step_pair(huber):
    """The port's step, the JAX package's and the port's noise runs, from
    the same weights and batch."""
    model, jm = exp_model(), JE.exp_generator(small=True)
    batch = seeded_batch()
    variables = imported(model, jm, TI.import_vitgen, batch["input"])
    tx = recording(JS.make_optimizer(learning_rate=LR, weight_decay=WD))
    jstep = JSTEP.make_deep_supervision_train_step(jm, tx, delta1=10.0, delta2=8.0,
                                                   huber=huber)
    jstate, jloss = jstep(JS.create_train_state(variables, tx),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    grads = weights.jax_to_torch({"params": np_tree(jstate.opt_state[0]),
                                  "batch_stats": np_tree(jstate.batch_stats)}, model)
    after = {k: v.numpy() for k, v in weights.jax_to_torch(
        {"params": np_tree(jstate.params), "batch_stats": np_tree(jstate.batch_stats)},
        model).items()}
    port = port_ds_step(batch, huber=huber)
    noisy = [port_ds_step(batch, noise(seed), huber=huber)[1] for seed in range(NOISE_RUNS)]
    return port, (float(jloss), grads, after), noisy


@pytest.fixture(scope="module")
def ds_step():
    return ds_step_pair(huber=False)


@pytest.fixture(scope="module")
def huber_ds_step():
    return ds_step_pair(huber=True)


def test_deep_supervision_step_matches_jax(ds_step):
    check_ds_step(ds_step, "L1")


def test_huber_deep_supervision_step_matches_jax(huber_ds_step):
    """``huber``: GenLoss's Huber reconstruction term (the option
    ExpModelTrainer(huber=True) sets), by the same bars."""
    check_ds_step(huber_ds_step, "Huber")


def check_ds_step(pair, tag):
    (loss, grads, after), (jloss, jgrads, jafter), noisy = pair
    print(f"deep-supervision step ({tag}): loss port {loss!r} jax {jloss!r}")
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert buffers_close(after, jafter) <= 1.0
    names = list(grads)
    zero = [n for n in names if ZERO_GRAD.search(n)]
    leaves = [n for n in names if n not in zero]
    g_max = max(float(jgrads[n].abs().max()) for n in names)
    ratio = {}
    for n in leaves:
        scale = float(jgrads[n].abs().max())
        dep = max(float((run[n] - grads[n]).abs().max()) for run in noisy) / scale
        ratio[n] = float((grads[n] - jgrads[n]).abs().max()) / max(
            max(1e-3, 2 * dep) * scale, 2e-6 * g_max)
    worst = max(ratio, key=ratio.get)
    print(f"worst leaf err / its limit {ratio[worst]:.3g} ({worst}) over {len(leaves)} "
          f"leaves; {len(zero)} zero-gradient biases")
    assert len(leaves) > 50 and zero
    assert all(r <= 1.0 for r in ratio.values()), [n for n, r in ratio.items() if r > 1][:5]
    for n in zero:
        assert max(float(grads[n].abs().max()), float(jgrads[n].abs().max())) <= 1e-4 * g_max


def exp_trainer(tmp_path, tag, **kw):
    _, cfg = TR.configs(tmp_path, tag, samples_per_epoch=1)
    cfg = T.TrainConfig(**{**cfg.__dict__, **kw})
    return T.ExpModelTrainer(cfg, exp_model(), example_shape=TR.SHAPE32)


def test_exp_trainer_matches_jax(tmp_path, cohort32):  # noqa: F811
    ds, jds = cohort32
    jcfg, cfg = TR.configs(tmp_path, "ex", samples_per_epoch=1)
    model = exp_model()
    variables = imported(model, JE.exp_generator(small=True), TI.import_vitgen,
                         seeded_batch()["input"])
    fields = dict(hidden_size=24, mlp_dim=48, num_layers=2, num_heads=2, feature_size=2,
                  mode_multi_dec=True, act="mish", multiS_conv=True)
    jtr = JT.ExpModelTrainer(jcfg, initialized(JE.VitGenerator, variables, **fields),
                             example_shape=TR.SHAPE32)
    tr = exp_trainer(tmp_path, "ex")
    keys, scores = ("mean_dose_score", "val_loss"), ("mean_dose_score", "mean_dvh_score")
    TR.assert_close_dict(tr.validate(ds), jtr.validate(jds), keys, TR.REL_EPOCH)
    TR.assert_close_dict(tr.test(ds), jtr.test(jds), scores, TR.REL_TEST)
    jtr.fit(jds, jds, resume=False)
    tr.fit(ds, ds, resume=False)
    assert tr.state.step == int(jtr.state.step) == 2
    runs = []
    for seed in range(2):
        twin = exp_trainer(tmp_path, f"noise{seed}")
        with noise(seed):
            twin.fit(ds, ds, resume=False)
        runs.append((None, TR.records(twin.cfg.log_dir)))
    port, ref = TR.records(cfg.log_dir), TR.records(jcfg.log_dir)
    TR.check_epochs(port, ref, runs, "train_mean_loss", ())
    for key in keys:
        TR.check_epochs(port, ref, runs, key, (), strict_first=False)


def test_exp_trainer_resumes_bit_for_bit(tmp_path, cohort32):  # noqa: F811
    ds, _ = cohort32
    whole = exp_trainer(tmp_path, "w", max_epochs=3, feed_dtype="packed")
    whole.fit(ds, ds)
    first = exp_trainer(tmp_path, "r", max_epochs=3, max_steps=2, feed_dtype="packed")
    first.fit(ds, ds)
    assert restore_checkpoint(first.cfg.ckpt_dir + "/last.pt")["epoch"] == 1
    resumed = exp_trainer(tmp_path, "r", max_epochs=3, feed_dtype="packed")
    with torch.no_grad():
        for p in resumed.model.parameters():
            p.add_(1.0)
    resumed.fit(ds, ds)
    assert resumed.state.step == whole.state.step == 3
    a, b = resumed.model.state_dict(), whole.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in b)
    assert TR.records(resumed.cfg.log_dir)["train_mean_loss"] == \
        TR.records(whole.cfg.log_dir)["train_mean_loss"]
