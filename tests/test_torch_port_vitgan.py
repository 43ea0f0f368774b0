"""The port's ViT-GAN (train/gan.py: make_vitgan_train_step,
load_pretrained_critic, VitGANTrainer) against the JAX package's
dose_prediction_tpu/train/gan.py on the CPU, float32, at 32³: the small
ViT-GAN generator (hidden size 24, 2 layers, 2 heads, feature size 2,
DualDilatedBlock decoder stages) and a ResNet-10 critic of widths 4-32,
the port's seeded weights carried into JAX by the JAX package's own
importers (core/torch_import.py::import_vitgen, import_resnet10).

The critic's MedicalNet pickle is made here: a ResNet-10 of other seeded
weights, its ``fc`` left out (as MedicalNet's segmentation pretrains carry
none), under DataParallel's ``module.`` prefix. Both packages load it into
the critic; the pretrained mask (every parameter but ``fc``) and the
loaded weights must agree.

Bars:
- one step in each of three modes (``train_d`` on; ``train_d`` off;
  ``freeze_d`` with the pretrained mask): ``g_loss`` within rel 1e-5;
  ``d_loss``, which follows the generator's update of the same step,
  within max(1e-5 of itself, 2 × its departure in the noise runs); the
  critic's half on its own (``train_d`` with the generator's learning rate
  0, so that the critic's loss sees the same generator weights in both
  packages): both losses within rel 1e-5, the generator bit-unchanged, the
  critic's gradient leaves by the rule below with noise runs of their own; each
  gradient leaf of both nets within max(1e-3, 2 × that
  leaf's largest departure in three noise runs) × its own max |g| (a floor
  of 2e-6 × the net's largest |g|), the rule of
  tests/test_torch_port_dosegan.py. A noise run multiplies each
  InstanceNorm and Linear output by (1 + 1e-6·u) and adds to each
  BatchNorm output 1e-6·u × its channel's largest |value| (u seeded uniform
  in [-1, 1], kept out of the gradient). Conv biases that feed a norm have
  a zero gradient in exact arithmetic: below 1e-4 of the net's largest |g|
  in both. Without ``train_d`` the critic is unchanged, its step count
  too, and ``d_loss`` is 0. With ``freeze_d`` the frozen leaves are bit for
  bit unchanged while their Adam first moments have moved, held against
  the JAX package's moments by the gradient rule (a first moment is 0.1 ×
  the gradient);
- VitGANTrainer with the pickle, ``unfreeze_epoch=1``, two epochs of one
  step: validation and test() before any update at rel 1e-5 and 1e-4;
  the first epoch's ``gan_loss`` at rel 1e-5; ``disc_loss`` (the first
  epoch's follows the generator's update in its step: Adam's first update
  turns rounding-sized gradients into ±lr), the second ``gan_loss`` and the
  validations after updates by the noise rule of
  tests/test_torch_port_trainers.py::check_epochs; both optimizers
  restarted at epoch 1 in both packages (one update counted after it);
- the port against itself: an interrupted and resumed fit ends bit for
  bit where an uninterrupted one ends; ``reinit_weights`` by which leaves
  it changes and their statistics.
"""

import contextlib
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dose_prediction_tpu.core import torch_import as TI  # noqa: E402
from dose_prediction_tpu.models import experiments as JE  # noqa: E402
from dose_prediction_tpu.train import gan as JG  # noqa: E402
from dose_prediction_tpu.train import state as JS  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.core.checkpoint import restore_checkpoint  # noqa: E402
from dose_prediction_tpu_torch.models import experiments as E  # noqa: E402
from dose_prediction_tpu_torch.nn.init import reinit_weights  # noqa: E402
from dose_prediction_tpu_torch.train import gan  # noqa: E402
from dose_prediction_tpu_torch.train import state as S  # noqa: E402
from dose_prediction_tpu_torch.train import trainers as T  # noqa: E402

import test_torch_port_models as M  # noqa: E402
import test_torch_port_trainers as TR  # noqa: E402
from test_torch_port_dosegan import channel_scaled_noise, recording  # noqa: E402
from test_torch_port_trainers import cohort32, jax_without_native  # noqa: E402,F401
from test_torch_port_zoo_train import initialized  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

SIZE, WIDTHS = 32, (4, 8, 16, 32)
G_LR, D_LR, DELTA3, DELTA1, DELTA2 = 1e-4, 5e-3, 2.0, 10.0, 8.0
NOISE_RUNS = 3
# conv biases that feed a norm: the generator's DualDilatedBlock and UNETR
# convs (InstanceNorm), none in the bias-free critic
ZERO_GRAD = re.compile(r"^g\..*(conv_[357]\.conv\.[03]|cov_\.conv\.0)\.bias$")
MODES = {"train_d": dict(train_d=True), "no_train_d": dict(train_d=False),
         "freeze_d": dict(train_d=True, freeze_d=True)}
# train_d with the generator's learning rate 0: the critic's half of the step
# on the generator's own weights
CRITIC_HALF = "critic_half"


def port_nets():
    g = M.seeded(E.vitgan_generator(small=True, img_size=SIZE, device="cpu"), seed=1)
    d = M.seeded(E.resnet10(widths=WIDTHS, device="cpu"), seed=2)
    return g, d


def numpy_state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def seeded_batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, SIZE, SIZE, SIZE, 9)).astype(np.float32)
    mask = (rng.uniform(size=(1, SIZE, SIZE, SIZE, 1)) > 0.3).astype(np.float32)
    dose = rng.uniform(size=mask.shape).astype(np.float32) * mask
    return {"input": x, "gt": np.concatenate([dose, mask], axis=-1)}


@pytest.fixture(scope="module")
def medicalnet(tmp_path_factory):
    """A MedicalNet-layout pickle of a ResNet-10 (other seeded weights, no
    fc, 'module.' prefixes) and the critic it loads into in each package:
    (path, port critic, port mask, JAX critic variables, JAX mask)."""
    path = tmp_path_factory.mktemp("medicalnet") / "resnet_10.pth"
    source = M.seeded(E.resnet10(widths=WIDTHS, device="cpu"), seed=7)
    torch.save({"state_dict": {f"module.{k}": v for k, v in source.state_dict().items()
                               if not k.startswith("fc.")}}, path)
    _, d = port_nets()
    jd = JE.ResNet3D(widths=WIDTHS)
    d_vars = to_jax(d, jd, TI.import_resnet10, 1)
    mask = gan.load_pretrained_critic(str(path), d)
    jvars, jmask, _ = JG._load_pretrained_critic(str(path), d_vars)
    return path, d, mask, jax.tree_util.tree_map(np.asarray, jvars), jmask


def to_jax(model, jax_model, importer, channels):
    target = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, SIZE, channels))))
    variables, stats = importer(numpy_state(model), target, verbose=False)
    assert stats["missing"] == 0 and stats["unused"] == 0
    return jax.tree_util.tree_map(np.asarray, variables)


def jax_mask_by_name(jmask, jvars, model):
    """The JAX package's mask tree as {port parameter name: frozen}."""
    as_arrays = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                                       jmask, jvars["params"])
    sd = weights.jax_to_torch({"params": as_arrays, "batch_stats": jvars["batch_stats"]}, model)
    return {n: bool(sd[n].all()) for n, _ in model.named_parameters()}


def test_pretrained_critic_loads_as_the_jax_package_loads_it(medicalnet):
    path, d, mask, jvars, jmask = medicalnet
    assert mask == jax_mask_by_name(jmask, jvars, d)
    assert [n for n, frozen in mask.items() if not frozen] == ["fc.weight", "fc.bias"]
    want = weights.jax_to_torch(jvars, d)
    assert all(torch.equal(v, want[k]) for k, v in d.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    source = torch.load(path)["state_dict"]
    assert torch.equal(d.state_dict()["layer3.0.downsample.1.running_var"],
                       source["module.layer3.0.downsample.1.running_var"])


@contextlib.contextmanager
def noise(seed):
    with TR.noisy_outputs(seed, 1e-6), channel_scaled_noise(seed + 100, 1e-6):
        yield


def first_moments(optimizer, model):
    return {n: optimizer.state[p]["mu"].clone() for n, p in model.named_parameters()
            if p in optimizer.state}


def port_step(medicalnet, batch, mode, noise_ctx=contextlib.nullcontext(), g_lr=G_LR):
    _, d0, mask, _, _ = medicalnet
    g, d = port_nets()
    d.load_state_dict(d0.state_dict())
    g_opt = S.make_optimizer(g, learning_rate=g_lr)
    d_opt = S.make_optimizer(d, learning_rate=D_LR)
    step = gan.make_vitgan_train_step(g, d, g_opt, d_opt, delta3=DELTA3, delta1=DELTA1,
                                      delta2=DELTA2, d_freeze_mask=mask)
    with noise_ctx:
        gs, ds, info = step(S.TrainState(g, g_opt), S.TrainState(d, d_opt),
                            {k: torch.from_numpy(v) for k, v in batch.items()}, **MODES[mode])
    grads = {f"{t}.{n}": p.grad.detach().clone() for t, net in (("g", g), ("d", d))
             for n, p in net.named_parameters() if p.grad is not None}
    after = {f"{t}.{k}": v for t, net in (("g", g), ("d", d))
             for k, v in numpy_state(net).items()}
    return {"g_loss": float(info["g_loss"]), "d_loss": float(info["d_loss"]), "grads": grads,
            "after": after, "steps": (gs.step, ds.step), "mu": first_moments(d_opt, d),
            "d_count": d_opt.count}


def adam_field(opt_state, field="mu"):
    """A field (the first moments, the count) of the optax Adam state
    inside ``opt_state``."""
    if hasattr(opt_state, "mu"):
        return getattr(opt_state, field)
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = adam_field(s, field)
            if found is not None:
                return found
    return None


@pytest.fixture(scope="module")
def gan_steps(medicalnet):
    """One step of each mode in both packages from the same weights and
    batch, and the port's noise runs."""
    _, d0, _, jd_vars, jmask = medicalnet
    g, _ = port_nets()
    jg, jd = JE.vitgan_generator(small=True), JE.ResNet3D(widths=WIDTHS)
    gv = to_jax(g, jg, TI.import_vitgen, 9)
    batch = seeded_batch()
    out = {}
    for mode in [*MODES, CRITIC_HALF]:
        g_lr = 0.0 if mode == CRITIC_HALF else G_LR
        g_tx = recording(JS.make_optimizer(learning_rate=g_lr))
        d_tx = recording(JS.make_optimizer(learning_rate=D_LR))
        jstep = JG.make_vitgan_train_step(jg, jd, g_tx, d_tx, delta3=DELTA3, delta1=DELTA1,
                                          delta2=DELTA2, d_freeze_mask=jmask)
        jgs, jds, info = jstep(JS.create_train_state(gv, g_tx),
                               JS.create_train_state(jd_vars, d_tx),
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               **MODES.get(mode, MODES["train_d"]))
        np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        want = {"g_loss": float(info["g_loss"]), "d_loss": float(info["d_loss"]),
                "steps": (int(jgs.step), int(jds.step)), "grads": {}, "after": {}}
        for tag, model, st in (("g", g, jgs), ("d", d0, jds)):
            grads = weights.jax_to_torch({"params": np_tree(st.opt_state[0]),
                                          "batch_stats": np_tree(st.batch_stats)}, model)
            want["grads"].update({f"{tag}.{n}": grads[n] for n, _ in model.named_parameters()})
            want["after"].update({f"{tag}.{k}": v.numpy() for k, v in weights.jax_to_torch(
                {"params": np_tree(st.params), "batch_stats": np_tree(st.batch_stats)},
                model).items()})
        mu = weights.jax_to_torch({"params": np_tree(adam_field(jds.opt_state[1])),
                                   "batch_stats": np_tree(jds.batch_stats)}, d0)
        want["mu"] = {n: mu[n] for n, _ in d0.named_parameters()}
        out[mode] = (port_step(medicalnet, batch, "train_d" if mode == CRITIC_HALF else mode,
                               g_lr=g_lr), want)
    # the modes differ in the updates only: one set of noise runs serves all;
    # the critic half, whose critic sees the generator's own weights, has its own
    runs = [port_step(medicalnet, batch, "train_d", noise(seed)) for seed in range(NOISE_RUNS)]
    half_runs = [port_step(medicalnet, batch, "train_d", noise(seed), g_lr=0.0)
                 for seed in range(NOISE_RUNS)]
    steps_by_mode = {mode: (port, want, [r["grads"] for r in
                                         (half_runs if mode == CRITIC_HALF else runs)])
                     for mode, (port, want) in out.items()}
    steps_by_mode["d_loss_noise"] = max(abs(r["d_loss"] - out["train_d"][0]["d_loss"])
                                        for r in runs)
    return steps_by_mode


@pytest.mark.parametrize("mode", MODES)
def test_vitgan_step_losses_match_jax(gan_steps, mode):
    port, want, _ = gan_steps[mode]
    print(f"{mode}: g_loss port {port['g_loss']!r} jax {want['g_loss']!r}; d_loss port "
          f"{port['d_loss']!r} jax {want['d_loss']!r}")
    assert abs(port["g_loss"] - want["g_loss"]) <= 1e-5 * abs(want["g_loss"])
    if mode == "no_train_d":
        assert port["d_loss"] == want["d_loss"] == 0.0
        assert port["steps"] == want["steps"] == (1, 0)
    else:
        # d_loss follows the generator's update of the same step (the critic
        # half below holds it without that update)
        limit = max(1e-5 * abs(want["d_loss"]), 2 * gan_steps["d_loss_noise"])
        assert abs(port["d_loss"] - want["d_loss"]) <= limit
        assert port["steps"] == want["steps"] == (1, 1)


def test_vitgan_critic_half_losses_match_jax(gan_steps):
    """The generator at learning rate 0: its update leaves it as loaded in
    both packages, so the critic's loss is computed on the same generator
    weights and holds at rel 1e-5, as g_loss does."""
    port, want, _ = gan_steps[CRITIC_HALF]
    print(f"critic half: g_loss port {port['g_loss']!r} jax {want['g_loss']!r}; d_loss port "
          f"{port['d_loss']!r} jax {want['d_loss']!r}")
    assert abs(port["g_loss"] - want["g_loss"]) <= 1e-5 * abs(want["g_loss"])
    assert want["d_loss"] > 0
    assert abs(port["d_loss"] - want["d_loss"]) <= 1e-5 * abs(want["d_loss"])
    assert port["steps"] == want["steps"] == (1, 1)
    g, _ = port_nets()
    for k, v in numpy_state(g).items():
        if not re.search(r"running_|num_batches_tracked", k):
            assert np.array_equal(port["after"][f"g.{k}"], v), k
            assert np.array_equal(want["after"][f"g.{k}"], v), k


def gradient_ratios(port, want, noisy, names):
    """Each leaf's error over its noise-run limit (module docstring), and
    the zero-gradient biases' largest |g| over the net's largest."""
    zero = [n for n in names if ZERO_GRAD.search(n)]
    leaves = [n for n in names if n not in zero]
    g_max = max(float(want[n].abs().max()) for n in names)
    ratio = {}
    for n in leaves:
        scale = float(want[n].abs().max())
        noise_dep = max(float((run[n] - port[n]).abs().max()) for run in noisy) / scale
        limit = max(max(1e-3, 2 * noise_dep) * scale, 2e-6 * g_max)
        ratio[n] = float((port[n] - want[n]).abs().max()) / limit
    zeros = {n: max(float(port[n].abs().max()), float(want[n].abs().max())) / g_max
             for n in zero}
    return ratio, zeros


@pytest.mark.parametrize("net", ["g", "d"])
@pytest.mark.parametrize("mode", [*MODES, CRITIC_HALF])
def test_vitgan_step_gradients_match_jax_leaf_by_leaf(gan_steps, mode, net):
    port, want, noisy = gan_steps[mode]
    if net == "d" and mode == "no_train_d":
        assert not any(n.startswith("d.") for n in port["grads"])
        return
    names = [n for n in want["grads"] if n.startswith(f"{net}.")]
    ratio, zeros = gradient_ratios(port["grads"], want["grads"], noisy, names)
    worst = max(ratio, key=ratio.get)
    print(f"{mode} {net}: worst leaf err / its limit {ratio[worst]:.3g} ({worst}) over "
          f"{len(ratio)} leaves; zero-gradient biases {len(zeros)}, largest "
          f"{max(zeros.values(), default=0):.3g} of max|g|")
    assert len(ratio) > 10
    assert all(r <= 1.0 for r in ratio.values()), [n for n, r in ratio.items() if r > 1][:5]
    assert all(z <= 1e-4 for z in zeros.values()), zeros


def test_critic_unchanged_without_train_d(gan_steps, medicalnet):
    port, want, _ = gan_steps["no_train_d"]
    d0 = medicalnet[1]
    for k, v in numpy_state(d0).items():
        assert np.array_equal(port["after"][f"d.{k}"], v), k
        if not k.endswith("num_batches_tracked"):
            assert np.array_equal(want["after"][f"d.{k}"], v), k
    assert port["d_count"] == 0 and not port["mu"]


def test_frozen_critic_leaves_hold_while_their_moments_move(gan_steps, medicalnet):
    """freeze_d with the pretrained mask: every leaf but fc bit for bit as
    loaded in both packages, fc moved; the frozen leaves' first moments
    nonzero and the JAX package's by the gradient rule."""
    port, want, _ = gan_steps["freeze_d"]
    _, d0, mask, _, _ = medicalnet
    before = numpy_state(d0)
    for n, frozen_leaf in mask.items():
        moved = not np.array_equal(port["after"][f"d.{n}"], before[n])
        assert moved != frozen_leaf, n
        assert np.array_equal(want["after"][f"d.{n}"], before[n]) == frozen_leaf, n
    frozen = [n for n, f in mask.items() if f]
    assert all(float(port["mu"][n].abs().max()) > 0 for n in frozen)
    _, _, noisy = gan_steps["freeze_d"]
    # a first moment is (1 - b1) × the gradient: the gradient rule, scaled
    ratio, _ = gradient_ratios({f"d.{n}": port["mu"][n] / 0.1 for n in frozen},
                               {f"d.{n}": want["mu"][n] / 0.1 for n in frozen},
                               [{f"d.{n}": run[f"d.{n}"] for n in frozen} for run in noisy],
                               [f"d.{n}" for n in frozen])
    print(f"frozen leaves' first moments: worst err / its limit {max(ratio.values()):.3g}")
    assert all(r <= 1.0 for r in ratio.values())


# -- reinit_weights -------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_reinit_pattern():
    """The JAX package's reinit_weights of the small generator's weights:
    (the port's weights it started from, its result as port tensors)."""
    from dose_prediction_tpu.nn.init import reinit_weights as jreinit

    g = M.seeded(E.vitgan_generator(small=True, img_size=SIZE, device="cpu"), seed=3)
    params = to_jax(g, JE.vitgan_generator(small=True), TI.import_vitgen, 9)["params"]
    jparams = jax.jit(lambda p: jreinit(p, jax.random.PRNGKey(0), init_type="normal",
                                        init_gain=0.02))(params)
    return g, weights.jax_to_torch({"params": jax.tree_util.tree_map(np.asarray, jparams),
                                    "batch_stats": {}}, g)


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming", "orthogonal"])
def test_reinit_weights_redraws_the_leaves_the_jax_package_redraws(jax_reinit_pattern,
                                                                   init_type):
    """Which leaves change is the JAX function's (conv and linear kernels
    redrawn, every bias 0, norm scales drawn about 1, the position
    embedding kept); each redrawn kernel has its draw's standard deviation
    (gain; gain·√(2 / (fan_in + fan_out)); √(2 / fan_in)) within 15 %, an
    orthogonal one a Gram matrix of gain² · I."""
    g0, jafter = jax_reinit_pattern
    g = M.seeded(E.vitgan_generator(small=True, img_size=SIZE, device="cpu"), seed=3)
    reinit_weights(g, torch.Generator().manual_seed(0), init_type=init_type, init_gain=0.02)
    before = dict(g0.named_parameters())
    for n, p in g.named_parameters():
        want, module = jafter[n], g.get_submodule(n.rsplit(".", 1)[0])
        jax_changed = not torch.equal(want, before[n])
        assert (not torch.equal(p, before[n])) == jax_changed, n
        if n.endswith("bias"):
            assert not p.any() and not want.any(), n
        elif p.ndim >= 2 and jax_changed:
            if init_type == "orthogonal":
                check_orthogonal(module, p, 0.02)
                continue
            transposed = isinstance(module, torch.nn.ConvTranspose3d)
            rec = int(np.prod(p.shape[2:]))
            fan_in = (p.shape[0] if transposed else p.shape[1]) * rec
            fan_out = (p.shape[1] if transposed else p.shape[0]) * rec
            std = {"normal": 0.02, "xavier": 0.02 * np.sqrt(2.0 / (fan_in + fan_out)),
                   "kaiming": np.sqrt(2.0 / fan_in)}[init_type]
            if p.numel() >= 256:
                assert abs(float(p.std()) / std - 1) <= 0.15, (n, float(p.std()), std)
        elif p.ndim == 1 and jax_changed:                     # a norm's scale, N(1, gain)
            assert float((p - 1).abs().max()) <= 6 * 0.02 and \
                float((want - 1).abs().max()) <= 6 * 0.02, n
    assert torch.equal(g.encoder.vit.patch_embedding.position_embeddings,
                       g0.encoder.vit.patch_embedding.position_embeddings)


def check_orthogonal(module, w, gain):
    transposed = isinstance(module, torch.nn.ConvTranspose3d)
    cin, cout = (w.shape[0], w.shape[1]) if transposed else (w.shape[1], w.shape[0])
    order = (*range(2, w.ndim), 0, 1) if transposed else (*range(2, w.ndim), 1, 0)
    flat = w.permute(order).reshape(-1, cout).double()
    gram = flat.T @ flat if flat.shape[0] >= cout else flat @ flat.T
    assert torch.allclose(gram, gain ** 2 * torch.eye(gram.shape[0], dtype=torch.float64),
                          atol=1e-6)


# -- the trainer ----------------------------------------------------------------

def make_trainer(tmp_path, tag, medicalnet, **kw):
    g, d = port_nets()
    _, jcfg_port = TR.configs(tmp_path, tag, samples_per_epoch=1)
    cfg = T.TrainConfig(**{**jcfg_port.__dict__, **kw})
    return gan.VitGANTrainer(cfg, generator=g, discriminator=d, example_shape=TR.SHAPE32,
                             unfreeze_epoch=1, pretrained_critic=str(medicalnet[0]))


def both_state(trainer):
    return {f"{t}.{k}": v for t, net in (("g", trainer.gen), ("d", trainer.disc))
            for k, v in numpy_state(net).items()}


def test_vitgan_trainer_matches_jax(tmp_path, medicalnet, cohort32):  # noqa: F811
    ds, jds = cohort32
    jcfg, cfg = TR.configs(tmp_path, "vg", samples_per_epoch=1)
    g, d = port_nets()
    gv = to_jax(g, JE.vitgan_generator(small=True), TI.import_vitgen, 9)
    dv = to_jax(d, JE.ResNet3D(widths=WIDTHS), TI.import_resnet10, 1)
    fields = dict(hidden_size=24, mlp_dim=48, num_layers=2, num_heads=2, feature_size=2,
                  mode_multi_dec=True, act="mish", multiS_conv=False)
    jtr = JG.VitGANTrainer(jcfg, generator=initialized(JE.VitGenerator, gv, **fields),
                           discriminator=initialized(JE.ResNet3D, dv, widths=WIDTHS),
                           example_shape=TR.SHAPE32, unfreeze_epoch=1,
                           pretrained_critic=str(medicalnet[0]))
    tr = make_trainer(tmp_path, "vg", medicalnet)
    assert tr.d_frozen_mask == medicalnet[2]
    keys, scores = ("mean_dose_score", "val_loss"), ("mean_dose_score", "mean_dvh_score")
    TR.assert_close_dict(tr.validate(ds), jtr.validate(jds), keys, TR.REL_EPOCH)
    TR.assert_close_dict(tr.test(ds), jtr.test(jds), scores, TR.REL_TEST)
    jtr.fit(jds, jds, resume=False)
    tr.fit(ds, ds, resume=False)
    assert tr.g_state.step == tr.d_state.step == int(jtr.g_state.step) == 2
    # both optimizers restarted at epoch 1: one update counted since
    assert tr.g_state.optimizer.count == tr.d_state.optimizer.count == 1
    assert int(adam_field(jtr.g_state.opt_state, "count")) == \
        int(adam_field(jtr.d_state.opt_state, "count")) == 1
    assert "critic unfrozen, optimizers restarted" in open(f"{cfg.log_dir}/log.txt").read()
    runs = []
    for seed in range(2):
        twin = make_trainer(tmp_path, f"noise{seed}", medicalnet)
        with noise(seed):
            twin.fit(ds, ds, resume=False)
        runs.append((both_state(twin), TR.records(twin.cfg.log_dir)))
    port, ref = TR.records(cfg.log_dir), TR.records(jcfg.log_dir)
    TR.check_epochs(port, ref, runs, "gan_loss", ())
    # the critic's loss follows the generator's update of the same step
    for key in ("disc_loss",) + keys:
        TR.check_epochs(port, ref, runs, key, (), strict_first=False)


def test_interrupted_fit_resumes_bit_for_bit(tmp_path, medicalnet, cohort32):  # noqa: F811
    """Across the unfreeze epoch: the restarted optimizers' state is what
    the slot restores."""
    ds, _ = cohort32
    whole = make_trainer(tmp_path, "w", medicalnet, max_epochs=3, feed_dtype="packed")
    whole.fit(ds, ds)
    first = make_trainer(tmp_path, "r", medicalnet, max_epochs=3, max_steps=2,
                         feed_dtype="packed")
    first.fit(ds, ds)
    slot = restore_checkpoint(first.cfg.ckpt_dir + "/last.pt")
    assert set(slot) == {"g", "d", "epoch"} and slot["epoch"] == 1
    resumed = make_trainer(tmp_path, "r", medicalnet, max_epochs=3, feed_dtype="packed")
    with torch.no_grad():
        for p in resumed.gen.parameters():
            p.add_(1.0)
    resumed.fit(ds, ds)
    assert resumed.g_state.step == whole.g_state.step == 3
    a, b = both_state(resumed), both_state(whole)
    assert all(np.array_equal(a[k], b[k]) for k in b)
    assert TR.records(resumed.cfg.log_dir)["gan_loss"] == TR.records(whole.cfg.log_dir)[
        "gan_loss"]


def test_mesh_shape_is_refused():
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        gan.VitGANTrainer(T.TrainConfig(mesh_shape={"data": 2}, device="cpu"),
                          example_shape=TR.SHAPE32)
