"""The port's zoo training and evaluation against the JAX package on the
CPU: HD-UNet's single-output step (train/steps.py::make_simple_dose_train_step),
the HDUNetTrainer and UNETRSegTrainer, TranSegTrainer's block families,
train/linked.py::LinkedModel, and the CLI choices that reach them
(``--device cpu --model-size small``).

The step: one packed HD-UNet step (growth rate 4, 8 upsampling channels,
32³, the packed cohort of tests/test_torch_port_train_packed.py) against
the JAX package's real packed step from the same weights: the loss to a
relative 1e-5, each gradient leaf by the noise-run rule of that file taken
leaf by leaf (within max(1e-3, 2 × that leaf's noise-run departure) × its
own max |g|, a floor of 2e-6 × the largest |g|), and the conv biases that
feed an InstanceNorm (zero gradient in exact arithmetic) below 1e-4 of the
largest |g| in both. HD-UNet's noise run differs from that file's: each
InstanceNorm output gets 1e-6 of its plane's largest |value| (seeded, kept
out of the gradient), not 1e-6 of its own value. Rounding in the norm's
subtraction is of that size, and in the ReLU after it moves the few values
within it of 0 across 0, each then passing or stopping a full-size
gradient: the packages' float32 gradients differ by up to 20 % of some
leaves' scale, as far as this noise run moves the port; a relative noise
leaves every sign as it is and moves no leaf by more than 1e-5.
Which side rounds away from the exact gradient is held in float64: both
packages' gradients, with every float32 island of either (InstanceNorm
statistics, conv bias, resize, loss) taken to float64, agree within 1e-9
of each leaf's max |g|, and the port's float32 gradient lies within 1e-3
of them on every leaf (the JAX package's float32 one is the one the flip
moves).

The trainers, as tests/test_torch_port_trainers.py holds its trainers, from the
port's seeded weights given to both (the JAX model's own random
initialisation is not compiled) on two synthetic 32³ patients, validated
after the last epoch: validation and test() before updates at rel 1e-5 and
1e-4, the first epoch's train loss at rel 1e-5, later epochs and the final
parameters by that file's noise-run rule, and the port's evaluation of the
JAX trainer's final weights at rel 1e-5 / 1e-4. UNETR: two epochs of two
steps, as there. HD-UNet: three epochs of one step (``samples_per_epoch=1``)
with three plane-scaled noise runs, since its first epoch must hold the
first step alone: Adam's first update is about lr · sign(g), and the leaves
the ReLU flips move are in it, so a second step's loss already differs by
3e-5.

LinkedModel: the same seeded weights (a small 'old'-family TranSeg over 16³
windows, a small DOSE-PYFER) in both packages on the synthetic 32³ cohort,
float32: each patient's prediction within 1e-3 of the 70 Gy scale (the bar
of tests/test_torch_port_serve.py) and mean_dose_score within rel 1e-4;
bf16 and dense runs bit-equal to make_cascade_fn's.

CLI: each newly ported choice runs; import-torch of the reference-layout
replicas writes slots equal to their state dicts; linked-eval's scores are
the port's metrics on make_cascade_fn's predictions from the same slots.
"""

import contextlib
import json
import re
from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dose_prediction_tpu.core import torch_import as TI  # noqa: E402
from dose_prediction_tpu.data.openkbp import OpenKBPDataset as JDataset  # noqa: E402
from dose_prediction_tpu.models import HDUNet as JHDUNet  # noqa: E402
from dose_prediction_tpu.models import UNETR as JUNETR  # noqa: E402
from dose_prediction_tpu.train import state as JS  # noqa: E402
from dose_prediction_tpu.train import steps as JSTEP  # noqa: E402
from dose_prediction_tpu.train import trainers as JT  # noqa: E402
from dose_prediction_tpu.train.linked import LinkedModel as JLinkedModel  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.cli import main as CLI  # noqa: E402
from dose_prediction_tpu_torch.core.checkpoint import restore_checkpoint  # noqa: E402
from dose_prediction_tpu_torch.data import packed as PK  # noqa: E402
from dose_prediction_tpu_torch.data.openkbp import OpenKBPDataset, load_patient  # noqa: E402
from dose_prediction_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from dose_prediction_tpu_torch.evaluation import metrics as EM  # noqa: E402
from dose_prediction_tpu_torch.infer.cascade import make_cascade_fn  # noqa: E402
from dose_prediction_tpu_torch.models import HDUNet, TranSeg  # noqa: E402
from dose_prediction_tpu_torch.nn.layers import InstanceNorm3d  # noqa: E402
from dose_prediction_tpu_torch.train import state as S  # noqa: E402
from dose_prediction_tpu_torch.train import steps  # noqa: E402
from dose_prediction_tpu_torch.train import trainers as T  # noqa: E402
from dose_prediction_tpu_torch.train.linked import LinkedModel  # noqa: E402

import test_golden_hdunet_dosegan as GH  # noqa: E402
import test_golden_transeg as GT  # noqa: E402
import test_torch_port_models as M  # noqa: E402
import test_torch_port_trainers as TR  # noqa: E402
from test_torch_port_train_packed import batches, cohort, keep_gradients  # noqa: E402,F401
from test_torch_port_trainers import cohort32, jax_without_native  # noqa: E402,F401

SIZE = M.SIZE
HD = dict(growth_rate=4, upsample_chan=8)
# the SingleConv and upsampling convs: each feeds an InstanceNorm
ZERO_GRAD_HDUNET = re.compile(r"single_conv\.0\.bias$|upconv_\d\.conv\.0\.bias$")
DOSE_TOL = 1e-3 * 70.0
# the port's float32 HD-UNet step against the float64 gradient, each leaf by its max |g|
PORT32_OF_EXACT = 1e-3
NOISE_RUNS = 3      # HD-UNet trainer: the port's fit is ~2 s, its spread worth sampling


# torch threads of the HD-UNet step (``hdunet_step``) and of the test that
# holds its float32 gradient against the exact one: a reduction's order
# follows the thread count, so the step's rounding is fixed by this number,
# not by the thread count a test worker meets
STEP_THREADS = 8


@contextlib.contextmanager
def torch_threads(n):
    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU work in one thread, test by test (tests/torch_threads.py
    says why). Function-scoped, unlike that module's: ``hdunet_step``, a
    module fixture, computes the port's float32 gradient in STEP_THREADS
    threads, the order under which ``test_simple_dose_step_is_exact_in_float64``
    holds it within 1e-3 of the exact gradient (4.54e-4); in one thread its
    sums take another order and flip a ReLU input, as the JAX package's
    float32 step does, and the port's departure is 2.34e-3."""
    with torch_threads(1):
        yield


def port_hdunet(seed=0):
    return M.seeded(HDUNet(device="cpu", **HD), seed)


@contextlib.contextmanager
def plane_scaled_noise(seed, amplitude):
    """Each InstanceNorm output plus amplitude · u · its plane's largest
    |value| (u seeded uniform in [-1, 1], kept out of the gradient): the
    module docstring's noise run for HD-UNet."""
    g = torch.Generator().manual_seed(seed)
    forward = InstanceNorm3d.forward

    def noisy(self, inp):
        out = forward(self, inp)
        u = torch.rand(out.shape, generator=g) * 2 - 1
        scale = out.detach().abs().amax(dim=(2, 3, 4), keepdim=True)
        return out + amplitude * u * scale

    with mock.patch.object(InstanceNorm3d, "forward", noisy):
        yield


def hdunet_noise_run(variables, x, gt):
    """The port's HD-UNet gradients from the same weights under
    plane_scaled_noise(0, 1e-6)."""
    twin = HDUNet(device="cpu", **HD)
    twin.load_state_dict(weights.jax_to_torch(variables, twin))
    with plane_scaled_noise(0, 1e-6):
        twin.train()
        pred = twin(steps.to_ncdhw(x))
        gtn = steps.to_ncdhw(gt)
        steps.L.masked_l1(pred, gtn[:, 0:1], gtn[:, 1:2]).backward()
    return {n: p.grad for n, p in twin.named_parameters()}


@pytest.fixture(scope="module")
def hdunet_step(cohort):  # noqa: F811
    """One packed HD-UNet step in both packages from the same weights, and the
    port's noise run: (variables, unpacked batch, port grads, port loss,
    JAX grads, JAX loss, noise-run grads), the port's in STEP_THREADS
    threads."""
    with torch_threads(STEP_THREADS):
        return _hdunet_step(cohort)


def _hdunet_step(cohort):  # noqa: F811
    pb, jb = batches(cohort)
    model = port_hdunet(seed=1)
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    target = jax.eval_shape(JHDUNet(**HD).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, SIZE, SIZE, SIZE, 9), np.float32))
    variables, stats = TI.import_hdunet(sd, target, verbose=False)
    assert stats["missing"] == 0 and stats["unused"] == 0
    variables = jax.tree_util.tree_map(np.asarray, variables)
    jstep = JSTEP.make_simple_dose_train_step(JHDUNet(**HD), keep_gradients(), packed=True)
    jstate, jloss = jstep(JS.create_train_state(variables, keep_gradients()), jb)
    want = weights.jax_to_torch({"params": jax.tree_util.tree_map(np.asarray, jstate.opt_state)},
                                model)
    opt = S.make_optimizer(model, learning_rate=1e-3)
    state, loss = steps.make_simple_dose_train_step(model, opt, packed=True)(
        S.TrainState(model, opt), pb)
    assert state.step == 1
    grads = {n: p.grad for n, p in model.named_parameters()}
    unpacked = PK.unpack_dose_batch(pb)
    noisy = hdunet_noise_run(variables, unpacked["input"], unpacked["gt"])
    return variables, unpacked, grads, float(loss), want, float(jloss), noisy


def test_simple_dose_step_matches_jax(hdunet_step):
    _, _, grads, loss, want, jloss, noisy = hdunet_step
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    zero = [n for n in grads if ZERO_GRAD_HDUNET.search(n)]
    assert len(zero) == 16 + 12          # 16 encoder SingleConvs, 4 upconvs + 8 decoder convs
    g_max = max(float(want[n].abs().max()) for n in grads)
    leaves = [n for n in grads if n not in zero]
    scale = {n: float(want[n].abs().max()) for n in leaves}
    noise = {n: float((noisy[n] - grads[n]).abs().max()) / scale[n] for n in leaves}
    rel = {n: float((grads[n] - want[n]).abs().max()) / scale[n] for n in leaves}
    print(f"HD-UNet step: worst leaf err / its max|g| {max(rel.values()):.3g}, noise run "
          f"{max(noise.values()):.3g}; {sum(r > 1e-3 for r in rel.values())} of {len(leaves)} "
          "over 1e-3")
    for n in leaves:
        assert rel[n] * scale[n] <= max(max(1e-3, 2 * noise[n]) * scale[n], 2e-6 * g_max), n
    for n in zero:
        assert max(float(grads[n].abs().max()), float(want[n].abs().max())) <= 1e-4 * g_max, n


def port_in64(self, x):
    """InstanceNorm3d in float64 (the port's statistics are float32)."""
    mean = x.mean(dim=(2, 3, 4), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3, 4), keepdim=True)
    return ((x - mean) * torch.rsqrt(var + self.eps) * self.weight.reshape(1, -1, 1, 1, 1)
            + self.bias.reshape(1, -1, 1, 1, 1))


def port_resize64(x, out_size, *, mode, align_corners=False):
    """ops.resize.resize3d without its float32 cast."""
    return torch.nn.functional.interpolate(x, size=tuple(out_size), mode=mode,
                                           align_corners=align_corners)


def jax_in64(x, scale, bias, *, eps):
    mean = jnp.mean(x, axis=(1, 2, 3), keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=(1, 2, 3), keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + eps) * scale + bias


def jax_resize64(x, out_size, *, mode, align_corners=False):
    """Trilinear align_corners resize, its interpolation matrices in float64
    (the JAX package builds them in float32)."""
    assert mode == "trilinear" and align_corners
    for axis, out in zip((1, 2, 3), out_size):
        n = x.shape[axis]
        src = np.arange(out) * (n - 1) / max(out - 1, 1)
        lo = np.floor(src).astype(np.int64)
        m = np.zeros((out, n))
        np.add.at(m, (np.arange(out), lo), 1.0 - (src - lo))
        np.add.at(m, (np.arange(out), np.minimum(lo + 1, n - 1)), src - lo)
        x = jnp.moveaxis(jnp.tensordot(jnp.asarray(m), x, axes=([1], [axis])), 0, axis)
    return x


def masked_l1_64(pred, gt, mask):
    """The masked L1 without the float32 cast of either package's loss."""
    return (abs(pred - gt) * (mask > 0)).sum() / (mask > 0).sum()


def test_simple_dose_step_is_exact_in_float64(hdunet_step):
    """Both packages' HD-UNet gradients in float64 (each package's float32
    islands, the InstanceNorm statistics, the conv bias, the resize and the
    loss, taken to float64 the same way) agree leaf by leaf, and the port's float32 step
    sits close to them: the float32 packages differ by rounding that flips
    a ReLU input near 0 (module docstring), not by a fault of either. In
    STEP_THREADS threads, as ``hdunet_step`` computed the step."""
    with torch_threads(STEP_THREADS):
        _exact_in_float64(hdunet_step)


def _exact_in_float64(hdunet_step):
    from dose_prediction_tpu import ops as jops
    from dose_prediction_tpu.core.config import FLAGS
    from dose_prediction_tpu.ops import conv as jconv
    from dose_prediction_tpu.ops import resize as jresize

    from dose_prediction_tpu_torch.ops import conv as pconv
    from dose_prediction_tpu_torch.ops import resize as presize

    variables, unpacked, grads, _, want, _, _ = hdunet_step
    x, gt = unpacked["input"].double(), unpacked["gt"].double()
    twin = HDUNet(device="cpu", **HD)
    twin.load_state_dict(weights.jax_to_torch(variables, twin))
    twin.double().train()
    with mock.patch.object(InstanceNorm3d, "forward", port_in64), \
            mock.patch.object(presize, "resize3d", port_resize64), \
            mock.patch.object(pconv, "_biased", lambda conv, x, w, b, **kw: conv(x, w, b, **kw)):
        gtn = steps.to_ncdhw(gt)
        masked_l1_64(twin(steps.to_ncdhw(x)), gtn[:, 0:1], gtn[:, 1:2]).backward()
    port64 = {n: p.grad for n, p in twin.named_parameters()}

    model = JHDUNet(dtype=jnp.float64, **HD)

    def loss_fn(params, x, gt):
        return masked_l1_64(model.apply({"params": params}, x), gt[..., 0:1], gt[..., 1:2])

    with jax.enable_x64(True), mock.patch.object(jops, "instance_norm", jax_in64), \
            mock.patch.dict(jconv.conv3d.__kwdefaults__, {"accum_dtype": jnp.float64}), \
            mock.patch.object(jresize, "resize3d", jax_resize64), \
            mock.patch.object(FLAGS, "pallas_instance_norm_for", lambda *a: False):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        variables["params"])
        g64 = jax.jit(jax.grad(loss_fn))(params, jnp.asarray(x.numpy()), jnp.asarray(gt.numpy()))
        jax64 = {n: torch.from_numpy(np.asarray(v)) for n, v in weights.jax_to_torch(
            {"params": jax.tree_util.tree_map(np.asarray, g64)}, twin).items()}
    leaves = [n for n in port64 if not ZERO_GRAD_HDUNET.search(n)]
    scale = {n: float(jax64[n].abs().max()) for n in leaves}

    def departure(g):
        return {n: float((g[n].double() - jax64[n]).abs().max()) / scale[n] for n in leaves}

    exact, port32, jax32 = departure(port64), departure(grads), departure(want)
    print(f"HD-UNet step, worst leaf departure from the JAX package's float64 gradient / its "
          f"max|g|: the port's float64 {max(exact.values()):.3g}, the port's float32 "
          f"{max(port32.values()):.3g}, the JAX package's float32 {max(jax32.values()):.3g}")
    g_max = max(scale.values())
    for n in leaves:
        assert exact[n] <= 1e-9, n
        assert port32[n] <= PORT32_OF_EXACT, n
    for n in port64:
        if n not in scale:
            assert max(float(port64[n].abs().max()), float(jax64[n].abs().max())) \
                <= 1e-9 * g_max, n


def test_simple_dose_eval_step_batched_matches_its_single_rows(cohort):  # noqa: F811
    """``batch['valid']``: the validity-weighted means of the rows' own
    losses and scores (pad rows weighted 0)."""
    pb, _ = batches(cohort)
    b = PK.unpack_dose_batch(pb)
    model = port_hdunet(seed=2)
    ev = steps.make_simple_dose_eval_step(model)
    single = ev(b)
    pair = {"input": torch.cat([b["input"], b["input"].flip(1)]),
            "gt": torch.cat([b["gt"], b["gt"]]), "valid": torch.tensor([1.0, 0.0])}
    batched = ev(pair)
    assert float(batched["n_valid"]) == 1.0
    assert abs(float(batched["val_loss_mean"]) - float(single["val_loss"])) <= 1e-6
    assert abs(float(batched["dose_score_mean"]) - float(single["dose_score"])) <= 1e-4
    assert single["prediction"].shape == (1, SIZE, SIZE, SIZE, 1)


def assert_moves_by_noise_rule(init, port, noisy_runs, jax_final, zero_grad, lr, updates):
    """tests/test_torch_port_trainers.py's parameter rule; a model without
    zero-gradient biases (``zero_grad`` None) has none to hold."""
    if zero_grad is not None:
        TR.assert_params_by_noise_rule(init, port, noisy_runs, jax_final, zero_grad, lr,
                                       updates)
        return
    names = [n for n in init if not n.endswith("num_batches_tracked")]
    move = {n: float(np.abs(jax_final[n] - init[n]).max()) for n in names}
    names = [n for n in names if move[n] > 0]
    largest = max(move.values())
    noise = max(float(np.abs(noisy[n] - port[n]).max()) / move[n]
                for noisy in noisy_runs for n in names)
    print(f"noise run {noise:.3g}")
    for n in names:
        err = float(np.abs(port[n] - jax_final[n]).max())
        assert err <= max(max(1e-3, 2 * noise) * move[n], 2e-6 * largest), (n, err, noise)
    assert len(names) > 20


def initialized(jax_cls, variables, **fields):
    """A JAX model whose ``init`` returns ``variables``: the JAX trainer
    starts from the port's seeded weights, without compiling the JAX
    model's own random initialisation (about 20 s for HD-UNet here)."""
    class Initialized(jax_cls):
        def init(self, *args, **kwargs):
            return variables

    return Initialized(**fields)


def one_step_epochs(tmp_path, tag):
    """TR.configs with three epochs of one step, validated after the last."""
    jcfg, cfg = TR.configs(tmp_path, tag, samples_per_epoch=1)
    jcfg.max_epochs = cfg.max_epochs = jcfg.check_val = cfg.check_val = 3
    return jcfg, cfg


def test_hdunet_trainer_matches_jax(tmp_path, cohort32):  # noqa: F811
    ds, jds = cohort32
    jcfg, cfg = one_step_epochs(tmp_path, "h")
    seeded = port_hdunet(seed=3)
    target = jax.eval_shape(JHDUNet(**HD).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct(TR.SHAPE32, np.float32))
    variables, _ = TI.import_hdunet({k: v.numpy().copy() for k, v in seeded.state_dict().items()},
                                    target, verbose=False)
    jtr = JT.HDUNetTrainer(jcfg, model=initialized(JHDUNet, variables, **HD),
                           example_shape=TR.SHAPE32)
    start = TR.variables_of(jtr.state)

    def make(tag):
        model = HDUNet(device="cpu", **HD)
        model.load_state_dict(weights.jax_to_torch(start, model), strict=True)
        return T.HDUNetTrainer(one_step_epochs(tmp_path, tag)[1], model=model,
                               example_shape=TR.SHAPE32)

    tr = make("h")
    init = TR.state_numpy(tr.model)
    batch = next(TR.jax_val_batches(jds))
    amplitude = TR.noise_amplitude(
        tr.eval_step({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        ["prediction"], jtr.eval_step(jtr.state.params, batch)[2])
    assert TR.rel_close([tr.validate(ds)[k] for k in ("mean_dose_score", "val_loss")],
                        [jtr.validate(jds)[k] for k in ("mean_dose_score", "val_loss")],
                        TR.REL_EPOCH)
    scores = ("mean_dose_score", "mean_dvh_score")
    TR.assert_close_dict(tr.test(ds), jtr.test(jds), scores, TR.REL_TEST)
    jtr.fit(jds, jds, resume=False)
    tr.fit(ds, ds, resume=False)
    assert tr.state.step == int(jtr.state.step) == 3
    runs = []
    for seed in range(NOISE_RUNS):
        twin = make(f"noise{seed}")
        with plane_scaled_noise(seed, amplitude):
            twin.fit(ds, ds, resume=False)
        runs.append((TR.state_numpy(twin.model), TR.records(twin.cfg.log_dir)))
    port, ref = TR.records(cfg.log_dir), TR.records(jcfg.log_dir)
    TR.check_epochs(port, ref, runs, "train_mean_loss", ("mean_dose_score", "val_loss"))
    assert_moves_by_noise_rule(init, TR.state_numpy(tr.model), [r for r, _ in runs],
                               TR.jax_state_numpy(jtr.state, tr.model), ZERO_GRAD_HDUNET,
                               cfg.learning_rate, 3)
    tr.model.load_state_dict(weights.jax_to_torch(TR.variables_of(jtr.state), tr.model))
    assert TR.rel_close(tr.validate(ds)["mean_dose_score"], ref["mean_dose_score"][-1],
                        TR.REL_EPOCH)
    TR.assert_close_dict(tr.test(ds), jtr.test(jds), scores, TR.REL_TEST)


def validated_at_the_end(jcfg, cfg):
    jcfg.check_val = cfg.check_val = cfg.max_epochs
    return jcfg, cfg


def test_unetr_seg_trainer_matches_jax(tmp_path, cohort32):  # noqa: F811
    ds, jds = cohort32
    jcfg, cfg = validated_at_the_end(*TR.configs(tmp_path, "u", batch_size=2))
    crop = (TR.SIZE32,) * 3
    seeded = M.seeded(CLI.default_unetr_model(small=True, img_size=crop, device="cpu"), seed=4)
    target = jax.eval_shape(JUNETR(out_ch=8, **M.CFG).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, *crop, 1), np.float32))
    variables, _ = TI.import_unetr({k: v.numpy().copy() for k, v in seeded.state_dict().items()},
                                   target, verbose=False)
    jtr = JT.UNETRSegTrainer(jcfg, model=initialized(JUNETR, variables, out_ch=8, **M.CFG),
                             crop=crop)
    start = TR.variables_of(jtr.state)

    def make(tag):
        model = CLI.default_unetr_model(small=True, img_size=crop, device="cpu")
        model.load_state_dict(weights.jax_to_torch(start, model), strict=True)
        return T.UNETRSegTrainer(validated_at_the_end(*TR.configs(tmp_path, tag,
                                                                  batch_size=2))[1],
                                 model=model, crop=crop)

    tr = make("u")
    assert isinstance(tr, T.TranSegTrainer)
    init = TR.state_numpy(tr.model)
    ct = jds.patients[0].ct[None, ..., None]
    with torch.no_grad():
        port_logits = tr.model.eval()(torch.from_numpy(np.ascontiguousarray(
            ct.transpose(0, 4, 1, 2, 3))))
    jax_logits = jtr.model.apply(start, ct, train=False)
    amplitude = TR.noise_amplitude(port_logits.numpy(),
                                   np.asarray(jax_logits).transpose(0, 4, 1, 2, 3))
    assert TR.rel_close(tr.validate(ds, sw_batch_size=2), jtr.validate(jds, sw_batch_size=2),
                        TR.REL_EPOCH)
    jtr.fit(jds, jds, num_samples=2, resume=False)
    tr.fit(ds, ds, num_samples=2, resume=False)
    runs = TR.noise_runs(make, lambda t: t.fit(ds, ds, num_samples=2, resume=False), amplitude)
    port, ref = TR.records(cfg.log_dir), TR.records(jcfg.log_dir)
    TR.check_epochs(port, ref, runs, "train_loss", ("val_loss", "dice_metric"))
    assert_moves_by_noise_rule(init, TR.state_numpy(tr.model), [r for r, _ in runs],
                               TR.jax_state_numpy(jtr.state, tr.model), None,
                               cfg.learning_rate, int(jtr.state.step))
    tr.model.load_state_dict(weights.jax_to_torch(TR.variables_of(jtr.state), tr.model))
    got = tr.validate(ds, sw_batch_size=2)
    assert TR.rel_close(got, (ref["dice_metric"][-1], ref["hd95_metric"][-1],
                              ref["val_loss"][-1]), TR.REL_EPOCH), (got, ref)


@pytest.mark.parametrize("family,k7_mode", [("old", "dense"), ("ablation", "separable")])
def test_transseg_trainer_builds_each_family(family, k7_mode):
    cfg = T.TrainConfig(device="cpu")
    with mock.patch.object(T, "TranSeg", lambda **kw: TranSeg(
            **{**kw, "feature_size": 2, "hidden_size": 24, "mlp_dim": 48, "num_layers": 4,
               "num_heads": 2})):
        tr = T.TranSegTrainer(cfg, crop=(32,) * 3, block_family=family, k7_mode=k7_mode)
    assert (tr.model.config["block_family"], tr.model.config["k7_mode"]) == (family, k7_mode)
    assert any(isinstance(m, torch.nn.BatchNorm3d) for m in tr.model.decoder2.modules())


# -- LinkedModel ------------------------------------------------------------------

ROI = 16


@pytest.fixture(scope="module")
def linked(tmp_path_factory):
    """The synthetic cohort in both packages and the same seeded small
    models (an 'old'-family TranSeg over 16³ windows, DOSE-PYFER at 32³)."""
    pattern = make_synthetic_dataset(tmp_path_factory.mktemp("linked"), n_patients=2,
                                     shape=(SIZE,) * 3, seed=11)
    with mock.patch.object(TR.JN, "get_lib", lambda: None):
        jds = JDataset(pattern, keep_structures=True, num_workers=1)
    ds = OpenKBPDataset(pattern, keep_structures=True, num_workers=1)
    seg = M.seeded(TranSeg(out_ch=8, img_size=ROI, block_family="old", device="cpu", **M.CFG),
                   seed=12)
    dose = M.port_dose(img=SIZE, seed=13)
    from dose_prediction_tpu import models as jmodels

    jseg = jmodels.TranSeg(out_ch=8, block_family="old", **M.CFG)
    seg_vars, _ = M.to_jax(seg, jseg, TI.import_transeg, (1, ROI, ROI, ROI, 1))
    dose_vars, _ = M.to_jax(dose, M.jax_dose(), TI.import_pyfer, (1, SIZE, SIZE, SIZE, 9))
    jlinked = JLinkedModel(seg_model=jseg, dose_model=M.jax_dose(), seg_variables=seg_vars,
                           dose_variables=dose_vars, roi_size=(ROI,) * 3)
    return ds, jds, seg, dose, jlinked


def test_linked_model_matches_jax(linked, tmp_path):
    ds, jds, seg, dose, jlinked = linked
    port = LinkedModel(seg, dose, roi_size=(ROI,) * 3)
    for p, jp in zip(ds.patients, jds.patients):
        got, want = port.predict_patient(p), np.asarray(jlinked.predict_patient(jp))
        assert got.shape == want.shape == (SIZE,) * 3 and np.count_nonzero(want) > 0
        assert np.abs(got - want).max() <= DOSE_TOL
    res = port.evaluate(ds, log_dir=str(tmp_path / "log"))
    jres = jlinked.evaluate(jds)
    assert abs(res["mean_dose_score"] - jres["mean_dose_score"]) <= \
        1e-4 * abs(jres["mean_dose_score"])
    assert set(res["per_patient"]) == set(jres["per_patient"])
    assert len(res["ivs"]) == len(jres["ivs"]) == 101
    logged = json.loads((tmp_path / "log" / "metrics.jsonl").read_text().splitlines()[-1])
    assert logged["mean_dose_metric"] == res["mean_dose_score"]


@pytest.mark.parametrize("seg_mode,serve_dtype", [("sliding", "bfloat16"),
                                                  ("dense", "float32")])
def test_linked_model_runs_make_cascade_fn(linked, seg_mode, serve_dtype):
    """Each prediction bit-equal to make_cascade_fn's on the same weights,
    and the scores the port's metrics on those predictions."""
    ds, _, seg, dose, _ = linked
    grid = (ROI // 16,) * 3 if seg_mode == "dense" else None
    seg_model = TranSeg(out_ch=8, img_size=ROI, block_family="old", trained_grid=grid,
                        device="cpu", **M.CFG)
    seg_model.load_state_dict(seg.state_dict(), strict=True)
    port = LinkedModel(seg_model, dose, roi_size=(ROI,) * 3, seg_mode=seg_mode,
                       serve_dtype=serve_dtype)
    bf16 = serve_dtype == "bfloat16"
    run = make_cascade_fn(seg_model, seg_model.state_dict(), dose, dose.state_dict(),
                          roi_size=(ROI,) * 3, seg_mode=seg_mode,
                          input_dtype=torch.bfloat16 if bf16 else None)
    scores = []
    for p in ds.patients:
        want = run(*(torch.from_numpy(a[None, ..., None]) for a in (p.ct, p.ptv, p.dose_mask)))
        assert want.dtype == (torch.bfloat16 if bf16 else torch.float32)
        want = want.float().numpy()[0, ..., 0]
        assert np.array_equal(port.predict_patient(p), want)
        scores.append(EM.dose_score(want, p.real_dose, p.dose_mask))
    assert port.evaluate(ds, with_ivs=False)["mean_dose_score"] == float(np.mean(scores))


# -- the CLI ----------------------------------------------------------------------------

def small(*argv):
    return ["--device", "cpu", *argv, "--model-size", "small"]


def run_cli(argv, capsys):
    rc = CLI.main(argv)
    out = capsys.readouterr().out
    start = out.rfind("\n{\n")
    start = 0 if out.startswith("{") else start + 1
    return rc, json.loads(out[start:])


@pytest.fixture(scope="module")
def cli_cohort(tmp_path_factory):
    """A 16³ synthetic cohort and a small DOSE-PYFER slot trained on it."""
    root = tmp_path_factory.mktemp("zoo_cli")
    pattern = make_synthetic_dataset(root / "data", n_patients=2, shape=(16,) * 3, seed=5)
    assert CLI.main(small("train", "pyfer", "--data", pattern, "--epochs", "1",
                          "--ckpt-dir", str(root / "pyfer"), "--log-dir",
                          str(root / "pyfer_log"))) == 0
    return root, pattern


def test_cli_trains_evaluates_and_predicts_hdunet(cli_cohort, capsys):
    root, pattern = cli_cohort
    common = ("--data", pattern, "--ckpt-dir", str(root / "hd"), "--log-dir", str(root / "hl"))
    assert CLI.main(small("train", "hdunet", *common, "--val-data", pattern, "--epochs", "2",
                          "--check-val", "1")) == 0
    slot = restore_checkpoint(root / "hd" / "last.pt")
    assert slot["step"] == 4 and json.loads((root / "hd" / "run_config.json").read_text())[
        "models"][0]["model"] == "HDUNet"
    capsys.readouterr()
    evaluate = small("eval", "--model", "hdunet", "--ckpt", str(root / "hd" / "last.pt"),
                     *common)
    rc, host = run_cli(evaluate, capsys)
    rc2, device = run_cli(evaluate + ["--device-metrics"], capsys)
    assert rc == rc2 == 0 and np.isfinite(host["mean_dose_score"])
    assert abs(device["mean_dose_score"] - host["mean_dose_score"]) <= \
        1e-4 * abs(host["mean_dose_score"])
    assert CLI.main(small("predict", "--model", "hdunet", "--ckpt",
                          str(root / "hd" / "last.pt"), "--out-dir", str(root / "hd_pred"),
                          *common)) == 0
    assert sorted(p.name for p in (root / "hd_pred").iterdir()) == ["pt_0", "pt_1"]


def test_cli_trains_and_scores_the_plain_unetr(cli_cohort, capsys):
    root, pattern = cli_cohort
    common = ("--data", pattern, "--roi", "16", "--ckpt-dir", str(root / "un"), "--log-dir",
              str(root / "ul"))
    assert CLI.main(small("train", "transeg", "--mode-model", "0", "--epochs", "1",
                          *common)) == 0
    assert json.loads((root / "un" / "run_config.json").read_text())["models"][0][
        "model"] == "UNETR"
    capsys.readouterr()
    rc, res = run_cli(small("seg-eval", "--mode-model", "0", "--ckpt",
                            str(root / "un" / "last.pt"), *common), capsys)
    assert rc == 0 and np.isfinite(res["val_loss"]) and 0 <= res["dice_metric"] <= 1
    # a UNETR slot is not a TranSeg: the seg-eval of --mode-model 1 names the mismatch
    with pytest.raises(SystemExit, match="UNETR|missing"):
        CLI.main(small("seg-eval", "--ckpt", str(root / "un" / "last.pt"), *common))


@pytest.mark.parametrize("flags", [
    ("--block-family", "old"), ("--block-family", "ablation"), ("--k7-mode", "separable"),
    ("--mode-model", "0")], ids=["old", "ablation", "separable", "unetr"])
def test_cli_trains_each_seg_choice_and_infers_with_it(cli_cohort, tmp_path, flags):
    """train transeg with the choice, then infer (bf16, sliding) with the
    slot: the NIfTI make_cascade_fn gives from the same restored weights."""
    root, pattern = cli_cohort
    ck = tmp_path / "seg"
    assert CLI.main(small("train", "transeg", *flags, "--data", pattern, "--epochs", "1",
                          "--max-steps", "1", "--roi", "16", "--ckpt-dir", str(ck),
                          "--log-dir", str(tmp_path / "log"))) == 0
    out = tmp_path / "dose.nii.gz"
    patient = root / "data" / "pt_0"
    assert CLI.main(small("infer", *flags, "--patient", str(patient), "--seg-ckpt",
                          str(ck / "last.pt"), "--dose-ckpt", str(root / "pyfer" / "last.pt"),
                          "--roi", "16", "--out", str(out), "--serve-dtype", "bfloat16")) == 0
    opts = dict(zip(flags[::2], flags[1::2]))
    if opts.get("--mode-model") == "0":
        seg = CLI.default_unetr_model(small=True, img_size=(16,) * 3, device="cpu")
    else:
        seg = CLI.default_seg_model(small=True, img_size=(16,) * 3, device="cpu",
                                    block_family=opts.get("--block-family", "seg"),
                                    k7_mode=opts.get("--k7-mode", "dense"))
    p = load_patient(str(patient))
    dose = CLI.default_flagship_model(small=True, img_size=p.ct.shape, device="cpu")
    seg.load_state_dict(restore_checkpoint(ck / "last.pt")["model"])
    dose.load_state_dict(restore_checkpoint(root / "pyfer" / "last.pt")["model"])
    run = make_cascade_fn(seg, seg.state_dict(), dose, dose.state_dict(), roi_size=(16,) * 3,
                          sw_batch_size=8, input_dtype=torch.bfloat16)
    want = run(*(torch.from_numpy(a[None, ..., None]) for a in (p.ct, p.ptv, p.dose_mask)))
    from dose_prediction_tpu_torch.data.nifti import read_nifti

    assert np.array_equal(read_nifti(out).data, want.float().numpy()[0, ..., 0])


@pytest.mark.parametrize("kind", ["transeg", "unetr", "hdunet"])
def test_cli_imports_reference_checkpoints(cli_cohort, tmp_path, kind, capsys):
    """The reference-layout replicas, under their Lightning prefixes, into
    slots holding exactly their state dicts; a source with an entry
    missing fails."""
    root, pattern = cli_cohort
    torch.manual_seed(8)
    with mock.patch.object(GT, "OUT_CH", 8):      # the CLI's seg models have 8 classes
        replica, prefix = {"transeg": (lambda: GT._TranSeg("old"), "_model."),
                           "unetr": (GT._UNETR, "model."),
                           "hdunet": (lambda: GH._torch_hdunet(in_ch=9, g=4, up=8),
                                      "model_.model.")}[kind]
        replica = replica()
    src = tmp_path / "ref.ckpt"
    torch.save({"state_dict": {prefix + k: v for k, v in replica.state_dict().items()}}, src)
    dest = tmp_path / "imported.pt"
    argv = small("import-torch", "--kind", kind, "--src", str(src), "--dest", str(dest),
                 "--roi", str(GT.SIZE))
    assert CLI.main(argv) == 0
    slot = restore_checkpoint(dest)
    assert set(slot) == set(replica.state_dict())
    assert all(torch.equal(slot[k], v) for k, v in replica.state_dict().items())
    if kind == "hdunet":
        capsys.readouterr()
        rc, res = run_cli(small("eval", "--model", "hdunet", "--data", pattern, "--ckpt",
                                str(dest), "--ckpt-dir", str(tmp_path / "ck"), "--log-dir",
                                str(tmp_path / "log")), capsys)
        assert rc == 0 and np.isfinite(res["mean_dose_score"])
    sd = dict(replica.state_dict())
    del sd[sorted(sd)[-1]]
    torch.save(sd, src)
    with pytest.raises(SystemExit, match="1 missing"):
        CLI.main(argv)


@pytest.mark.parametrize("seg_mode", ["sliding", "dense"])
def test_cli_linked_eval_scores_make_cascade_fns_predictions(cli_cohort, tmp_path, seg_mode,
                                                             capsys):
    root, pattern = cli_cohort
    ck = tmp_path / "old"
    assert CLI.main(small("train", "transeg", "--block-family", "old", "--data", pattern,
                          "--epochs", "1", "--max-steps", "1", "--roi", "16", "--ckpt-dir",
                          str(ck), "--log-dir", str(tmp_path / "log"))) == 0
    capsys.readouterr()
    rc, res = run_cli(small("linked-eval", "--block-family", "old", "--data", pattern,
                            "--seg-ckpt", str(ck / "last.pt"), "--dose-ckpt",
                            str(root / "pyfer" / "last.pt"), "--roi", "16", "--seg-mode",
                            seg_mode, "--serve-dtype", "bfloat16", "--ckpt-dir",
                            str(tmp_path / "x"), "--log-dir", str(tmp_path / "xl")), capsys)
    assert rc == 0
    grid = (1, 1, 1) if seg_mode == "dense" else None
    seg = CLI.default_seg_model(small=True, img_size=(16,) * 3, block_family="old",
                                trained_grid=grid, device="cpu")
    seg.load_state_dict(restore_checkpoint(ck / "last.pt")["model"])
    dose = CLI.default_flagship_model(small=True, img_size=(16,) * 3, device="cpu")
    dose.load_state_dict(restore_checkpoint(root / "pyfer" / "last.pt")["model"])
    run = make_cascade_fn(seg, seg.state_dict(), dose, dose.state_dict(), roi_size=(16,) * 3,
                          seg_mode=seg_mode, input_dtype=torch.bfloat16)
    scores = []
    for p in OpenKBPDataset(pattern, keep_structures=True).patients:
        pred = run(*(torch.from_numpy(a[None, ..., None]) for a in
                     (p.ct, p.ptv, p.dose_mask))).float().numpy()[0, ..., 0]
        scores.append(EM.dose_score(pred, p.real_dose, p.dose_mask))
    assert res["mean_dose_score"] == float(np.mean(scores))
    assert set(res) == {"mean_dose_score", "std_dose_score", "mean_dvh_score"}
