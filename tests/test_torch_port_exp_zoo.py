"""The port's experiments zoo models (dose_prediction_tpu_torch/models/experiments.py:
SharedEncoderModel, ExperimentalCascade, SharedUNetModel, SharedUNetRModelA,
SharedUNetRModel, ModelMonai) against the JAX package's on the CPU, float32,
at the sizes of tests/test_torch_port_exp_models.py, whose helpers carry
the weights (the port's key map, weights.walk_key_map; no JAX importer
exists for these models) and hold the forwards within 1e-3, in eval and in
train mode where the model has BatchNorm.

ExperimentalCascade with the attention decoders in train mode is held
against float64 instead: at these widths its train-mode BatchNorms over
planes of 2³-16³ voxels amplify float32 rounding, and the JAX package's
float32 output lies up to 7e-3 from the float64 one. Both packages run in
float64 (their float32 statistics, resizes and conv accumulations taken to
float64, as tests/test_torch_port_zoo_train.py does) and agree within 1e-9
of the output's scale; the port's float32 output must lie within 1e-3 of
that float64 output.
"""

from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu.models import experiments as JE  # noqa: E402

from dose_prediction_tpu_torch.models import experiments as E  # noqa: E402

import test_torch_port_models as M  # noqa: E402
from test_torch_port_exp_models import (  # noqa: E402
    DEV,
    LIST_CH,
    SIZE,
    TOL,
    VIT,
    check_forward,
    flat,
    round_trips,
    same_leaves,
    target,
    to_jax,
    volume,
)
from test_torch_port_zoo_train import jax_in64, jax_resize64  # noqa: E402

# -- the zoo's models ----------------------------------------------------------

MODELS = {
    "SharedEncoderModel": (
        lambda: E.SharedEncoderModel(img_size=SIZE, feature_size_a=2, feature_size_b=4, **VIT,
                                     device=DEV),
        lambda: JE.SharedEncoderModel(feature_size_a=2, feature_size_b=4, **VIT), 9),
    "ExperimentalCascade-1-3-2-5": (
        lambda: E.ExperimentalCascade(list_ch_A=LIST_CH, list_ch_B=LIST_CH, mode_encoder_A=1,
                                      mode_decoder_A=3, mode_encoder_B=2, mode_decoder_B=5,
                                      device=DEV),
        lambda: JE.ExperimentalCascade(list_ch_A=LIST_CH, list_ch_B=LIST_CH, mode_encoder_A=1,
                                       mode_decoder_A=3, mode_encoder_B=2, mode_decoder_B=5), 9),
    "ExperimentalCascade-2-4-1-1": (
        lambda: E.ExperimentalCascade(list_ch_A=LIST_CH, list_ch_B=LIST_CH, mode_encoder_A=2,
                                      mode_decoder_A=4, device=DEV),
        lambda: JE.ExperimentalCascade(list_ch_A=LIST_CH, list_ch_B=LIST_CH, mode_encoder_A=2,
                                       mode_decoder_A=4), 9),
    "SharedUNetModel-1-1": (
        lambda: E.SharedUNetModel(list_ch=LIST_CH + (64,), device=DEV),
        lambda: JE.SharedUNetModel(list_ch=LIST_CH + (64,)), 9),
    "SharedUNetModel-2-2": (
        lambda: E.SharedUNetModel(list_ch=LIST_CH + (64,), mode_encoder=2, mode_decoder=2,
                                  device=DEV),
        lambda: JE.SharedUNetModel(list_ch=LIST_CH + (64,), mode_encoder=2, mode_decoder=2), 9),
    "SharedUNetRModelA": (
        lambda: E.SharedUNetRModelA(img_size=SIZE, feature_size=2, **VIT, device=DEV),
        lambda: JE.SharedUNetRModelA(feature_size=2, **VIT), 9),
    "SharedUNetRModel": (
        lambda: E.SharedUNetRModel(in_ch_b=11, img_size=SIZE, feature_size=2,
                                   **{**VIT, "num_layers": 12}, device=DEV),
        lambda: JE.SharedUNetRModel(in_ch_b=11, feature_size=2, **{**VIT, "num_layers": 12}),
        9),
    "ModelMonai": (
        lambda: E.ModelMonai(feat_ch_a=2, channels_a=(2, 4, 8, 16, 32),
                             channels_b=(2, 4, 8, 16, 32), device=DEV),
        lambda: JE.ModelMonai(feat_ch_a=2, channels_a=(2, 4, 8, 16, 32),
                              channels_b=(2, 4, 8, 16, 32)), 9),
}
# models with BatchNorm held in train mode here (the attention-decoder
# cascade's: test_experimental_cascade_train_mode_is_exact_in_float64)
WITH_BATCH_NORM = {"SharedUNetModel-2-2", "ExperimentalCascade-2-4-1-1"}


@pytest.mark.parametrize("name", MODELS)
def test_zoo_model_matches_jax(name):
    make, make_jax, channels = MODELS[name]
    port, jm = M.seeded(make(), seed=4), make_jax()
    x = volume(channels, seed=4)
    takes_train = name not in ("ModelMonai",)
    variables = to_jax(port)
    want = target(jm, x, train=False if takes_train else None)
    assert same_leaves(variables, want)
    round_trips(port, variables)
    if takes_train:
        check_forward(port, jm, variables, x, train_modes=(False, True)
                      if name in WITH_BATCH_NORM else (False,))
    else:
        with torch.no_grad():
            got = flat(port(M.ncdhw(x)))
        errs = [M.max_err(w, g) for w, g in zip(flat(jm.apply(variables, x)), got)]
        print(f"{name}: max abs err by output {errs}")
        assert max(errs) <= TOL


def test_shared_unetr_checks_its_stage_b_channels():
    port = E.SharedUNetRModel(in_ch_b=12, img_size=SIZE, feature_size=2,
                              **{**VIT, "num_layers": 12}, device=DEV)
    with pytest.raises(ValueError, match="in_ch_b"):
        port(torch.zeros(1, 9, SIZE, SIZE, SIZE))


def test_pyramid_decoder_takes_skip_channels_only_in_its_plain_stages():
    """PyMSCDecoder's ``skip_ch`` (skips narrower than the stages, as
    SharedEncoderModel's) builds plain UnetrUpBlock stages of those widths
    and is refused with the ModifiedUnetrUpBlock stages."""
    from dose_prediction_tpu_torch.models.dose_pyfer import PyMSCDecoder

    dec = PyMSCDecoder(2, 24, "mish", mode_multi=False, skip_ch=(3, 5, 7, 9))
    assert [type(getattr(dec, f"decoder{i}")).__name__ for i in range(1, 5)] == \
        ["UnetrUpBlock"] * 4
    # stage i joins its own width (2·2^(i-1)) and the skip's
    assert [getattr(dec, f"decoder{i}").conv_block.conv1.conv.weight.shape[1]
            for i in range(1, 5)] == [2 + 3, 4 + 5, 8 + 7, 16 + 9]
    with pytest.raises(ValueError, match="skip_ch needs the plain decoder"):
        PyMSCDecoder(2, 24, "mish", mode_multi=True, skip_ch=(3, 5, 7, 9))


def test_zoo_full_widths_have_the_jax_leaves():
    """The full-width VitGenerators (ViT-GAN's and the exp model's) and the
    zoo models at their defaults have the JAX models' leaves, shape for
    shape (meta tensors; no weights drawn)."""
    x = jax.ShapeDtypeStruct((1, 128, 128, 128, 9), jnp.float32)
    for port, jm in ((E.vitgan_generator(device="meta"), JE.vitgan_generator()),
                     (E.exp_generator(device="meta"), JE.exp_generator()),
                     (E.SharedEncoderModel(device="meta"), JE.SharedEncoderModel()),
                     (E.ExperimentalCascade(device="meta"), JE.ExperimentalCascade()),
                     (E.SharedUNetRModel(device="meta"), JE.SharedUNetRModel(in_ch_b=25))):
        empty = {k: torch.empty(v.shape) for k, v in port.state_dict().items()}
        assert same_leaves(to_jax(port, empty), target(jm, x)), type(port).__name__


def jax_bn64(x, scale, bias, running_mean, running_var, *, training, momentum=0.1, eps=1e-5):
    """The JAX package's batch_norm without its float32 cast."""
    if training:
        mean = jnp.mean(x, axis=(0, 1, 2, 3))
        var = jnp.mean(jnp.square(x - mean), axis=(0, 1, 2, 3))
        n = x.shape[0] * x.shape[1] * x.shape[2] * x.shape[3]
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * var * (n / max(n - 1, 1))
    else:
        mean, var, new_mean, new_var = running_mean, running_var, running_mean, running_var
    return (x - mean) * jax.lax.rsqrt(var + eps) * scale + bias, new_mean, new_var


_TENSOR_FLOAT = torch.Tensor.float


def _keeps_float64(self, *args, **kwargs):
    """Tensor.float() that leaves a float64 tensor as it is: the port's ops
    then compute their float32 statistics and resizes in float64."""
    return self if self.dtype == torch.float64 else _TENSOR_FLOAT(self, *args, **kwargs)


@pytest.mark.parametrize("name", ["ExperimentalCascade-1-3-2-5"])
def test_experimental_cascade_train_mode_is_exact_in_float64(name):
    from dose_prediction_tpu import ops as jops
    from dose_prediction_tpu.core.config import FLAGS as JFLAGS
    from dose_prediction_tpu.ops import conv as jconv
    from dose_prediction_tpu.ops import resize as jresize

    make, _, channels = MODELS[name]
    port = M.seeded(make(), seed=4).train()
    variables = to_jax(port)
    x = volume(channels, seed=4)
    twin = M.seeded(make(), seed=4).double().train()
    with torch.no_grad():
        got = [o.numpy().transpose(0, 2, 3, 4, 1) for o in flat(port(M.ncdhw(x)))]
        with mock.patch.object(torch.Tensor, "float", _keeps_float64):
            port64 = [o.numpy().transpose(0, 2, 3, 4, 1)
                      for o in flat(twin(M.ncdhw(x).double()))]
    modes = dict(zip(("mode_encoder_A", "mode_decoder_A", "mode_encoder_B", "mode_decoder_B"),
                     (int(m) for m in name.split("-")[1:])))
    jm = JE.ExperimentalCascade(list_ch_A=LIST_CH, list_ch_B=LIST_CH, **modes)
    jm64 = JE.ExperimentalCascade(list_ch_A=LIST_CH, list_ch_B=LIST_CH, dtype=jnp.float64,
                                  **modes)
    jax32 = [np.asarray(o) for o in flat(jm.apply(variables, x, train=True,
                                                  mutable=["batch_stats"])[0])]
    with jax.enable_x64(True), mock.patch.object(jops, "instance_norm", jax_in64), \
            mock.patch.object(jops, "batch_norm", jax_bn64), \
            mock.patch.dict(jconv.conv3d.__kwdefaults__, {"accum_dtype": jnp.float64}), \
            mock.patch.object(jresize, "resize3d", jax_resize64), \
            mock.patch.object(JFLAGS, "pallas_instance_norm_for", lambda *a: False):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jax64 = [np.asarray(o) for o in flat(jm64.apply(v64, jnp.asarray(x, jnp.float64),
                                                        train=True, mutable=["batch_stats"])[0])]
    for i, (g, p64, j32, j64) in enumerate(zip(got, port64, jax32, jax64)):
        scale = float(np.abs(j64).max())
        print(f"{name} output {i}: max|port64 - jax64| {np.abs(p64 - j64).max():.3g}, "
              f"max|port32 - jax64| {np.abs(g - j64).max():.3g}, "
              f"max|jax32 - jax64| {np.abs(j32 - j64).max():.3g} (scale {scale:.3g})")
        assert j64.dtype == np.float64 and float(np.abs(p64 - j64).max()) <= 1e-9 * scale
        assert float(np.abs(g - j64).max()) <= TOL
