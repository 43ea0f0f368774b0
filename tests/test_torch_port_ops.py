"""CPU parity of the PyTorch port's ops, sliding window and post-process
against the JAX package (dose_prediction_tpu_torch/ops, infer, evaluation).

Inputs are made with numpy from a seed and fed to both packages; NDHWC
arrays go to JAX, their NCDHW transposes to the port. Float32 throughout,
max abs error ≤ 1e-5 for single ops unless stated (one op, one rounding
order apart).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu import ops as jops  # noqa: E402
from dose_prediction_tpu.evaluation.metrics import postprocess_prediction_jax  # noqa: E402
from dose_prediction_tpu.infer import sliding_window as jsw  # noqa: E402
from dose_prediction_tpu.nn.vit import patchify as jpatchify  # noqa: E402

from dose_prediction_tpu_torch import ops, resolve_device  # noqa: E402
from dose_prediction_tpu_torch.evaluation.metrics import postprocess_prediction  # noqa: E402
from dose_prediction_tpu_torch.infer import sliding_window as tsw  # noqa: E402
from dose_prediction_tpu_torch.nn.vit import patchify  # noqa: E402

TOL = 1e-5


def to_ncdhw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 4, 1, 2, 3)))


def to_ndhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 4, 1)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


@pytest.fixture
def vol(rng):
    return (rng.standard_normal((2, 6, 5, 7, 3)) * 2 + 0.5).astype(np.float32)


@pytest.mark.parametrize("name", ["relu", "leakyrelu", "mish", "gelu", "sigmoid", "tanh",
                                  "identity"])
def test_act_matches_jax(rng, name):
    x = (rng.standard_normal(1000) * 6).astype(np.float32)
    close(ops.get_act(name)(torch.from_numpy(x)), jops.get_act(name)(jnp.asarray(x)))


def test_get_act_rejects_unknown():
    with pytest.raises(ValueError):
        ops.get_act("swishy")


@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_matches_jax(rng, vol, affine):
    scale = rng.standard_normal(3).astype(np.float32) if affine else None
    bias = rng.standard_normal(3).astype(np.float32) if affine else None
    want = jops.instance_norm(jnp.asarray(vol), None if scale is None else jnp.asarray(scale),
                              None if bias is None else jnp.asarray(bias))
    got = ops.instance_norm(to_ncdhw(vol), None if scale is None else torch.from_numpy(scale),
                            None if bias is None else torch.from_numpy(bias))
    close(to_ndhwc(got), want)


@pytest.mark.parametrize("training", [False, True])
def test_batch_norm_matches_jax(rng, vol, training):
    scale, bias, mean = (rng.standard_normal(3).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    jy, jm, jv = jops.batch_norm(jnp.asarray(vol), *(jnp.asarray(a) for a in
                                 (scale, bias, mean, var)), training=training)
    ty, tm, tv = ops.batch_norm(to_ncdhw(vol), *(torch.from_numpy(a) for a in
                                (scale, bias, mean, var)), training=training)
    close(to_ndhwc(ty), jy)
    close(tm, jm)
    close(tv, jv)


def test_layer_norm_matches_jax(rng):
    x = rng.standard_normal((2, 9, 24)).astype(np.float32) * 3
    scale, bias = (rng.standard_normal(24).astype(np.float32) for _ in range(2))
    close(ops.layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias))),
          jops.layer_norm(*(jnp.asarray(a) for a in (x, scale, bias))))


@pytest.mark.parametrize("k,stride,padding,dilation", [
    (3, 1, 1, 1), (3, 2, 1, 1), (7, 1, 3, 1), (3, 1, 2, 2), (1, 1, 0, 1), (2, 2, 0, 1)])
def test_conv3d_matches_jax(rng, k, stride, padding, dilation):
    x = rng.standard_normal((2, 9, 10, 8, 4)).astype(np.float32)
    w = (rng.standard_normal((5, 4, k, k, k)) * 0.2).astype(np.float32)   # torch (O, I, k..)
    b = rng.standard_normal(5).astype(np.float32)
    want = jops.conv3d(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 4, 1, 0)), jnp.asarray(b),
                       stride=stride, padding=padding, dilation=dilation)
    got = ops.conv3d(to_ncdhw(x), torch.from_numpy(w), torch.from_numpy(b), stride=stride,
                     padding=padding, dilation=dilation)
    close(to_ndhwc(got), want, 1e-4)


@pytest.mark.parametrize("bias", [False, True])
def test_conv_transpose3d_matches_jax(rng, bias):
    """Transposed weights are (I, O, k..) in torch, (k.., I, O) in the JAX
    package (core/torch_import.py:41-49)."""
    x = rng.standard_normal((2, 3, 4, 5, 6)).astype(np.float32)
    w = (rng.standard_normal((6, 4, 2, 2, 2)) * 0.3).astype(np.float32)   # (I, O, k..)
    b = rng.standard_normal(4).astype(np.float32) if bias else None
    want = jops.conv_transpose3d(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 4, 0, 1)),
                                 None if b is None else jnp.asarray(b), stride=2)
    got = ops.conv_transpose3d(to_ncdhw(x), torch.from_numpy(w),
                               None if b is None else torch.from_numpy(b), stride=2)
    assert got.shape == (2, 4, 6, 8, 10)
    close(to_ndhwc(got), want, 1e-4)


@pytest.mark.parametrize("transposed", [False, True], ids=["conv3d", "conv_transpose3d"])
def test_bf16_conv_bias_gradient_sums_in_float32(rng, transposed):
    """bfloat16 input and weight, float32 bias. Forward: the bf16 sum plus
    the float32 bias, rounded once, bit for bit. Bias gradient: float32, the
    float32 sum of the bf16 cotangent, against jax.vjp of the JAX op, to
    1e-5 of the channel's sum of |g| (float32 summation order; a sum
    rounded to bf16 is ~1e-3 off)."""
    cin, cout = 8, 4
    x = rng.standard_normal((1, 16, 16, 16, cin)).astype(np.float32)
    if transposed:   # torch (I, O, k..), JAX (k.., I, O)
        w = (rng.standard_normal((cin, cout, 2, 2, 2)) * 0.3).astype(np.float32)
        jw = w.transpose(2, 3, 4, 0, 1)
    else:            # torch (O, I, k..), JAX (k.., I, O)
        w = (rng.standard_normal((cout, cin, 3, 3, 3)) * 0.2).astype(np.float32)
        jw = w.transpose(2, 3, 4, 1, 0)
    b = rng.standard_normal(cout).astype(np.float32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(jw, jnp.bfloat16)

    def jax_op(bias):
        if transposed:
            return jops.conv_transpose3d(xb, wb, bias, stride=2)
        return jops.conv3d(xb, wb, bias, padding=1)

    def port_op(xt, wt, bias):
        if transposed:
            return ops.conv_transpose3d(xt, wt, bias, stride=2)
        return ops.conv3d(xt, wt, bias, padding=1)

    want, vjp = jax.vjp(jax_op, jnp.asarray(b))
    g = (rng.standard_normal(want.shape) * 1e-2 + 3e-3).astype(np.float32)
    g = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))   # bf16 values
    (want_gb,) = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = to_ncdhw(np.asarray(xb.astype(jnp.float32))).bfloat16()
    wt = torch.from_numpy(w).bfloat16()
    bt = torch.from_numpy(b).requires_grad_()
    got = port_op(xt, wt, bt)
    got.backward(to_ncdhw(g).bfloat16())
    assert got.dtype == torch.bfloat16 and bt.grad.dtype == torch.float32
    once = (port_op(xt, wt, None).float() + bt.detach().view(1, -1, 1, 1, 1)).bfloat16()
    assert torch.equal(got.detach().view(torch.int16), once.view(torch.int16))
    mass = np.abs(g).sum(axis=(0, 1, 2, 3))
    err = np.abs(bt.grad.numpy() - np.asarray(want_gb, np.float32))
    assert np.all(err <= 1e-5 * mass), f"bias grad err {err} vs sum|g| {mass}"


@pytest.mark.parametrize("mode,align,size", [
    ("trilinear", True, (12, 10, 14)), ("trilinear", True, (3, 2, 4)),
    ("trilinear", False, (12, 3, 9)), ("nearest-exact", False, (3, 10, 4)),
    ("nearest", False, (9, 7, 5))])
def test_resize3d_matches_jax(vol, mode, align, size):
    want = jops.resize3d(jnp.asarray(vol), size, mode=mode, align_corners=align)
    got = ops.resize3d(to_ncdhw(vol), size, mode=mode, align_corners=align)
    close(to_ndhwc(got), want)


def test_upsample3d_matches_jax(vol):
    close(to_ndhwc(ops.upsample3d(to_ncdhw(vol), 2)), jops.upsample3d(jnp.asarray(vol), 2))


def test_ops_keep_bfloat16(vol):
    x = to_ncdhw(vol).to(torch.bfloat16)
    assert ops.instance_norm(x).dtype == torch.bfloat16
    assert ops.mish(x).dtype == torch.bfloat16
    assert ops.upsample3d(x).dtype == torch.bfloat16
    w = torch.ones(2, 3, 1, 1, 1)                       # float32 weights, cast at use
    assert ops.conv3d(x, w, torch.zeros(2)).dtype == torch.bfloat16


def test_patchify_matches_jax(rng):
    x = rng.standard_normal((2, 8, 12, 4, 3)).astype(np.float32)
    close(patchify(to_ncdhw(x), 4), jpatchify(jnp.asarray(x), 4), 0)


@pytest.mark.parametrize("image,roi,overlap", [
    ((128, 128, 128), (96, 96, 96), 0.25), ((48, 48, 48), (32, 32, 32), 0.25),
    ((40, 100, 20), (32, 32, 32), 0.5), ((64, 64, 64), (96, 96, 96), 0.25)])
def test_window_grid_matches_jax(image, roi, overlap):
    assert tsw.window_grid(image, roi, overlap) == jsw.window_grid(image, roi, overlap)


def _window_dependent(w):
    """A predictor whose output depends on the whole window (its mean), so a
    misplaced or misweighted window shows in the blend."""
    return w * 2.0 + w.mean(axis=(2, 3, 4), keepdims=True) * 10.0


@pytest.mark.parametrize("shape,sw", [((1, 48, 48, 48, 2), 4), ((1, 48, 48, 48, 2), 8),
                                      ((1, 20, 40, 36, 1), 2)])
def test_sliding_window_matches_jax(rng, shape, sw):
    """The JAX engine and the port agree wherever sw_batch_size divides the
    window count (the engine pads nothing then); (20, 40, 36) is smaller
    than the ROI along one axis, so it is padded and cropped."""
    v = rng.standard_normal(shape).astype(np.float32)
    roi = (32, 32, 32)
    want = jsw.sliding_window_inference(
        jnp.asarray(v), lambda w: jnp.moveaxis(_window_dependent(jnp.moveaxis(w, -1, 1)), 1, -1),
        roi_size=roi, sw_batch_size=sw, overlap=0.25)
    got = tsw.sliding_window_inference(to_ncdhw(v), _window_dependent, roi_size=roi,
                                       sw_batch_size=sw, overlap=0.25)
    close(to_ndhwc(got), want, 1e-4)


@pytest.mark.parametrize("sw", [1, 3, 5, 8])
def test_sliding_window_is_the_monai_blend(rng, sw):
    """48³ in 32³ windows gives 8 windows. Where sw_batch_size divides 8
    (1, 8), the blend is the plain mean over the windows covering each
    voxel, as MONAI's, and the two packages agree. Where it does not (3, 5),
    both pad the last batch by repeating the last window and count the
    repeats (a fault of both, ROADMAP queue 3): the port must give the JAX
    package's blend."""
    v = rng.standard_normal((1, 1, 48, 48, 48)).astype(np.float32)
    roi = (32, 32, 32)
    got = tsw.sliding_window_inference(torch.from_numpy(v), _window_dependent, roi_size=roi,
                                       sw_batch_size=sw)
    if 8 % sw == 0:
        acc = np.zeros((1, 1, 48, 48, 48))
        cnt = np.zeros_like(acc)
        for z, y, x in tsw.window_grid((48, 48, 48), roi, 0.25):
            sl = (slice(None), slice(None), slice(z, z + 32), slice(y, y + 32),
                  slice(x, x + 32))
            acc[sl] += _window_dependent(v[sl])
            cnt[sl] += 1
        close(got, acc / cnt, 1e-4)
    else:
        want = jsw.sliding_window_inference(
            jnp.asarray(v.transpose(0, 2, 3, 4, 1)),
            lambda w: jnp.moveaxis(_window_dependent(jnp.moveaxis(w, -1, 1)), 1, -1),
            roi_size=roi, sw_batch_size=sw, overlap=0.25)
        close(to_ndhwc(got), want, 1e-4)


def test_sliding_window_rejects_gaussian_blend():
    """The gaussian blend is ported (test_gaussian_sliding_window_matches_jax);
    a blend mode the JAX package does not know is rejected, as there."""
    out = tsw.sliding_window_inference(torch.ones(1, 1, 8, 8, 8), lambda w: w,
                                       roi_size=(4, 4, 4), mode="gaussian")
    close(out, np.ones((1, 1, 8, 8, 8)), 1e-6)
    with pytest.raises(ValueError, match="blend mode"):
        tsw.sliding_window_inference(torch.zeros(1, 1, 8, 8, 8), lambda w: w,
                                     roi_size=(4, 4, 4), mode="triangle")


@pytest.mark.parametrize("roi", [(96, 96, 96), (32, 32, 32), (5, 12, 7), (1, 2, 3)])
def test_importance_map_matches_jax(roi):
    """float32 to 1e-6 (exp one ulp apart between the two libraries)."""
    for mode in ("constant", "gaussian"):
        got = tsw._importance_map(roi, mode)
        want = jsw._importance_map(roi, mode)
        assert got.shape == (1, 1, *roi) and got.dtype == torch.float32
        close(got[0, 0], np.asarray(want)[..., 0], 1e-6)
        assert float(got.min()) > 0 and float(got.max()) == 1.0


@pytest.mark.parametrize("shape,sw", [((1, 48, 48, 48, 2), 4), ((1, 48, 48, 48, 2), 3),
                                      ((1, 20, 40, 36, 1), 2)])
def test_gaussian_sliding_window_matches_jax(rng, shape, sw):
    """mode='gaussian' against the JAX engine: 8 windows in batches of 4, in
    batches of 3 (the last padded by repeats, weighted as the JAX package
    weighs them), and a volume smaller than the ROI along one axis."""
    v = rng.standard_normal(shape).astype(np.float32)
    roi = (32, 32, 32)
    want = jsw.sliding_window_inference(
        jnp.asarray(v), lambda w: jnp.moveaxis(_window_dependent(jnp.moveaxis(w, -1, 1)), 1, -1),
        roi_size=roi, sw_batch_size=sw, overlap=0.25, mode="gaussian")
    got = tsw.sliding_window_inference(to_ncdhw(v), _window_dependent, roi_size=roi,
                                       sw_batch_size=sw, overlap=0.25, mode="gaussian")
    close(to_ndhwc(got), want, 1e-4)


def test_postprocess_matches_jax(rng):
    pred = rng.standard_normal((1, 6, 6, 6, 1)).astype(np.float32)
    mask = (rng.random((1, 6, 6, 6, 1)) < 0.5).astype(np.float32)
    want = postprocess_prediction_jax(jnp.asarray(pred), jnp.asarray(mask), scale=70.0)
    got = postprocess_prediction(torch.from_numpy(pred), torch.from_numpy(mask), scale=70.0)
    close(got, want, 0)


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible; the no-card behaviour cannot be shown here")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
