"""The PyTorch port's ``Linear`` against the JAX package's ``Dense``.

``Dense`` takes the product with a float32 result, adds the float32 bias and
rounds once to its dtype (dose_prediction_tpu/nn/layers.py:180-184); the
port's bf16 ``Linear`` with a bias does the same. The only difference left is
the order of the float32 sums, which can move a result across a bf16
rounding boundary: no output may be more than one bf16 ulp apart, and
under 0.1 % of outputs may differ at all. The ulp is taken at the larger of
|JAX output| and 2^-8: where a sum of terms of order 0.01-1 cancels to
below that, the two packages' float32 sums differ by about 2^-24 of the
terms, more than a bf16 ulp of the tiny result (one output of this input
is 2.4e-6, two ulps of its own apart). Float32 agrees to 1e-5.
"""

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dose_prediction_tpu.nn.layers import Dense  # noqa: E402

from dose_prediction_tpu_torch.nn.layers import Linear  # noqa: E402

SHAPE, FEATURES = (2, 216, 768), 768     # TranSeg's ViT width on one 96³ window's tokens


def _pair(dtype, seed=0):
    """The same weights, bias and input in both packages (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    cin = SHAPE[-1]
    w = rng.uniform(-1, 1, (FEATURES, cin)).astype(np.float32) / np.sqrt(cin)
    b = rng.uniform(-1, 1, FEATURES).astype(np.float32) / np.sqrt(cin)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    lin = Linear(cin, FEATURES, device="cpu")
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = Dense(FEATURES, dtype=jdtype).apply(
        {"params": {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)}},
        jnp.asarray(x).astype(jdtype))
    with torch.no_grad():
        got = lin(torch.from_numpy(x).to(dtype))
    return got, np.asarray(want.astype(jnp.float32))


def test_linear_bf16_rounds_once_as_dense():
    got, want = _pair(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == SHAPE[:-1] + (FEATURES,)
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -8))) - 7)
    diff = np.abs(got - want)
    n_diff = int((diff > 0).sum())
    print(f"bf16 Linear vs JAX Dense: {n_diff} of {want.size} outputs differ, "
          f"max {diff.max():.4g}, max in ulps {(diff / ulp).max():.3g}")
    assert (diff <= ulp).all()
    assert n_diff < 1e-3 * want.size


def test_linear_float32_matches_dense():
    got, want = _pair(torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_linear_bf16_backward_takes_the_bf16_products():
    """The input and weight gradients are the products a bf16 ``F.linear``
    takes; the bias gradient is the float32 sum of the output gradient."""
    rng = np.random.default_rng(1)
    lin = Linear(48, 24, device="cpu")
    x = torch.from_numpy(rng.standard_normal((3, 5, 48)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((3, 5, 24)).astype(np.float32)).bfloat16()
    x.requires_grad_(True)
    lin(x).backward(g)
    w = lin.weight.detach().bfloat16().requires_grad_(True)
    xr = x.detach().clone().requires_grad_(True)
    torch.nn.functional.linear(xr, w).backward(g)
    assert torch.equal(x.grad, xr.grad)
    assert torch.equal(lin.weight.grad, w.grad.float())
    torch.testing.assert_close(lin.bias.grad, g.float().sum((0, 1)), rtol=0, atol=1e-5)
