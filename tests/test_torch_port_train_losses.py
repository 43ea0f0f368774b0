"""The PyTorch port's segmentation, GAN and per-sample losses
(train/losses.py) against the JAX package on the CPU.

numpy-seeded logits and labels, NDHWC for JAX and NCDHW for the port (the
class axis 1); float32. Tolerance: 1e-5 relative to max(1, |loss|), the bar
of tests/test_torch_port_train.py's losses (one op order apart: the two
libraries' softmax, log-softmax and reductions).
"""

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dose_prediction_tpu.train import losses as JL  # noqa: E402

from dose_prediction_tpu_torch.train import losses as L  # noqa: E402

TOL = 1e-5


def ncdhw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def close(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    return bool(np.all(np.abs(got.numpy() - want) <= TOL * np.maximum(1.0, np.abs(want))))


def seg_batch(seed, n=2, c=5, shape=(6, 7, 8), scale=3.0):
    rng = np.random.default_rng(seed)
    logits = (scale * rng.standard_normal((n, *shape, c))).astype(np.float32)
    labels = rng.integers(0, c, (n, *shape)).astype(np.uint8)
    labels[0, ..., :2] = 0        # a class absent from a sample: dice's smooth terms
    return logits, labels


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fn", ["softmax_cross_entropy", "dice_loss", "dice_ce_loss"])
def test_seg_losses_match_jax(seed, fn):
    logits, labels = seg_batch(seed)
    want = getattr(JL, fn)(jnp.asarray(logits), jnp.asarray(labels))
    got = getattr(L, fn)(ncdhw(logits), torch.from_numpy(labels))
    assert close(got, want), (float(got), float(want))


def test_dice_loss_without_background_and_weighted_dice_ce_match_jax():
    logits, labels = seg_batch(2, n=1, c=8)
    want = JL.dice_loss(jnp.asarray(logits), jnp.asarray(labels), include_background=False)
    got = L.dice_loss(ncdhw(logits), torch.from_numpy(labels), include_background=False)
    assert close(got, want)
    want = JL.dice_ce_loss(jnp.asarray(logits), jnp.asarray(labels), lambda_dice=0.3,
                           lambda_ce=2.0)
    got = L.dice_ce_loss(ncdhw(logits), torch.from_numpy(labels), lambda_dice=0.3,
                         lambda_ce=2.0)
    assert close(got, want)


def test_dice_ce_gradient_matches_jax():
    """The logits' gradient of DiceCE, the TranSeg step's cotangent."""
    import jax

    logits, labels = seg_batch(3)
    want = jax.grad(lambda x: JL.dice_ce_loss(x, jnp.asarray(labels)))(jnp.asarray(logits))
    x = ncdhw(logits).requires_grad_(True)
    L.dice_ce_loss(x, torch.from_numpy(labels)).backward()
    np.testing.assert_allclose(np.moveaxis(x.grad.numpy(), 1, -1), np.asarray(want), rtol=0,
                               atol=TOL * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("lsgan", [True, False])
def test_gan_losses_match_jax(real, lsgan):
    rng = np.random.default_rng(4)
    x = (3 * rng.standard_normal((2, 3, 4, 5, 1))).astype(np.float32)
    t = (rng.random((2, 3, 4, 5, 1)) < 0.5).astype(np.float32)
    assert close(L.gan_loss(ncdhw(x), real, use_lsgan=lsgan),
                 JL.gan_loss(jnp.asarray(x), real, use_lsgan=lsgan))
    assert close(L.bce_with_logits(ncdhw(x), ncdhw(t)),
                 JL.bce_with_logits(jnp.asarray(x), jnp.asarray(t)))
    y = (rng.standard_normal((2, 3, 4, 5, 1)) * 2).astype(np.float32)
    assert close(L.disc_hinge_loss(ncdhw(x), ncdhw(y)),
                 JL.disc_hinge_loss(jnp.asarray(x), jnp.asarray(y)))


def test_masked_l1_per_sample_matches_jax():
    """Three samples, one with an empty mask (its loss is 0, the count's
    floor of 1)."""
    rng = np.random.default_rng(5)
    pred = rng.standard_normal((3, 6, 6, 6, 1)).astype(np.float32)
    gt = rng.random((3, 6, 6, 6, 1)).astype(np.float32)
    mask = (rng.random((3, 6, 6, 6, 1)) < 0.5).astype(np.float32)
    mask[2] = 0
    want = JL.masked_l1_per_sample(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask))
    got = L.masked_l1_per_sample(ncdhw(pred), ncdhw(gt), ncdhw(mask))
    assert got.shape == (3,) and close(got, want) and float(got[2]) == 0.0
