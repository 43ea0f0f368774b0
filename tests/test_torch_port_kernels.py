"""Kernels K1 (attention) and K2 (instance norm) of the PyTorch port.

On the CPU each wrapper runs its plain PyTorch version; those are held here
against the JAX package's Pallas kernels, run as tests/test_kernels.py runs
them (interpret=True), and against the JAX references they were written
from (xla_attention, ops.instance_norm). Float32: max abs ≤ 2e-5 (the bar of
tests/test_kernels.py). The CUDA kernels themselves are held against the
plain versions on a card by tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dose_prediction_tpu import ops as jops  # noqa: E402
from dose_prediction_tpu.kernels.attention import fused_attention as j_fused  # noqa: E402
from dose_prediction_tpu.kernels.attention import xla_attention  # noqa: E402
from dose_prediction_tpu.kernels.instance_norm import instance_norm_act as j_in_act  # noqa: E402

from dose_prediction_tpu_torch.kernels import attention as k1  # noqa: E402
from dose_prediction_tpu_torch.kernels import cuda_lib  # noqa: E402
from dose_prediction_tpu_torch.kernels import instance_norm as k2  # noqa: E402

TOL = 2e-5
ACTS = ["identity", "relu", "leakyrelu", "mish", "gelu"]


def _qkv(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 3, 64, 16), (1, 2, 70, 12), (2, 2, 27, 8)])
def test_attention_matches_pallas_and_xla(rng, shape):
    """Ragged L (70, 27) as in the TranSeg windows' L = 216."""
    q, k, v = _qkv(rng, shape)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_pallas = np.asarray(j_fused(jq, jk, jv, interpret=True))
    want_xla = np.asarray(xla_attention(jq, jk, jv))
    got = k1.fused_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=0, atol=TOL)


def test_attention_bfloat16_matches_xla(rng):
    """bf16 in, bf16 out: probabilities rounded to bf16 before P·V, as in
    xla_attention; tolerance 1e-2 (about one bf16 ulp at 2)."""
    q, k, v = _qkv(rng, (1, 2, 40, 16))
    want = np.asarray(xla_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))),
                      np.float32)
    got = k1.fused_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=1e-2)


@pytest.mark.parametrize("act", ACTS)
def test_instance_norm_act_matches_pallas(rng, act):
    x = (rng.standard_normal((2, 4, 4, 8, 16)) * 2 + 1).astype(np.float32)   # NDHWC
    scale, bias = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    want = np.asarray(j_in_act(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                               act=act, interpret=True))
    got = k2.instance_norm_act(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3))),
                               torch.from_numpy(scale), torch.from_numpy(bias), act=act)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 4, 1), want, rtol=0, atol=TOL)


def test_instance_norm_act_without_affine_matches_ops(rng):
    """Shifted data (mean 50) as a check that the statistics are two-pass."""
    x = (rng.standard_normal((1, 3, 6, 5, 7)) + 50).astype(np.float32)
    want = np.asarray(jops.instance_norm(jnp.asarray(x.transpose(0, 2, 3, 4, 1))))
    got = k2.instance_norm_act(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 4, 1), want, rtol=0, atol=1e-4)


def test_wrappers_on_cpu_run_the_plain_versions_and_count_nothing(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, (1, 1, 5, 4)))
    x = torch.from_numpy(rng.standard_normal((1, 2, 3, 3, 3)).astype(np.float32))
    before = (k1.fused_attention.launches, k2.instance_norm_act.launches)
    assert torch.equal(k1.fused_attention(q, k, v), k1.plain_attention(q, k, v))
    assert torch.equal(k2.instance_norm_act(x, act="mish"),
                       k2.plain_instance_norm_act(x, act="mish"))
    assert (k1.fused_attention.launches, k2.instance_norm_act.launches) == before


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; anything else that is not a
    CUDA tensor raises rather than falling back."""
    meta = torch.empty(1, 1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k1.fused_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k2.instance_norm_act(torch.empty(1, 2, 2, 2, 2, device="meta"))


def test_library_path_follows_the_sources(tmp_path, monkeypatch):
    """The library's name hashes the sources, so an edited source rebuilds
    and an unchanged tree reuses the library."""
    first = cuda_lib.library_path()
    assert first == cuda_lib.library_path()
    assert first.parent == cuda_lib.BUILD_DIR and first.suffix == ".so"
    src = tmp_path / "csrc"
    src.mkdir()
    for f in cuda_lib.SOURCE_DIR.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda_lib, "SOURCE_DIR", src)
    assert cuda_lib.library_path() == first
    (src / "attention.cu").write_text((src / "attention.cu").read_text() + "\n// edit\n")
    assert cuda_lib.library_path() != first


@pytest.mark.parametrize("bh,length,want", [
    (8 * 12, 216, (4, 1)),     # TranSeg windows: 384 blocks of 64 rows
    (1 * 6, 512, (2, 2)),      # DOSE-PYFER ViT: 96 blocks of 32 rows
    (1 * 6, 216, (1, 4)),      # one TranSeg window: 84 blocks of 16 rows
    (1, 1, (1, 4))])           # nothing fills the card: the most key splits
def test_bf16_tiling_takes_the_fewest_key_splits_that_fill_half_the_sms(bh, length, want):
    """On a 132-SM card: the fewest key-split warps whose grid has at least
    one block per two SMs; every choice is an instantiated tiling."""
    got = k1.bf16_tiling(bh, length, 132)
    assert got == want and got in k1.TILINGS
    wm, _ = got
    assert 2 * bh * -(-length // (16 * wm)) >= 132 or got == k1.TILINGS[-1]
