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

from torch_threads import one_torch_thread  # noqa: E402,F401

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


@pytest.mark.parametrize("act", ACTS)
def test_instance_norm_act_bf16_matches_pallas(act):
    """bf16 in, bf16 out: the plain version (the CUDA kernel's reference on
    the card) and the Pallas kernel both apply the activation in float32 and
    round once; their statistics differ in float32 rounding only. Bar: one
    bf16 ulp at the larger of |Pallas output| and 2^-8 (below that, float32
    differences of order 2^-24 and GELU's cancelling 1 + erf tail in torch
    reach a bf16 ulp of the tiny result)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 4, 4, 8, 16)) * 2 + 1).astype(np.float32)   # NDHWC
    scale, bias = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(j_in_act(xb, jnp.asarray(scale), jnp.asarray(bias), act=act,
                               interpret=True).astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32)).transpose(0, 4, 1, 2, 3).copy())
    got = k2.instance_norm_act(xt.bfloat16(), torch.from_numpy(scale), torch.from_numpy(bias),
                               act=act)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy().transpose(0, 2, 3, 4, 1)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -8))) - 7)
    assert (np.abs(got - want) <= ulp).all()


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
    assert first.parent == cuda_lib.cache_dir() and first.suffix == ".so"
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


# Resident blocks of the single-read K2 kernel's 16-byte instantiations on
# an H100: 132 SMs x the 4 blocks per SM the card's occupancy calculator
# gives for both dtypes; bf16 blocks hold 16384 elements, float32 8192
H100_CAPACITY = 4 * 132
CHUNK = {"bfloat16": 16384, "float32": 8192}
# every shape a bf16 serve request gives K2 (chip_smoke.K2_SHAPES)
SERVE_K2_SHAPES = [(8, 16, 96, 96, 96), (8, 32, 48, 48, 48), (8, 64, 24, 24, 24),
                   (8, 32, 24, 24, 24), (8, 128, 12, 12, 12), (1, 16, 128, 128, 128),
                   (1, 32, 64, 64, 64), (1, 64, 32, 32, 32), (1, 32, 32, 32, 32),
                   (1, 128, 16, 16, 16), (1, 256, 8, 8, 8)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", SERVE_K2_SHAPES)
def test_k2_serve_shapes_take_the_single_read_kernel(shape, dtype):
    """At the H100's capacity every serve shape's plane needs at most half
    the resident blocks, so K2 reads each volume once."""
    s = int(np.prod(shape[2:]))
    assert k2.plan(s, CHUNK[dtype], H100_CAPACITY) == k2.SINGLE_READ
    assert -(-s // CHUNK[dtype]) <= H100_CAPACITY // 2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k2_plane_larger_than_half_the_card_takes_two_kernels(dtype):
    """264 chunks is the largest plane the H100 takes in one read; one more
    element takes the two-kernel path, as does any plane of several chunks
    on a card that holds one block."""
    largest = CHUNK[dtype] * (H100_CAPACITY // 2)
    assert k2.plan(largest, CHUNK[dtype], H100_CAPACITY) == k2.SINGLE_READ
    assert k2.plan(largest + 1, CHUNK[dtype], H100_CAPACITY) == k2.TWO_KERNEL
    assert k2.plan(CHUNK[dtype] + 1, CHUNK[dtype], 1) == k2.TWO_KERNEL
