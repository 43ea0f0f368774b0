"""The port's K1 and K2 routing flags (core/config.py) against the JAX
package's DPT_PALLAS_ATTENTION and DPT_PALLAS_IN, on the CPU.

Each flag is read from the JAX package's variable with its default; on the
route chooses the kernel's wrapper, off the counterpart of the JAX package's
own route: K1's plain version kernels/attention.py::plain_attention (the JAX
einsum route) for attention and ops.instance_norm for InstanceNorm. The off
routes are held against the JAX layers, which take those routes off the TPU: float32 to 1e-5 (one op order apart); bfloat16 to
one bf16 ulp at the larger of |JAX output| and 2^-8 (the float32 sums may
round across a bf16 boundary; the bar of tests/test_torch_port_layers.py).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")

from dose_prediction_tpu.nn.layers import InstanceNorm as JInstanceNorm  # noqa: E402
from dose_prediction_tpu.nn.vit import Attention as JAttention  # noqa: E402

from dose_prediction_tpu_torch.core.config import FLAGS  # noqa: E402
from dose_prediction_tpu_torch.kernels import attention as k1  # noqa: E402
from dose_prediction_tpu_torch.kernels import instance_norm as k2  # noqa: E402
from dose_prediction_tpu_torch.nn import vit  # noqa: E402
from dose_prediction_tpu_torch.nn.layers import InstanceNorm3d  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def close(got: np.ndarray, want: np.ndarray, dtype: str):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -8))) - 7)
        assert (np.abs(got - want) <= ulp).all(), float(np.abs(got - want).max())


def _calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


@pytest.mark.parametrize("env,want", [({}, ("True", "auto")),
                                      ({"DPT_PALLAS_ATTENTION": "0", "DPT_PALLAS_IN": "0"},
                                       ("False", "0"))])
def test_flags_read_the_jax_variables(env, want):
    """Defaults '1' and 'auto', as the JAX package's; '0' turns each off."""
    clean = {k: v for k, v in os.environ.items() if not k.startswith("DPT_")}
    out = subprocess.run(
        [sys.executable, "-c", "from dose_prediction_tpu_torch.core.config import FLAGS; "
                               "print(FLAGS.use_k1_attention, FLAGS.use_k2_instance_norm)"],
        cwd=REPO, env={**clean, **env, "PYTHONPATH": str(REPO)}, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert tuple(out.stdout.split()) == want


@pytest.mark.parametrize("on", [True, False])
def test_attention_flag_chooses_k1_or_the_einsum_route(monkeypatch, on):
    monkeypatch.setattr(FLAGS, "use_k1_attention", on)
    kernel = _calls(monkeypatch, k1, "fused_attention")
    plain = _calls(monkeypatch, k1, "plain_attention")
    block = vit.SABlock(24, 2)
    with torch.no_grad():
        block(torch.randn(1, 8, 24))
    # on the CPU the kernel's wrapper runs the plain version too
    assert (len(kernel), len(plain)) == (int(on), 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_einsum_attention_matches_jax_off_the_kernel(monkeypatch, rng, dtype):
    """SABlock with DPT_PALLAS_ATTENTION=0 against the JAX Attention module,
    which takes its einsum route off the TPU (nn/vit.py:67-76)."""
    monkeypatch.setattr(FLAGS, "use_k1_attention", False)
    tdt, jdt = DTYPES[dtype]
    hidden, heads = 48, 4
    x = rng.standard_normal((2, 27, hidden)).astype(np.float32)
    wqkv = (rng.standard_normal((3 * hidden, hidden)) / np.sqrt(hidden)).astype(np.float32)
    wo = (rng.standard_normal((hidden, hidden)) / np.sqrt(hidden)).astype(np.float32)
    bo = (rng.standard_normal(hidden) * 0.1).astype(np.float32)
    block = vit.SABlock(hidden, heads)
    with torch.no_grad():
        block.qkv.weight.copy_(torch.from_numpy(wqkv))
        block.out_proj.weight.copy_(torch.from_numpy(wo))
        block.out_proj.bias.copy_(torch.from_numpy(bo))
        got = block(torch.from_numpy(x).to(tdt)).float().numpy()
    want = JAttention(hidden, heads, dtype=jdt).apply(
        {"params": {"qkv": {"kernel": jnp.asarray(wqkv.T)},
                    "out_proj": {"kernel": jnp.asarray(wo.T), "bias": jnp.asarray(bo)}}},
        jnp.asarray(x).astype(jdt))
    close(got, np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("flag,routed", [("auto", True), ("1", True), ("0", False)])
def test_instance_norm_flag_chooses_k2_or_ops(monkeypatch, flag, routed):
    monkeypatch.setattr(FLAGS, "use_k2_instance_norm", flag)
    kernel = _calls(monkeypatch, k2, "instance_norm_act")
    norm = InstanceNorm3d(3, affine=True)
    with torch.no_grad():
        norm(torch.randn(1, 3, 4, 4, 4))
    assert len(kernel) == int(routed)


@pytest.mark.parametrize("dtype", DTYPES)
def test_instance_norm_off_route_matches_jax(monkeypatch, rng, dtype):
    """InstanceNorm3d with DPT_PALLAS_IN=0 against the JAX InstanceNorm
    layer, which takes ops.instance_norm off the TPU."""
    monkeypatch.setattr(FLAGS, "use_k2_instance_norm", "0")
    kernel = _calls(monkeypatch, k2, "instance_norm_act")
    tdt, jdt = DTYPES[dtype]
    x = (rng.standard_normal((2, 6, 5, 7, 4)) * 2 + 1).astype(np.float32)     # NDHWC
    scale = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    norm = InstanceNorm3d(4, affine=True)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        got = norm(torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy()).to(tdt))
    assert got.dtype == tdt and not kernel
    want = JInstanceNorm().apply({"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
                                 jnp.asarray(x).astype(jdt))
    close(got.float().numpy().transpose(0, 2, 3, 4, 1), np.asarray(want.astype(jnp.float32)),
          dtype)
