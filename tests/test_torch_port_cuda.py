"""The PyTorch port's CUDA kernels on a card (tests marked ``cuda``).

Each test decides inside its ``card`` fixture whether there is a card, and
skips where there is none. This file imports neither jax nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest`` because tests/conftest.py configures JAX.)
Tolerances, as in chip_smoke.py: float32 1e-4 absolute (summation order);
bfloat16 two bf16 ulps at the largest output magnitude, 2^-6 · max|want|
(the kernels round once, the plain versions round intermediate values to
bf16 too, as the JAX references do).
"""

import pytest

torch = pytest.importorskip("torch")

from dose_prediction_tpu_torch.infer.cascade import make_cascade_stages  # noqa: E402
from dose_prediction_tpu_torch.kernels import attention as k1  # noqa: E402
from dose_prediction_tpu_torch.kernels import cuda_lib  # noqa: E402
from dose_prediction_tpu_torch.kernels import instance_norm as k2  # noqa: E402
from dose_prediction_tpu_torch.models import DosePyfer, TranSeg  # noqa: E402
from dose_prediction_tpu_torch.nn.init import init_params  # noqa: E402

ACTS = ["identity", "relu", "leakyrelu", "mish", "gelu"]
DTYPES = [torch.float32, torch.bfloat16]


def tolerance(want: torch.Tensor) -> float:
    if want.dtype == torch.float32:
        return 1e-4
    return 2.0 ** -6 * max(want.float().abs().max().item(), 1.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 12, 216, 64), (1, 6, 512, 128), (2, 3, 70, 32)])
def test_attention_kernel_matches_plain_on_card(card, shape, dtype):
    g = torch.Generator(card).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=card).to(dtype) for _ in range(3))
    n = k1.fused_attention.launches
    got = k1.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert k1.fused_attention.launches == n + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = k1.plain_attention(q, k, v)
    assert (got.float() - want.float()).abs().max().item() <= tolerance(want)


@pytest.mark.cuda
def test_attention_kernel_refuses_unsupported_head_dims(card):
    q = torch.zeros(1, 2, 8, 12, device=card)
    with pytest.raises(ValueError, match="head dim"):
        k1.fused_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ACTS)
def test_instance_norm_kernel_matches_plain_on_card(card, act, dtype):
    g = torch.Generator(card).manual_seed(0)
    x = (torch.randn((2, 16, 24, 20, 36), generator=g, device=card) * 2 + 1).to(dtype)
    scale = torch.rand(16, generator=g, device=card) + 0.5
    bias = torch.randn(16, generator=g, device=card)
    n = k2.instance_norm_act.launches
    got = k2.instance_norm_act(x, scale, bias, act=act)
    torch.cuda.synchronize()
    assert k2.instance_norm_act.launches == n + 1
    want = k2.plain_instance_norm_act(x, scale, bias, act=act)
    assert (got.float() - want.float()).abs().max().item() <= tolerance(want)


@pytest.mark.cuda
def test_build_is_reused(card):
    first = cuda_lib.build()
    assert first.is_file() and cuda_lib.build() == first


@pytest.mark.cuda
def test_reduced_cascade_kernels_match_plain_on_card(card, monkeypatch):
    """A 48³ cascade with 32³ windows and small models (head dim 32), float32
    with TF32 off, through the kernels and with the plain versions swapped
    in: at least 99.9 % of the labels equal (a near-tie may go either way)
    and, given the same structures, the dose within 1e-3 of the 70 Gy
    scale."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dict(feature_size=4, hidden_size=64, mlp_dim=128, num_layers=4, num_heads=2,
               device=card)
    g = torch.Generator(card).manual_seed(0)
    seg = init_params(TranSeg(img_size=32, **cfg), g)
    dose = init_params(DosePyfer(list_ch_A=(-1, 4, 8, 16, 32, 64), img_size=48, **cfg), g)
    s1, s2 = make_cascade_stages(seg, dose, roi_size=(32, 32, 32), sw_batch_size=4)
    ct = torch.randn((1, 48, 48, 48, 1), generator=g, device=card)
    ptv = (torch.rand((1, 48, 48, 48, 1), generator=g, device=card) < 0.1).float()
    mask = (torch.rand((1, 48, 48, 48, 1), generator=g, device=card) < 0.6).float()
    launches = (k1.fused_attention.launches, k2.instance_norm_act.launches)
    struct = s1(seg.state_dict(), ct, ptv)
    dose_gy = s2(dose.state_dict(), struct, mask)
    torch.cuda.synchronize()
    assert k1.fused_attention.launches > launches[0]
    assert k2.instance_norm_act.launches > launches[1]
    monkeypatch.setattr(k1, "fused_attention", k1.plain_attention)
    monkeypatch.setattr(k2, "instance_norm_act", k2.plain_instance_norm_act)
    struct_p = s1(seg.state_dict(), ct, ptv)
    dose_p = s2(dose.state_dict(), struct, mask)
    assert torch.all(struct == struct_p, dim=-1).float().mean().item() >= 0.999
    assert (dose_gy - dose_p).abs().max().item() / 70.0 <= 1e-3
    assert bool(torch.isfinite(dose_gy).all()) and bool((dose_gy[mask < 1] == 0).all())
