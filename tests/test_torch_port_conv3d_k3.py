"""Kernel K3 (conv3d_k3) of the PyTorch port, its routing, and the gradients
of the three kernel wrappers, against the JAX package on the CPU.

On the CPU each wrapper runs its plain PyTorch version (with autograd, the
backward recomputes it, as on the card). The JAX Pallas kernels run as
tests/test_kernels.py runs them (interpret=True). Inputs are made with numpy
from a seed; NDHWC arrays go to JAX, their NCDHW transposes to the port;
conv weights (3, 3, 3, C_in, C_out) in JAX are (C_out, C_in, 3, 3, 3) in
torch. Tolerances: K3 forward 2e-4 (the bar of
tests/test_kernels.py::test_pallas_conv3d_k3_matches_xla); gradients rtol
2e-3, atol 2e-4 (the bar of test_pallas_conv3d_k3_grad); the routed C3D
U-Net 1e-3 (the bar of test_golden_pyfer.py). The CUDA kernel itself is held
against the plain version on a card by tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu import ops as jops  # noqa: E402
from dose_prediction_tpu.core import torch_import as TI  # noqa: E402
from dose_prediction_tpu.core.config import FLAGS as JFLAGS  # noqa: E402
from dose_prediction_tpu.kernels.attention import fused_attention as j_attention  # noqa: E402
from dose_prediction_tpu.kernels.conv3d import conv3d_k3 as j_conv3d_k3  # noqa: E402
from dose_prediction_tpu.kernels.instance_norm import instance_norm_act as j_in_act  # noqa: E402
from dose_prediction_tpu.models.c3d import BaseUNet as JBaseUNet  # noqa: E402

from dose_prediction_tpu_torch import ops  # noqa: E402
from dose_prediction_tpu_torch.core.config import FLAGS  # noqa: E402
from dose_prediction_tpu_torch.kernels import attention as k1  # noqa: E402
from dose_prediction_tpu_torch.kernels import conv3d as k3  # noqa: E402
from dose_prediction_tpu_torch.kernels import instance_norm as k2  # noqa: E402
from dose_prediction_tpu_torch.models import BaseUNet  # noqa: E402

import test_torch_port_models as M  # noqa: E402  (seeded init)

FWD_TOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4


def ncdhw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 4, 1, 2, 3)))


def ndhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 4, 1)


def torch_weight(w: np.ndarray) -> torch.Tensor:
    """(3, 3, 3, C_in, C_out) → (C_out, C_in, 3, 3, 3)."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))


def conv_inputs(rng, shape):
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, c, c)) * 0.2).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape", [(1, 8, 8, 16, 16), (1, 8, 8, 8, 32), (2, 4, 8, 16, 16)])
def test_conv3d_k3_matches_pallas(rng, shape):
    """The shapes of tests/test_kernels.py, N = 2 included; the wrapper on a
    CPU tensor and the plain version both."""
    x, w, b = conv_inputs(rng, shape)
    want = np.asarray(j_conv3d_k3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                  interpret=True))
    args = (ncdhw(x), torch_weight(w), torch.from_numpy(b))
    for got in (k3.plain_conv3d_k3(*args), k3.conv3d_k3(*args)):
        assert got.shape == args[0].shape and got.dtype == torch.float32
        np.testing.assert_allclose(ndhwc(got), want, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_packed_weights_give_the_convolution(dtype):
    """The kernel's weight layout (``pack_weights``: (27, C_out, C_in) for
    bfloat16, (27, C_in, C_out) for float32) as the plain implicit GEMM it
    feeds: an einsum of the packed taps with the 27 shifted inputs is the
    convolution, in float32 to 1e-5 relative and absolute (outputs reach
    about 10; the weights are bf16 values, so the packing is exact)."""
    x, w, _ = conv_inputs(np.random.default_rng(1), (2, 5, 6, 7, 16))
    xt, wt = ncdhw(x), torch_weight(w).bfloat16().float()
    packed = k3.pack_weights(wt, dtype)
    assert packed.dtype == dtype and packed.shape == (27, 16, 16)
    n, c, d, h, wd = xt.shape
    xp = torch.nn.functional.pad(xt, (1,) * 6)
    taps = torch.stack([xp[:, :, kd:kd + d, kh:kh + h, kw:kw + wd]
                        for kd in range(3) for kh in range(3) for kw in range(3)])
    spec = "tncdhw,toc->nodhw" if dtype == torch.bfloat16 else "tncdhw,tco->nodhw"
    got = torch.einsum(spec, taps, packed.float())
    torch.testing.assert_close(got, k3.plain_conv3d_k3(xt, wt), rtol=1e-5, atol=1e-5)


# every shape a bf16 serve_k3 request gives K3 (chip_smoke.K3_SHAPES), then
# the ragged shapes of the card tests (tests/test_torch_port_cuda.py)
SERVE_K3_SHAPES = [(1, 16, 128, 128, 128), (1, 32, 64, 64, 64), (1, 64, 32, 32, 32),
                   (8, 16, 96, 96, 96), (8, 32, 48, 48, 48), (8, 64, 24, 24, 24),
                   (8, 32, 24, 24, 24), (1, 32, 32, 32, 32)]
RAGGED_SHAPES = [(2, 16, 5, 7, 13), (1, 32, 9, 10, 20), (1, 64, 4, 8, 16), (3, 16, 6, 17, 33),
                 (1, 32, 6, 16, 24), (1, 16, 4, 8, 48), (1, 64, 1, 9, 12), (2, 32, 2, 13, 7),
                 (8, 64, 3, 8, 16), (1, 16, 3, 33, 13)]


@pytest.mark.parametrize("shape", SERVE_K3_SHAPES + RAGGED_SHAPES)
def test_bf16_plan_fits_the_card(shape):
    """The bf16 tile that ``plan`` chooses: a valid tile (tw a multiple of
    8, td·g m-tiles a warp, whole warps, at most 8, or 12 at C = 64), shared memory within
    the 232,448 bytes a block can use, grid dimensions within CUDA's
    limits; at the serve_k3 shapes a block for at least every other SM of
    132 (the plan trades filling every SM for larger blocks, which stage
    the weights for more voxels) and no padded row, column or depth (W = 24
    takes a 24-column tile)."""
    n, c, d, h, w = shape
    t = k3.plan(shape)
    assert t.tw % 8 == 0 and t.td * t.g == k3.MTILES[c]
    assert (t.th * t.tw) % (16 * t.g) == 0 and 1 <= k3.warps(t) <= k3.MAX_WARPS[c]
    assert k3.smem_bytes(c, t) <= 232_448
    gx, gy, gz = k3.grid(shape, t)
    assert gx < 2 ** 31 and gy <= 65535 and gz <= 65535
    if shape in SERVE_K3_SHAPES:
        assert 2 * gx * gy * gz >= 132 and w % t.tw == 0 and h % t.th == 0 and d % t.td == 0


def emulate_bf16_kernel(x: torch.Tensor, w: torch.Tensor, t) -> torch.Tensor:
    """The bf16 kernel's index maths in float32: per block, the td + 2 halo
    planes; per warp and m-tile, the 16 positions and their depth; per tap,
    the shifted halo rows times the packed (27, C_out, C_in) weights."""
    n, c, d, h, wd = x.shape
    packed = k3.pack_weights(w, torch.bfloat16).float()
    pad = torch.nn.functional.pad(x, (1, t.tw + 1, 1, t.th + 1, 1, t.td + 1))
    y = torch.full_like(x, float("nan"))
    tiles_w = -(-wd // t.tw)
    gx, gy, gz = k3.grid(x.shape, t)
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                d0, h0, w0 = by * t.td, (bx // tiles_w) * t.th, (bx % tiles_w) * t.tw
                planes = pad[bz, :, d0:d0 + t.td + 2, h0:h0 + t.th + 2, w0:w0 + t.tw + 2]
                halo = planes.permute(1, 2, 3, 0).reshape(t.td + 2, -1, c)  # [plane][pos][c]
                for warp in range(k3.warps(t)):
                    for i in range(k3.MTILES[c]):
                        q = torch.arange(16) + (warp * t.g + i % t.g) * 16
                        qh, qw = q // t.tw, q % t.tw
                        acc = torch.zeros(16, c)
                        for tap in range(27):
                            kd, kh, kw = tap // 9, tap // 3 % 3, tap % 3
                            rows = halo[i // t.g + kd, (qh + kh) * (t.tw + 2) + qw + kw]
                            acc += rows @ packed[tap].T
                        dd, hh, ww = d0 + i // t.g, h0 + qh, w0 + qw
                        keep = (hh < h) & (ww < wd)
                        if dd < d:
                            y[bz, :, dd, hh[keep], ww[keep]] = acc[keep].T
    return y


@pytest.mark.parametrize("shape", [(1, 16, 3, 9, 13), (1, 32, 4, 8, 24), (2, 64, 3, 5, 12)])
def test_bf16_tiling_covers_the_volume(shape):
    """Every output voxel is written and equals the convolution (float32,
    to 1e-5 of the largest output: the sums of up to 1728 products reach
    about 30 and differ from the plain version's in summation order), under
    the planned tile and under every tile of TILES[C] that fits."""
    n, c, d, h, w = shape
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    wt = torch.from_numpy((rng.standard_normal((c, c, 3, 3, 3)) * 0.2).astype(np.float32))
    wt = wt.bfloat16().float()
    want = k3.plain_conv3d_k3(x, wt)
    tiles = {k3.plan(shape)} | {t for t in k3.TILES[c] if k3.smem_bytes(c, t) <= k3.MAX_SMEM}
    for t in sorted(tiles):
        got = emulate_bf16_kernel(x, wt, t)
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), f"tile {t}: max abs err {err}"


def _bf16_order(a: np.ndarray) -> np.ndarray:
    """bf16 values as integers in the order of the values: neighbouring
    bf16 numbers differ by 1, so a difference counts ulps."""
    u = a.view(np.uint16).astype(np.int32)
    return np.where(u & 0x8000, -(u & 0x7FFF), u)


def test_conv3d_k3_bf16_rounds_as_pallas(rng):
    """bfloat16 with a bias: the JAX kernel rounds the sum to bf16, adds the
    float32 bias and rounds again; so must the port. Only the float32
    summation order may differ, and it decides the first rounding where the
    exact sum lies within float32 error of a bf16 rounding boundary: there
    the two differ by one bf16 ulp of the sum, which is more than one ulp of
    the output where the bias shrinks it. Bar: one bf16 ulp at the larger of
    |output| and |output - bias| (the sum's magnitude); fewer than 1 % of
    the outputs apart at all."""
    x, w, b = conv_inputs(rng, (1, 16, 8, 8, 16))
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(j_conv3d_k3(xb, jnp.asarray(w, jnp.bfloat16), jnp.asarray(b),
                                  interpret=True))
    xt = ncdhw(np.asarray(xb.astype(jnp.float32))).bfloat16()
    wt = torch_weight(w).bfloat16()
    wf = want.astype(np.float32)
    magnitude = np.maximum(np.abs(wf), np.abs(wf - b))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(magnitude, 2.0 ** -126))) - 7)
    for got in (k3.plain_conv3d_k3(xt, wt, torch.from_numpy(b)),
                k3.conv3d_k3(xt, wt, torch.from_numpy(b))):
        assert got.dtype == torch.bfloat16
        gf = got.float().permute(0, 2, 3, 4, 1).numpy()
        got = got.permute(0, 2, 3, 4, 1).contiguous().view(torch.int16).numpy()
        ulps = np.abs(_bf16_order(got.view(np.uint16)) - _bf16_order(want.view(np.uint16)))
        print(f"max {ulps.max()} ulps, {(ulps > 0).sum()} of {ulps.size} outputs differ")
        assert (np.abs(gf - wf) <= ulp).all() and (ulps > 0).mean() < 0.01, (
            f"max {ulps.max()} ulps, {(ulps > 0).sum()} of {ulps.size} outputs differ")


@pytest.mark.parametrize("stride", [1, 2])
def test_conv3d_k3_routing_matches_jax(rng, stride, monkeypatch):
    """ops.conv3d(method='k3') against the JAX ops.conv3d(method='pallas'):
    stride 1 goes through K3, stride 2 (ineligible) through cuDNN's path."""
    calls = []
    kernel = k3.conv3d_k3
    monkeypatch.setattr(k3, "conv3d_k3", lambda *a: calls.append(1) or kernel(*a))
    x = rng.standard_normal((1, 8, 8, 8, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 16, 16)) * 0.1).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jops.conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), padding=1,
                                  stride=stride, method="pallas"))
    got = ops.conv3d(ncdhw(x), torch_weight(w), torch.from_numpy(b), padding=1, stride=stride,
                     method="k3")
    np.testing.assert_allclose(ndhwc(got), want, rtol=1e-5, atol=1e-5)
    assert len(calls) == (1 if stride == 1 else 0)


@pytest.mark.parametrize("flag,routed", [("0", False), ("1", True), ("tight", True)])
def test_flag_routes_only_eligible_convs(flag, routed, monkeypatch):
    """DPT_PALLAS_CONV's values, as the JAX package reads them; the
    predicate of dose_prediction_tpu/ops/conv.py:224-231."""
    calls = []
    kernel = k3.conv3d_k3
    monkeypatch.setattr(k3, "conv3d_k3", lambda *a: calls.append(1) or kernel(*a))
    monkeypatch.setattr(FLAGS, "use_k3_conv3d", flag)
    x16, x8 = torch.zeros(1, 16, 6, 6, 6), torch.zeros(1, 8, 6, 6, 6)
    w = torch.zeros(16, 16, 3, 3, 3)
    ops.conv3d(x16, w, padding=1)                                     # eligible
    ops.conv3d(x16, w, padding=1, stride=2)                           # stride
    ops.conv3d(x16, w, padding=2, dilation=2)                         # dilation
    ops.conv3d(x16, w, padding=0)                                     # padding
    ops.conv3d(x8, torch.zeros(8, 8, 3, 3, 3), padding=1)             # C = 8
    ops.conv3d(x16, torch.zeros(32, 16, 3, 3, 3), padding=1)          # C_out != C_in
    ops.conv3d(x16, torch.zeros(16, 16, 1, 1, 1))                     # 1×1×1
    assert len(calls) == (1 if routed else 0)
    with pytest.raises(ValueError, match="method"):
        ops.conv3d(x16, w, padding=1, method="pallas")


def _grads(loss, tensors):
    return [t.numpy() for t in torch.autograd.grad(loss, tensors)]


def test_conv3d_k3_gradients_match_jax(rng):
    x, w, b = conv_inputs(rng, (1, 4, 8, 16, 16))
    jg = jax.grad(lambda x_, w_, b_: jnp.sum(jnp.sin(j_conv3d_k3(x_, w_, b_, interpret=True))),
                  argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (t.requires_grad_() for t in (ncdhw(x), torch_weight(w), torch.from_numpy(b)))
    before = k3.conv3d_k3.recomputes
    gx, gw, gb = _grads(torch.sin(k3.conv3d_k3(tx, tw, tb)).sum(), [tx, tw, tb])
    assert k3.conv3d_k3.recomputes == before + 1
    np.testing.assert_allclose(gx.transpose(0, 2, 3, 4, 1), np.asarray(jg[0]),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(gw.transpose(2, 3, 4, 1, 0), np.asarray(jg[1]),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(gb, np.asarray(jg[2]), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_attention_gradients_match_jax(rng):
    q, k, v = (rng.standard_normal((1, 2, 40, 16)).astype(np.float32) for _ in range(3))
    jg = jax.grad(lambda *a: jnp.sum(j_attention(*a, interpret=True) ** 2),
                  argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = k1.fused_attention.recomputes
    got = _grads((k1.fused_attention(tq, tk, tv) ** 2).sum(), [tq, tk, tv])
    assert k1.fused_attention.recomputes == before + 1
    for g, want in zip(got, jg):
        np.testing.assert_allclose(g, np.asarray(want), rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("act", ["identity", "mish"])
def test_instance_norm_gradients_match_jax(rng, act):
    x = (rng.standard_normal((2, 4, 4, 8, 8)) * 2 + 1).astype(np.float32)
    scale = (rng.random(8) + 0.5).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jnp.sin(j_in_act(*a, act=act, interpret=True))),
                  argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, scale, bias)))
    tx, ts, tb = (t.requires_grad_() for t in (ncdhw(x), torch.from_numpy(scale),
                                                torch.from_numpy(bias)))
    before = k2.instance_norm_act.recomputes
    gx, gs, gb = _grads(torch.sin(k2.instance_norm_act(tx, ts, tb, act=act)).sum(), [tx, ts, tb])
    assert k2.instance_norm_act.recomputes == before + 1
    np.testing.assert_allclose(gx.transpose(0, 2, 3, 4, 1), np.asarray(jg[0]),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(gs, np.asarray(jg[1]), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(gb, np.asarray(jg[2]), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_wrappers_take_the_direct_route_without_grad(rng):
    """No input requires a gradient (inference): no autograd node, no
    recompute."""
    x = torch.from_numpy(rng.standard_normal((1, 16, 4, 4, 4)).astype(np.float32))
    w = torch.zeros(16, 16, 3, 3, 3, requires_grad=True)
    assert k3.conv3d_k3(x, w.detach()).grad_fn is None
    with torch.no_grad():
        assert k3.conv3d_k3(x, w).grad_fn is None
    assert k3.conv3d_k3(x, w).grad_fn is not None


def test_routed_c3d_unet_matches_jax(rng, monkeypatch):
    """A C3D BaseUNet with list_ch (-1, 16, 32, 64, 128, 256) at 16³ with the
    routing on in both packages: five convs go through K3 (the second conv
    of encoder levels 1-3 and of decoder levels 2-3)."""
    list_ch = (-1, 16, 32, 64, 128, 256)
    model = M.seeded(BaseUNet(2, list_ch), seed=3)
    tree = TI.state_dict_to_tree({k: v.numpy() for k, v in model.state_dict().items()},
                                 TI.c3d_key_map)["net_A"]
    x = rng.standard_normal((1, 16, 16, 16, 2)).astype(np.float32)
    monkeypatch.setattr(JFLAGS, "use_pallas_conv3d", "1")
    want = np.asarray(jax.jit(lambda p, x: JBaseUNet(list_ch).apply({"params": p}, x))(tree, x))
    calls = []
    kernel = k3.conv3d_k3
    monkeypatch.setattr(k3, "conv3d_k3", lambda *a: calls.append(1) or kernel(*a))
    monkeypatch.setattr(FLAGS, "use_k3_conv3d", "1")
    with torch.no_grad():
        got = model(ncdhw(x))
    assert len(calls) == 5
    assert got.shape == (1, 16, 16, 16, 16)
    np.testing.assert_allclose(ndhwc(got), want, rtol=0, atol=1e-3)
