"""The PyTorch port's CUDA kernels on a card (tests marked ``cuda``).

Each test decides inside its ``card`` fixture whether there is a card, and
skips where there is none. This file imports neither jax nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest`` because tests/conftest.py configures JAX.)
Tolerances, as in chip_smoke.py: float32 1e-4 absolute (summation order);
bfloat16 two bf16 ulps at the largest output magnitude, 2^-6 · max|want|
(the kernels round once, the plain versions round intermediate values to
bf16 too, as the JAX references do). Gradients: the wrappers' backward
recomputes the plain version, so with an upstream gradient that does not
depend on the forward they equal the plain version's own gradients up to
float32 summation order (1e-5 relative to the largest).
"""

import math

import pytest

torch = pytest.importorskip("torch")

from dose_prediction_tpu_torch.core.config import FLAGS  # noqa: E402
from dose_prediction_tpu_torch.infer.aot import LazyAOTStage  # noqa: E402
from dose_prediction_tpu_torch.infer.cascade import (  # noqa: E402
    make_cascade_fn,
    make_cascade_stages,
)
from dose_prediction_tpu_torch.kernels import attention as k1  # noqa: E402
from dose_prediction_tpu_torch.kernels import conv3d as k3  # noqa: E402
from dose_prediction_tpu_torch.kernels import cuda_lib  # noqa: E402
from dose_prediction_tpu_torch.kernels import instance_norm as k2  # noqa: E402
from dose_prediction_tpu_torch.models import UNETR, DosePyfer, HDUNet, TranSeg  # noqa: E402
from dose_prediction_tpu_torch.nn.init import init_params  # noqa: E402
from dose_prediction_tpu_torch.train import state as S  # noqa: E402
from dose_prediction_tpu_torch.train import steps  # noqa: E402

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


# the main path's two shapes, then edge lengths (one key, one partial tile,
# one key past a tile, one past eight tiles) at every head dim, then the
# dense TranSeg's shape at 128³ (8³ tokens, 12 heads of 64) and the TranSeg
# train step's (one 96³ crop: block shape (2, 2))
ATTENTION_SHAPES = [(8, 12, 216, 64), (1, 6, 512, 128), (2, 3, 70, 32)] + [
    (1, 3, length, dh) for length in (1, 16, 65, 513) for dh in (32, 64, 128)] + [
    (1, 12, 512, 64), (1, 12, 216, 64)]


def check_attention(card, shape, dtype):
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
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", ATTENTION_SHAPES)
def test_attention_kernel_matches_plain_on_card(card, shape, dtype):
    check_attention(card, shape, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("tiling", k1.TILINGS)
@pytest.mark.parametrize("shape", [(2, 3, 200, 32), (2, 3, 65, 64), (1, 2, 300, 128)])
def test_attention_bf16_tilings_match_plain_on_card(card, shape, tiling, monkeypatch):
    """Every bfloat16 block shape at every head dim, whatever the chooser
    would pick for the shape."""
    monkeypatch.setattr(k1, "bf16_tiling", lambda *args: tiling)
    check_attention(card, shape, torch.bfloat16)


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


def check_instance_norm(card, x, act, two_kernel=False):
    """K2 on ``x`` (affine drawn from a seed) against the plain version; the
    call must launch once, on the two-kernel path exactly when asked."""
    g = torch.Generator(card).manual_seed(1)
    c = x.shape[1]
    scale = torch.rand(c, generator=g, device=card) + 0.5
    bias = torch.randn(c, generator=g, device=card)
    n, n2 = k2.instance_norm_act.launches, k2.instance_norm_act.two_kernel_launches
    got = k2.instance_norm_act(x, scale, bias, act=act)
    torch.cuda.synchronize()
    assert k2.instance_norm_act.launches == n + 1
    assert k2.instance_norm_act.two_kernel_launches == n2 + int(two_kernel)
    want = k2.plain_instance_norm_act(x, scale, bias, act=act)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert (got.float() - want.float()).abs().max().item() <= tolerance(want)


def seeded_volume(card, shape, dtype):
    g = torch.Generator(card).manual_seed(0)
    return (torch.randn(shape, generator=g, device=card) * 2 + 1).to(dtype)


# ragged planes: S = 1, S = 7 (not whole 16-byte words: scalar loads) and
# S = 17,280 (two chunks of 8192 and a ragged third)
RAGGED_SHAPES = [(2, 3, 1, 1, 1), (1, 4, 1, 1, 7), (2, 3, 24, 24, 30)]


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_instance_norm_ragged_planes_on_card(card, shape, dtype, act):
    check_instance_norm(card, seeded_volume(card, shape, dtype), act)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_instance_norm_plane_of_over_100_chunks_on_card(card, dtype):
    """1,703,936 elements a plane: 104 bf16 chunks of 16384 or 208 float32
    chunks of 8192 meet on one plane."""
    x = seeded_volume(card, (1, 2, 128, 128, 104), dtype)
    chunk, resident = k2.capacity(card.index or 0, dtype, True)
    s = x[0, 0].numel()
    assert k2.plan(s, chunk, resident) == k2.SINGLE_READ and -(-s // chunk) > 100
    check_instance_norm(card, x, "mish")


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 3, 24, 24, 30), (1, 2, 128, 128, 104), (1, 4, 1, 1, 7)])
def test_instance_norm_two_kernel_path_on_card(card, shape, dtype, act, monkeypatch):
    """A card that holds one resident block (no plane fits in half of it)
    sends every call to the two-kernel path."""
    capacity = k2.capacity
    monkeypatch.setattr(k2, "capacity", lambda *args: (capacity(*args)[0], 1))
    check_instance_norm(card, seeded_volume(card, shape, dtype), act, two_kernel=True)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_instance_norm_unaligned_view_on_card(card, dtype, act, monkeypatch):
    """A view one element into its buffer is not 16-byte aligned: the
    wrapper takes the scalar-load instantiation."""
    shape = (2, 5, 16, 20, 24)
    buf = seeded_volume(card, (1 + math.prod(shape),), dtype)
    x = buf[1:].view(shape)
    assert x.data_ptr() % 16 != 0
    vectors, capacity = [], k2.capacity
    monkeypatch.setattr(k2, "capacity", lambda i, d, v: vectors.append(v) or capacity(i, d, v))
    check_instance_norm(card, x, act)
    assert vectors == [False]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_instance_norm_replays_from_a_cuda_graph(card, dtype):
    """The counters' memset and the kernel replay: every replay starts from
    zeroed counters and gives the plain version's result."""
    x = seeded_volume(card, (2, 16, 24, 20, 36), dtype)
    want = k2.plain_instance_norm_act(x, act="gelu")
    k2.instance_norm_act(x, act="gelu")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k2.instance_norm_act(x, act="gelu")
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert (out.float() - want.float()).abs().max().item() <= tolerance(want)


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


ZOO_CFG = dict(feature_size=4, hidden_size=64, mlp_dim=128, num_layers=4, num_heads=2)
ZOO_MODELS = {
    "unetr": lambda card: UNETR(img_size=32, device=card, **ZOO_CFG),
    "transeg-old": lambda card: TranSeg(img_size=32, block_family="old", device=card, **ZOO_CFG),
    "transeg-ablation": lambda card: TranSeg(img_size=32, block_family="ablation", device=card,
                                             **ZOO_CFG),
    "hdunet": lambda card: HDUNet(growth_rate=4, upsample_chan=8, device=card),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(ZOO_MODELS))
def test_zoo_models_kernels_match_plain_on_card(card, monkeypatch, name, dtype):
    """A small UNETR, 'old' and 'ablation' TranSeg and HD-UNet at 32³, eval
    mode, K3 routing on (HD-UNet's 64- and 32-channel decoder convs take
    it), TF32 off, through the kernels and with the plain versions swapped
    in. Seg logits: at least 99.9 % of the argmax labels equal in float32,
    99 % in bf16 (the kernels round once where the plain versions round
    twice, and a near-tie goes either way); HD-UNet's dose within 1e-3 of
    its largest value in float32, 2⁻⁴ (a few bf16 ulps through eleven
    levels) in bf16. K2 launches, and K1 where the model has attention."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(FLAGS, "use_k3_conv3d", "1")
    g = torch.Generator(card).manual_seed(0)
    model = init_params(ZOO_MODELS[name](card), g).eval()
    channels = 9 if name == "hdunet" else 1
    x = torch.randn((2, channels, 32, 32, 32), generator=g, device=card).to(dtype)
    before = (k1.fused_attention.launches, k2.instance_norm_act.launches,
              k3.conv3d_k3.launches)
    with torch.no_grad():
        got = model(x)
        torch.cuda.synchronize()
        after = (k1.fused_attention.launches, k2.instance_norm_act.launches,
                 k3.conv3d_k3.launches)
        monkeypatch.setattr(k1, "fused_attention", k1.plain_attention)
        monkeypatch.setattr(k2, "instance_norm_act", k2.plain_instance_norm_act)
        monkeypatch.setattr(k3, "conv3d_k3", k3.plain_conv3d_k3)
        want = model(x)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert after[1] > before[1] and (after[0] > before[0]) == (name != "hdunet")
    if name == "hdunet":
        assert after[2] > before[2]
        bar = 1e-3 if dtype == torch.float32 else 2.0 ** -4
        assert (got.float() - want.float()).abs().max().item() <= bar * want.float().abs().max()
    else:
        agree = (got.argmax(1) == want.argmax(1)).float().mean().item()
        assert agree >= (0.999 if dtype == torch.float32 else 0.99)


@pytest.mark.cuda
@pytest.mark.parametrize("switch", ["attention", "instance_norm"])
def test_off_switches_stop_their_kernel_on_card(card, monkeypatch, switch):
    """A reduced bf16 TranSeg forward launches K1 and K2; with
    DPT_PALLAS_ATTENTION=0 (or DPT_PALLAS_IN=0) the switched kernel launches
    0 times and the other as often as with both on."""
    g = torch.Generator(card).manual_seed(0)
    seg = init_params(TranSeg(img_size=32, feature_size=4, hidden_size=64, mlp_dim=128,
                              num_layers=4, num_heads=2, device=card), g).eval()
    x = torch.randn((2, 1, 32, 32, 32), generator=g, device=card).bfloat16()

    def launches():
        before = (k1.fused_attention.launches, k2.instance_norm_act.launches)
        with torch.no_grad():
            out = seg(x)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all())
        after = (k1.fused_attention.launches, k2.instance_norm_act.launches)
        return dict(zip(("attention", "instance_norm"), (a - b for a, b in zip(after, before))))

    both = launches()
    assert both["attention"] > 0 and both["instance_norm"] > 0
    if switch == "attention":
        monkeypatch.setattr(FLAGS, "use_k1_attention", False)
    else:
        monkeypatch.setattr(FLAGS, "use_k2_instance_norm", "0")
    assert launches() == {**both, switch: 0}


# ragged H and W (7, 13, 17, 33: not multiples of a tile, W not a multiple
# of 8), W = 24 and 48 (the bf16 tile's choice), D = 1 and 2 (the depth
# edges), N up to 8 (8 at C = 64), with and without bias
K3_CASES = [((2, 16, 5, 7, 13), True), ((1, 32, 9, 10, 20), False), ((1, 64, 4, 8, 16), True),
            ((3, 16, 6, 17, 33), True), ((1, 32, 6, 16, 24), True), ((1, 16, 4, 8, 48), False),
            ((1, 64, 1, 9, 12), True), ((2, 32, 2, 13, 7), True), ((8, 64, 3, 8, 16), True),
            ((1, 16, 3, 33, 13), False),
            ((1, 16, 96, 96, 96), True)]     # the routed TranSeg train step's first level


def k3_inputs(card, shape, dtype, bias=True):
    c = shape[1]
    g = torch.Generator(card).manual_seed(0)
    x = torch.randn(shape, generator=g, device=card).to(dtype)
    w = (torch.rand((c, c, 3, 3, 3), generator=g, device=card) * 2 - 1) / (27 * c) ** 0.5
    b = torch.randn(c, generator=g, device=card) if bias else None
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,bias", K3_CASES)
def test_conv3d_k3_kernel_matches_plain_on_card(card, shape, bias, dtype, monkeypatch):
    """The plain version's float32 convolution runs with TF32 off."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, w, b = k3_inputs(card, shape, dtype, bias)
    n = k3.conv3d_k3.launches
    got = k3.conv3d_k3(x, w, b)
    torch.cuda.synchronize()
    assert k3.conv3d_k3.launches == n + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = k3.plain_conv3d_k3(x, w, b)
    assert (got.float() - want.float()).abs().max().item() <= tolerance(want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv3d_k3_unaligned_view_on_card(card, dtype, monkeypatch):
    """A contiguous view one element into its buffer: its data pointer is not
    16-byte aligned."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    shape = (2, 32, 4, 16, 24)
    x0, w, b = k3_inputs(card, shape, dtype)
    buf = torch.empty(1 + x0.numel(), dtype=dtype, device=card)
    buf[1:].copy_(x0.flatten())
    x = buf[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got, want = k3.conv3d_k3(x, w, b), k3.plain_conv3d_k3(x, w, b)
    assert (got.float() - want.float()).abs().max().item() <= tolerance(want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv3d_k3_replays_from_a_cuda_graph(card, dtype):
    """Captured in a CUDA graph and replayed, K3 gives what a direct call
    gives."""
    x, w, b = k3_inputs(card, (2, 32, 6, 16, 24), dtype)
    want = k3.conv3d_k3(x, w, b)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k3.conv3d_k3(x, w, b)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_conv3d_k3_kernel_refuses_other_widths(card):
    with pytest.raises(ValueError, match="C in"):
        k3.conv3d_k3(torch.zeros(1, 8, 4, 4, 4, device=card), torch.zeros(8, 8, 3, 3, 3,
                                                                          device=card))


def _grads_match(fn, plain, inputs, kwargs=None):
    kwargs = kwargs or {}
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves, **kwargs)
    r = torch.randn(out.shape, generator=torch.Generator(out.device).manual_seed(1),
                    device=out.device)
    got = torch.autograd.grad((out.float() * r).sum(), leaves)
    ref_leaves = [t.detach().requires_grad_() for t in inputs]
    want = torch.autograd.grad((plain(*ref_leaves, **kwargs).float() * r).sum(), ref_leaves)
    for a, b in zip(got, want):
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= 1e-5 * max(scale, 1e-30)


@pytest.mark.cuda
def test_autograd_wrappers_match_plain_on_card(card, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(card).manual_seed(0)
    counts = [f.launches + f.recomputes for f in
              (k1.fused_attention, k2.instance_norm_act, k3.conv3d_k3)]
    qkv = [torch.randn((2, 3, 70, 32), generator=g, device=card) for _ in range(3)]
    _grads_match(k1.fused_attention, k1.plain_attention, qkv)
    x = torch.randn((2, 16, 6, 10, 12), generator=g, device=card) * 2 + 1
    scale, bias = torch.rand(16, generator=g, device=card) + 0.5, torch.randn(16, device=card)
    _grads_match(k2.instance_norm_act, k2.plain_instance_norm_act, [x, scale, bias],
                 {"act": "mish"})
    w = torch.randn((16, 16, 3, 3, 3), generator=g, device=card) * 0.05
    _grads_match(k3.conv3d_k3, k3.plain_conv3d_k3, [x, w, bias])
    after = [f.launches + f.recomputes for f in
             (k1.fused_attention, k2.instance_norm_act, k3.conv3d_k3)]
    assert all(a == b + 2 for a, b in zip(after, counts))   # one launch, one recompute each


@pytest.mark.cuda
def test_train_step_on_card(card, monkeypatch):
    """One reduced DOSE-PYFER step at 32³ with K3 routing on, float32, TF32
    off: through the kernels it launches K1, K2 and K3 and recomputes each in
    the backward, and its loss agrees with the same step through the plain
    versions to a relative 1e-5."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(FLAGS, "use_k3_conv3d", "1")
    cfg = dict(list_ch_A=(-1, 16, 32, 64, 128, 256), img_size=32, feature_size=16,
               hidden_size=64, mlp_dim=128, num_layers=4, num_heads=2, device=card)
    g = torch.Generator(card).manual_seed(0)
    x = torch.randn((1, 32, 32, 32, 9), generator=g, device=card)
    gt = torch.cat([torch.rand((1, 32, 32, 32, 1), generator=g, device=card),
                    (torch.rand((1, 32, 32, 32, 1), generator=g, device=card) < 0.6).float()],
                   dim=-1)
    losses = []
    for plain in (False, True):
        model = init_params(DosePyfer(**cfg), torch.Generator(card).manual_seed(1))
        opt = S.make_optimizer(model, learning_rate=1e-4, weight_decay=1e-4,
                               freeze_labels=S.cascade_freeze_labels(model))
        step = steps.make_pyfer_train_step(model, opt)
        if plain:
            monkeypatch.setattr(k1, "fused_attention", k1.plain_attention)
            monkeypatch.setattr(k2, "instance_norm_act", k2.plain_instance_norm_act)
            monkeypatch.setattr(k3, "conv3d_k3", k3.plain_conv3d_k3)
        wrappers = (k1.fused_attention, k2.instance_norm_act, k3.conv3d_k3)
        before = [(f.launches, f.recomputes) for f in wrappers] if not plain else []
        _, loss = step(S.TrainState(model, opt), {"input": x, "gt": gt})
        torch.cuda.synchronize()
        for f, (launches, recomputes) in zip(wrappers, before):
            assert f.launches > launches and f.recomputes > recomputes
        assert bool(torch.isfinite(loss))
        losses.append(float(loss))
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_instance_norm_at_the_c3d_train_step_shape_on_card(card, dtype):
    """K2 at (1, 32, 128³), the C3D cascade's first level, on the path its
    planner chooses for the card."""
    shape = (1, 32, 128, 128, 128)
    chunk, resident = k2.capacity(card.index or 0, dtype, True)
    two_kernel = k2.plan(math.prod(shape[2:]), chunk, resident) != k2.SINGLE_READ
    check_instance_norm(card, seeded_volume(card, shape, dtype), "relu", two_kernel=two_kernel)


class _Leaves(torch.nn.Module):
    """Leaves above adam8bit's min_quantize_size (4096): 5120 elements (the
    last block padded) and 8192; below it: 100 and 3000."""

    def __init__(self):
        super().__init__()
        for name, shape in (("a", (64, 80)), ("b", (8192,)), ("c", (100,)), ("d", (3000,))):
            self.register_parameter(name, torch.nn.Parameter(torch.zeros(shape)))


def optimizer_on(device, kind, seed=0):
    """Three updates of ``kind`` with freeze-free AdamW weight decay, a
    cosine schedule and clip 1.0, on fixed seeded parameters and gradients
    (drawn on the CPU, then moved)."""
    g = torch.Generator().manual_seed(seed)
    model = _Leaves()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    grads = [[torch.randn(p.shape, generator=g) * 10.0 ** (torch.rand(p.shape, generator=g) * 4 - 3)
              for p in model.parameters()] for _ in range(3)]
    model = model.to(device)
    opt = S.make_optimizer(model, learning_rate=S.cosine_schedule(1e-2, 4), weight_decay=1e-2,
                           grad_clip_norm=1.0, kind=kind)
    for step_grads in grads:
        for p, gr in zip(model.parameters(), step_grads):
            p.grad = gr.to(device)
        opt.step()
    return [p.detach().cpu() for p in model.parameters()]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["adamw", "adam8bit"])
def test_optimizers_on_card_match_the_cpu(card, kind):
    """The multi-tensor Adam and adam8bit on CUDA tensors against the same
    three updates on the CPU. Adam: within 1e-6 (parameters of order 1;
    the card's and the CPU's elementwise operations round alike, the clip's
    norm sums in another order). adam8bit: the float32 log and exp of the
    two devices may differ in a last bit, which can move a code by one step
    where a value lies on a rounding boundary: all but 0.1 % of the
    elements within 1e-6, and every element within 3 × 5 × lr (one step
    moves an element by at most about 3 · lr)."""
    cpu, gpu = optimizer_on("cpu", kind), optimizer_on(card, kind)
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(cpu, gpu)])
    if kind == "adamw":
        assert diffs.max().item() <= 1e-6
    else:
        assert (diffs > 1e-6).float().mean().item() <= 1e-3
        assert diffs.max().item() <= 3 * 5 * 1e-2


def host_batches(n, made=None):
    """``n`` seeded host batches in the dose feed's dtypes (float32, bf16,
    uint8), made on the CPU."""
    g = torch.Generator().manual_seed(0)
    for i in range(n):
        if made is not None:
            made.append(i)
        yield {"input": torch.randn((1, 32, 32, 32, 9), generator=g),
               "gt": torch.rand((1, 32, 32, 32, 2), generator=g).to(torch.bfloat16),
               "labels": torch.randint(0, 8, (1, 32, 32, 32), generator=g).to(torch.uint8),
               "i": torch.tensor([i], dtype=torch.int32)}


@pytest.mark.cuda
def test_device_prefetch_on_card(card):
    """Pinned copies on a side stream: every batch on the card, in order,
    equal to its host batch, usable on the compute stream at once (a kernel
    reads it before any synchronisation); an early break ends the worker."""
    from dose_prediction_tpu_torch.data.pipeline import device_prefetch

    want = list(host_batches(8))
    got = []
    for batch in device_prefetch(host_batches(8), size=2, device=card):
        assert all(v.device.type == "cuda" for v in batch.values())
        got.append({k: (v.float() * 2).cpu() if v.is_floating_point() else v.cpu()
                    for k, v in batch.items()})
    assert [int(b["i"]) for b in got] == list(range(8))
    for g_, w in zip(got, want):
        for k, v in w.items():
            assert torch.equal(g_[k], v.float() * 2 if v.is_floating_point() else v), k
    made = []
    it = device_prefetch(host_batches(100, made), size=2, device=card)
    next(it)
    it.close()
    assert len(made) <= 1 + 2 + 1


@pytest.mark.cuda
def test_unpack_on_card_matches_the_cpu(card):
    """The packed feed's unpack and augmentation on the card against the
    CPU's, bit for bit, for every flip mask and rot90 k."""
    from dose_prediction_tpu_torch.data.packed import unpack_dose_batch

    g = torch.Generator().manual_seed(1)
    n, s = 32, 24
    batch = {"ct": (torch.randn((n, s, s, s), generator=g) * 0.5).to(torch.bfloat16),
             "dose": torch.rand((n, s, s, s), generator=g).to(torch.bfloat16),
             "ptv": torch.tensor([0, 56, 63, 70, 119, 189], dtype=torch.uint8)[
                 torch.randint(0, 6, (n, s, s, s), generator=g)],
             "mask_bits": torch.randint(0, 256, (n, s, s, s), generator=g).to(torch.uint8),
             "shift": torch.rand(n, generator=g) * 0.2 - 0.1,
             "flip": torch.arange(n, dtype=torch.int32) % 8,
             "rot_k": torch.arange(n, dtype=torch.int32) // 8}
    cpu = unpack_dose_batch(batch)
    gpu = unpack_dose_batch({k: v.to(card) for k, v in batch.items()})
    for k in ("input", "gt"):
        assert gpu[k].device.type == "cuda"
        assert torch.equal(gpu[k].cpu().view(torch.int32), cpu[k].view(torch.int32)), k


@pytest.mark.cuda
def test_dosegan_step_on_card_matches_the_cpu(card, monkeypatch):
    """One float32 DoseGAN step (ngf = ndf = 4, 32³, TF32 off) on the card
    against the port on the CPU from the same weights, by chip_smoke.py's
    gan_parity rule: both losses within rel 1e-5, each gradient leaf and
    BatchNorm buffer within its own noise-run limit; no K1, K2 or K3."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    chip_smoke.zero_counts()
    row = chip_smoke.gan_parity(card)
    assert not row["failed"] and max(row["loss_rel_diff"].values()) <= 1e-5
    assert row["worst_grad_ratio"] <= 1.0 and row["worst_buffer_ratio"] <= 1.0
    assert not any(chip_smoke.read_counts().values())


def seeded_on(model, seed):
    """``model``'s weights drawn on the CPU from ``seed``, norm affines and
    BatchNorm statistics off 1/0."""
    g = torch.Generator().manual_seed(seed)
    init_params(model, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.uniform_(-0.2, 0.2, generator=g)
                m.running_var.uniform_(0.8, 1.3, generator=g)
            if isinstance(m, (torch.nn.InstanceNorm3d, torch.nn.BatchNorm3d,
                              torch.nn.LayerNorm)) and m.weight is not None:
                m.weight.uniform_(0.7, 1.3, generator=g)
                m.bias.uniform_(-0.2, 0.2, generator=g)
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vitgan", "exp", "resnet10"])
@pytest.mark.parametrize("train", [False, True])
def test_experiments_models_on_card_match_the_cpu(card, monkeypatch, name, train):
    """ViT-GAN's and the exp model's generators (hidden size 64, 2 heads: K1
    takes head dims 32-128; feature size 2) and ResNet-10 (widths 4-32) at
    32³, float32 with TF32 off, on the card (K1 and K2 where the model has
    them) against the same weights on the CPU: every output within 1e-3 of
    its largest |value| (the cascade parity bar of chip_smoke.py)."""
    from dose_prediction_tpu_torch.models import experiments as E

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    vit = dict(img_size=32, hidden_size=64, mlp_dim=128, num_layers=2, num_heads=2,
               feature_size=2, mode_multi_dec=True, act="mish")

    def make(device):
        if name == "resnet10":
            return E.resnet10(widths=(4, 8, 16, 32), device=device)
        return E.VitGenerator(multiS_conv=name == "exp", device=device, **vit)

    cpu = seeded_on(make("cpu"), seed=3)
    gpu = make(card)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 1 if name == "resnet10" else 9, 32, 32, 32),
                    generator=torch.Generator().manual_seed(4))
    k1.fused_attention.launches = k2.instance_norm_act.launches = 0
    with torch.no_grad():
        want, got = cpu.train(train)(x), gpu.train(train)(x.to(card))
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    for w, g in zip(want, got):
        assert g.device.type == "cuda" and torch.isfinite(g).all()
        assert float((g.cpu() - w).abs().max()) <= 1e-3 * float(w.abs().max())
    if name != "resnet10":
        assert k1.fused_attention.launches > 0 and k2.instance_norm_act.launches > 0
    for key, value in cpu.state_dict().items():         # BatchNorm statistics alike
        assert torch.allclose(gpu.state_dict()[key].cpu().float(), value.float(),
                              rtol=1e-4, atol=1e-6), key


@pytest.mark.cuda
def test_vitgan_step_on_card_matches_the_cpu(card, monkeypatch):
    """The ViT-GAN step in its three modes (train_d, no train_d, freeze_d
    with a mask) on the card against the CPU, by chip_smoke.py's
    vitgan_parity rule."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rows = chip_smoke.vitgan_parity(card)
    assert set(rows) == {"train_d", "no_train_d", "freeze_d"}
    assert all(r["loss_rel_diff"][0] <= 1e-5 and r["worst_grad_ratio"] <= 1.0
               and r["loss_rel_diff"][1] <= max(1e-5, r["d_loss_limit"]) for r in rows.values())


def small_cascade(card, **kwargs):
    """A bf16 48³ cascade of small models (head dim 32) over 32³ windows,
    sw batch 4, through make_cascade_fn with ``kwargs`` (aot)."""
    cfg = dict(feature_size=4, hidden_size=64, mlp_dim=128, num_layers=2, num_heads=2,
               device=card)
    g = torch.Generator(card).manual_seed(0)
    seg = init_params(TranSeg(img_size=32, **cfg), g)
    dose = init_params(DosePyfer(list_ch_A=(-1, 4, 8, 16, 32, 64), img_size=48, **cfg), g)
    return make_cascade_fn(seg, seg.state_dict(), dose, dose.state_dict(), roi_size=(32, 32, 32),
                           sw_batch_size=4, input_dtype=torch.bfloat16, **kwargs)


def small_volumes(card, seed):
    g = torch.Generator(card).manual_seed(seed)
    shape = (1, 48, 48, 48, 1)
    return (torch.randn(shape, generator=g, device=card),
            (torch.rand(shape, generator=g, device=card) < 0.1).float(),
            (torch.rand(shape, generator=g, device=card) < 0.6).float())


def kernel_counts():
    return (k1.fused_attention.launches, k2.instance_norm_act.launches, k3.conv3d_k3.launches)


def request_launches(run, vols):
    """The output of one request and the kernels' launches it counted."""
    before = kernel_counts()
    out = run(*vols)
    torch.cuda.synchronize()
    return out, tuple(b - a for a, b in zip(before, kernel_counts()))


@pytest.mark.cuda
@pytest.mark.parametrize("k3_route", ["0", "1"])
def test_captured_cascade_equals_eager_on_card(card, monkeypatch, k3_route):
    """A captured request (the first call captures, the others replay) is
    the eager request bit for bit, and each replay credits the kernels'
    launches the eager request counts, K3 included when routed."""
    monkeypatch.setattr(FLAGS, "use_k3_conv3d", k3_route)
    vols = small_volumes(card, 0)
    want, eager = request_launches(small_cascade(card), vols)
    run = small_cascade(card, aot=True)
    run(*vols)
    for _ in range(2):
        got, launches = request_launches(run, vols)
        assert torch.equal(got, want) and launches == eager
    assert eager[0] > 0 and eager[1] > 0 and (eager[2] > 0) == (k3_route == "1")
    assert all(s.used_aot and s.captures == 1 for s in run.stages)


@pytest.mark.cuda
def test_captured_outputs_are_not_aliased_on_card(card):
    """Two requests in a row: the first output survives the second replay."""
    run, eager = small_cascade(card, aot=True), small_cascade(card)
    a_in, b_in = small_volumes(card, 0), small_volumes(card, 1)
    a = run(*a_in)
    b = run(*b_in)
    torch.cuda.synchronize()
    assert torch.equal(a, eager(*a_in)) and torch.equal(b, eager(*b_in))
    assert not torch.equal(a, b)


@pytest.mark.cuda
def test_captured_stage_keys_on_card(card, monkeypatch):
    """A routing flag or a new input shape captures again; DPT_NO_AOT=1 runs
    the eager stage."""
    w = {"w": torch.full((4,), 2.0, device=card)}
    stage = LazyAOTStage("scale", lambda v, x: x * v["w"])
    x = torch.ones(3, 4, device=card)
    assert torch.equal(stage(w, x), 2 * x) and stage.captures == 1
    assert torch.equal(stage(w, 3 * x), 6 * x) and stage.captures == 1
    monkeypatch.setattr(FLAGS, "use_k3_conv3d", "0" if FLAGS.use_k3_conv3d == "1" else "1")
    stage(w, x)
    assert stage.captures == 2
    stage(w, torch.ones(5, 4, device=card))
    assert stage.captures == 3
    monkeypatch.setenv("DPT_NO_AOT", "1")
    assert torch.equal(stage(w, x), 2 * x) and stage.used_aot is False and stage.captures == 3


@pytest.mark.cuda
def test_failed_capture_names_the_stage_on_card(card):
    """A host read inside a stage cannot be captured: the call raises with
    the stage's name instead of running eager."""
    stage = LazyAOTStage("host_read", lambda v, x: x * float(x.sum()))
    with pytest.raises(RuntimeError, match="'host_read'.*capture failed"):
        stage({"w": torch.ones(1, device=card)}, torch.ones(4, device=card))


def small_train_step(card, kind, option):
    """A small DOSE-PYFER at 32³ or a small TranSeg on 32³ crops (head dim
    32), weights from one seed, with its optimizer (``option``: adamw,
    adam8bit, grad_accum=2 or remat_blocks) and its step."""
    from dose_prediction_tpu_torch.train.state import TrainState

    cfg = dict(img_size=32, feature_size=16, hidden_size=64, mlp_dim=128, num_heads=2,
               remat_blocks=option == "remat_blocks", device=card)
    if kind == "pyfer":
        model = DosePyfer(list_ch_A=(-1, 16, 32, 64, 128, 256), num_layers=4, **cfg)
    else:
        model = TranSeg(out_ch=8, num_layers=2, **cfg)
    model = init_params(model, torch.Generator(card).manual_seed(1))
    opt = S.make_optimizer(model, learning_rate=1e-3, weight_decay=1e-4,
                           kind="adam8bit" if option == "adam8bit" else "adamw",
                           grad_accum=2 if option == "grad_accum=2" else 1,
                           freeze_labels=S.cascade_freeze_labels(model) if kind == "pyfer"
                           else None)
    step = (steps.make_pyfer_train_step(model, opt) if kind == "pyfer"
            else steps.make_transeg_train_step(model, opt))
    return model, step, TrainState(model, opt)


def small_train_batches(card, kind, n=2):
    g = torch.Generator(card).manual_seed(2)
    shape = (1, 32, 32, 32)
    if kind == "transeg":
        return [{"ct": torch.randn((*shape, 1), generator=g, device=card),
                 "labels": torch.randint(0, 8, shape, generator=g, device=card).to(torch.uint8)}
                for _ in range(n)]
    return [{"input": torch.randn((*shape, 9), generator=g, device=card),
             "gt": torch.stack([torch.rand(shape, generator=g, device=card),
                                (torch.rand(shape, generator=g, device=card) < 0.6).float()],
                               dim=-1)} for _ in range(n)]


def train_runs(card, kind, option, calls=4, restore_at=None, tmp_path=None):
    """Two eager runs and a captured one of ``calls`` steps from the same
    weights and batches: per run the initial parameters, each call's loss
    and parameters after it, the stage and each captured call's credited
    launches. ``restore_at``: the slot written after the first call is
    restored after call ``restore_at``."""
    from dose_prediction_tpu_torch.core import checkpoint as C
    from dose_prediction_tpu_torch.infer.aot import LazyTrainStage

    batches = small_train_batches(card, kind)
    runs = {}
    for name in ("eager_a", "eager_b", "captured"):
        model, step, state = small_train_step(card, kind, option)
        stage = None
        if name == "captured":
            step = stage = LazyTrainStage(f"train:{kind}", step)
        first = [p.detach().clone() for p in model.parameters()]
        rows, launches = [], []
        for i in range(calls):
            before = kernel_counts()
            state, loss = step(state, batches[i % len(batches)])
            torch.cuda.synchronize()
            launches.append(tuple(b - a for a, b in zip(before, kernel_counts())))
            rows.append((float(loss), [p.detach().clone() for p in model.parameters()]))
            if restore_at is not None and i == 0:
                C.save_checkpoint(tmp_path / f"{name}.pt", {"state": state, "epoch": 0})
            if restore_at is not None and i + 1 == restore_at:
                state = C.restore_checkpoint(tmp_path / f"{name}.pt",
                                             {"state": state, "epoch": 0})["state"]
        runs[name] = (first, rows, stage, launches)
    return runs


def assert_captured_within_eager_spread(runs):
    """After each call the captured run equals the first eager run bit for
    bit where the two eager runs are equal bit for bit; otherwise (a cuDNN
    weight gradient or the trilinear backward may add with atomics) its
    loss lies within max(1e-5, 2 × the eager runs' relative difference) of
    the nearer eager run's, and each parameter's displacement from the
    initial weights within max(1e-3, 2 × the eager runs' worst relative
    departure) × that displacement's largest |value|, chip_smoke.py's rule
    for a step's gradients."""
    first, a, _, _ = runs["eager_a"]
    _, b, _, _ = runs["eager_b"]
    _, c, _, _ = runs["captured"]
    for i, ((la, pa), (lb, pb), (lc, pc)) in enumerate(zip(a, b, c)):
        if la == lb and all(torch.equal(x, y) for x, y in zip(pa, pb)):
            assert lc == la and all(torch.equal(x, y) for x, y in zip(pa, pc)), i
            continue
        assert min(abs(lc - la), abs(lc - lb)) <= max(1e-5, 2 * abs(lb - la) / abs(la)) * abs(
            la), (i, la, lb, lc)
        scale = [max((x - p0).abs().max().item(), 1e-30) for x, p0 in zip(pa, first)]
        noise = max((y - x).abs().max().item() / s for x, y, s in zip(pa, pb, scale))
        for j, (x, z, s) in enumerate(zip(pa, pc, scale)):
            assert (z - x).abs().max().item() <= max(1e-3, 2 * noise) * s, (i, j)


@pytest.mark.cuda
@pytest.mark.parametrize("option", ["adamw", "adam8bit", "grad_accum=2", "remat_blocks"])
@pytest.mark.parametrize("kind", ["pyfer", "transeg"])
def test_captured_train_step_matches_eager_on_card(card, monkeypatch, kind, option):
    """Four float32 steps (TF32 off, cuDNN's deterministic algorithms: with
    net_A frozen neither step runs a trilinear backward, so two eager runs
    agree bit for bit) captured against eager on the same weights and
    batches (assert_captured_within_eager_spread); one capture per
    MultiSteps phase; each replay credits the launches an eager step
    counts, K1 and K2 among them."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.delenv("DPT_NO_AOT", raising=False)
    runs = train_runs(card, kind, option)
    assert_captured_within_eager_spread(runs)
    stage, credited, eager = runs["captured"][2], runs["captured"][3], runs["eager_a"][3]
    assert stage.used_aot and stage.captures == (2 if option == "grad_accum=2" else 1)
    assert credited == eager and eager[0][0] > 0 and eager[0][1] > 0


@pytest.mark.cuda
def test_captured_train_step_recaptures_after_restore_on_card(card, monkeypatch, tmp_path):
    """Three steps, the first step's slot restored, two more: the restore
    replaces the optimizer's state tensors, so the stage captures again,
    and every step stays within the eager runs' spread (TF32 off, cuDNN's
    deterministic algorithms)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.delenv("DPT_NO_AOT", raising=False)
    runs = train_runs(card, "pyfer", "adamw", calls=5, restore_at=3, tmp_path=tmp_path)
    assert_captured_within_eager_spread(runs)
    assert runs["captured"][2].captures == 2


@pytest.mark.cuda
def test_concurrent_trial_captures_on_card(card, monkeypatch):
    """Two threads on one card, as run_search's concurrent trials: each
    round both take a fresh captured TranSeg step, meet at a barrier, and
    call it three times (a capture, then replays); every call succeeds and
    every loss is finite. Entering a capture synchronizes the device and
    empties the allocator's cache; LazyTrainStage's lock keeps that out of
    the other thread's capture in flight. The first round also loads the
    kernel library from both threads at once (built first where it is not,
    one build at a time). The models are built before the threads start: a draw from the default CUDA generator in one thread
    while another captures raises "Offset increment outside graph capture"
    (the generator is in capture mode for the whole process), which the
    lock does not cover."""
    import threading

    from dose_prediction_tpu_torch.infer.aot import LazyTrainStage

    monkeypatch.delenv("DPT_NO_AOT", raising=False)
    rounds, barrier, failures = 8, threading.Barrier(2, timeout=120), []
    batches = small_train_batches(card, "transeg")
    built = [[small_train_step(card, "transeg", "adamw")[1:] for _ in range(rounds)]
             for _ in range(2)]

    def trial(t):
        for r, (step, state) in enumerate(built[t]):
            stage = LazyTrainStage(f"train:trial{t}", step)
            try:
                barrier.wait()
                for i in range(3):
                    state, loss = stage(state, batches[i % len(batches)])
                    assert math.isfinite(float(loss))
            except Exception as e:     # noqa: BLE001 - the other thread is released
                failures.append((t, r, f"{type(e).__name__}: {e}"[:300]))
                barrier.abort()
                return

    threads = [threading.Thread(target=trial, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    print(f"{len(failures)} of {2 * rounds} trial rounds failed: {failures}")
    assert failures == []


@pytest.mark.cuda
def test_captured_train_step_refusals_on_card(card, monkeypatch):
    """A step that reads its loss on the host cannot be captured: the call
    raises, naming the stage. DPT_NO_AOT=1 runs the eager step."""
    from dose_prediction_tpu_torch.infer.aot import LazyTrainStage

    model, step, state = small_train_step(card, "transeg", "adamw")
    batch = small_train_batches(card, "transeg", 1)[0]

    def reads_its_loss(state, batch):
        state, loss = step(state, batch)
        return state, loss * float(loss)

    monkeypatch.delenv("DPT_NO_AOT", raising=False)
    with pytest.raises(RuntimeError, match="'train:host_read'.*capture failed"):
        LazyTrainStage("train:host_read", reads_its_loss)(state, batch)
    monkeypatch.setenv("DPT_NO_AOT", "1")
    stage = LazyTrainStage("train:transeg", step)
    state, loss = stage(state, batch)
    assert stage.used_aot is False and stage.captures == 0 and bool(torch.isfinite(loss))
