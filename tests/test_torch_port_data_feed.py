"""The PyTorch port's training feed (dose_prediction_tpu_torch/data/{transforms,
pipeline,packed}.py) against the JAX package on the CPU.

A synthetic cohort of three 16³ patients, written once by the port's
``make_synthetic_dataset`` and loaded by each package's own loader; the JAX
reader runs without its native library (see tests/test_torch_port_data_io.py).
The same seeds go to both packages. Every comparison is bit for bit: numpy
arrays against the port's CPU tensors, bfloat16 compared as int16 bit
patterns (``Tensor.view(torch.int16)`` against ``ndarray.view(np.int16)``),
the random generators' states after the call equal too. The one exception
is the packed feed against the float32 chain (both in the port), held to the
bars of tests/test_packed_feed.py: bf16 resolution (0.012 and 0.01), masks
exact.
"""

import threading
from unittest import mock

import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu.data import native as JN  # noqa: E402
from dose_prediction_tpu.data import openkbp as JO  # noqa: E402
from dose_prediction_tpu.data import packed as JPK  # noqa: E402
from dose_prediction_tpu.data import pipeline as JPL  # noqa: E402
from dose_prediction_tpu.data import transforms as JT  # noqa: E402

from dose_prediction_tpu_torch.data import native as N  # noqa: E402
from dose_prediction_tpu_torch.data import openkbp as O  # noqa: E402
from dose_prediction_tpu_torch.data import packed as PK  # noqa: E402
from dose_prediction_tpu_torch.data import pipeline as PL  # noqa: E402
from dose_prediction_tpu_torch.data import transforms as T  # noqa: E402
from dose_prediction_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402

SIZE = 16
SEEDS = range(4)


@pytest.fixture(autouse=True)
def jax_without_native():
    with mock.patch.object(JN, "get_lib", lambda: None):
        yield


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(port dataset, JAX dataset) of one cohort; patient 1 lacks PTV63 and
    Esophagus."""
    pattern = make_synthetic_dataset(tmp_path_factory.mktemp("feed"), n_patients=3,
                                     shape=(SIZE, SIZE, SIZE), seed=11)
    with mock.patch.object(JN, "get_lib", lambda: None):
        want = JO.OpenKBPDataset(pattern, keep_structures=True, num_workers=1)
    return O.OpenKBPDataset(pattern, keep_structures=True, num_workers=1), want


@pytest.fixture(params=["native", "numpy"])
def port_native(request):
    """The port with its native library, or with the library unavailable."""
    if request.param == "native":
        assert N.native_available(), N.native_build_error()
        yield True
    else:
        with mock.patch.object(N, "get_lib", lambda: None):
            yield False


def bits(x) -> np.ndarray:
    """A port tensor or a JAX-side array as numpy, bf16 as int16 bits."""
    if torch.is_tensor(x):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


DTYPES = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16,
          torch.uint8: np.uint8, torch.int32: np.int32}


def assert_same(got, want, where="out"):
    """Recursively bit-equal: dicts, sequences, arrays or tensors, scalars."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, jax.Array)) or torch.is_tensor(got):
        want = np.asarray(want)
        if torch.is_tensor(got):
            assert DTYPES[got.dtype] == want.dtype, (where, got.dtype, want.dtype)
        else:
            assert got.dtype == want.dtype, where
        assert tuple(got.shape) == want.shape, where
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=where)
    else:
        assert got == want and type(got) is type(want), (where, got, want)


def volumes(seed=0):
    rng = np.random.default_rng(seed)
    inp = rng.standard_normal((SIZE, SIZE, SIZE, 9)).astype(np.float32)
    gt = rng.random((SIZE, SIZE, SIZE, 2)).astype(np.float32)
    labels = (rng.random((SIZE, SIZE, SIZE)) < 0.2).astype(np.float32) * 3
    return inp, gt, labels


TRANSFORMS = {
    "rand_shift_intensity": lambda M, r, inp, gt, lab: M.rand_shift_intensity(inp[..., -1], r),
    "rand_flip": lambda M, r, inp, gt, lab: M.rand_flip({"i": inp, "g": gt}, r, prob=0.5),
    "rand_rotate90": lambda M, r, inp, gt, lab: M.rand_rotate90({"i": inp, "g": gt}, r,
                                                                prob=0.7),
    "rand_crop_pos_neg": lambda M, r, inp, gt, lab: M.rand_crop_pos_neg(
        {"i": inp, "l": lab}, lab, r, spatial_size=(8, 8, 8), num_samples=3),
    "pad_to_shape": lambda M, r, inp, gt, lab: M.pad_to_shape(inp, (24, 19, 16)),
    "rand_rotate_z": lambda M, r, inp, gt, lab: M.rand_rotate_z(
        {"g": gt, "l": lab}, r, prob=0.8, orders={"l": 0}, cvals={"g": -1.0}),
    "rand_translate": lambda M, r, inp, gt, lab: M.rand_translate(
        {"i": inp, "l": lab}, lab[..., None] * (np.arange(SIZE) < 9)[:, None, None, None],
        r, prob=0.8, max_shift=3, pad_values={"i": -1.0}),
    "draw_augment_decisions": lambda M, r, inp, gt, lab: M.draw_augment_decisions(
        r, shift_prob=0.7, flip_prob=0.5, rot_prob=0.5),
    "apply_dose_augment": lambda M, r, inp, gt, lab: [
        M.apply_dose_augment(inp, gt, s, f, k)
        for s, f, k in ((0.0, 0, 0), (0.05, 5, 3), (-0.02, 2, 1), (0.07, 7, 2))],
    "augment_dose_sample": lambda M, r, inp, gt, lab: M.augment_dose_sample(inp, gt, r),
    "augment_seg_sample": lambda M, r, inp, gt, lab: M.augment_seg_sample(
        inp[..., -1], lab, r, crop=(8, 8, 20), num_samples=3),
    "draw_seg_aug_decisions": lambda M, r, inp, gt, lab: M.draw_seg_aug_decisions(
        r, flip_prob=0.5, rot_prob=0.5),
    "apply_seg_augment": lambda M, r, inp, gt, lab: [
        M.apply_seg_augment(inp[..., -1], lab.astype(np.uint8), s, f, k)
        for s, f, k in ((0.0, 0, 0), (-0.02, 6, 1), (0.03, 1, 3))],
    "seg_crop_starts": lambda M, r, inp, gt, lab: M.seg_crop_starts(
        lab.shape, lab, r, crop=(8, 8, 8), num_samples=4),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name):
    """Each transform over several seeds: the same output, bit for bit, and
    the same random stream consumed."""
    fn = TRANSFORMS[name]
    for seed in range(8):
        inp, gt, lab = volumes(seed)
        r_port, r_jax = np.random.default_rng(seed), np.random.default_rng(seed)
        assert_same(fn(T, r_port, inp, gt, lab), fn(JT, r_jax, inp, gt, lab), name)
        assert r_port.bit_generator.state == r_jax.bit_generator.state


def test_seg_crop_starts_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="does not match"):
        T.seg_crop_starts((4, 4, 4), np.zeros((4, 4, 5)), np.random.default_rng(0),
                          crop=(2, 2, 2), num_samples=1)


def assert_epochs_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert_same(g, w)
    return got


@pytest.mark.parametrize("kwargs", [
    dict(batch_size=1), dict(batch_size=2), dict(batch_size=2, drop_last=True),
    dict(batch_size=2, augment=False, shuffle=False),
    dict(batch_size=3, num_samples_per_epoch=7)], ids=str)
def test_dose_batches_match_jax(datasets, kwargs):
    port, want = datasets
    for seed in SEEDS:
        assert_epochs_equal(PL.dose_batches(port, seed=seed, **kwargs),
                            JPL.dose_batches(want, seed=seed, **kwargs))


def test_dose_batches_native_bf16_match_jax(datasets, port_native):
    """The port's fused C++ gather (or, without the library, its numpy chain)
    against the JAX numpy chain and ml_dtypes' cast: one bf16 bit pattern."""
    port, want = datasets
    for seed in range(6):
        got = assert_epochs_equal(
            PL.dose_batches(port, seed=seed, batch_size=2, native_bf16=True,
                            num_samples_per_epoch=6),
            JPL.dose_batches(want, seed=seed, batch_size=2, native_bf16=True,
                             num_samples_per_epoch=6))
        assert got[0]["input"].dtype == got[0]["gt"].dtype == torch.bfloat16


@pytest.mark.parametrize("feed_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("crop", [(8, 8, 8), (20, 20, 20)], ids=["crop8", "crop_padded"])
def test_seg_batches_match_jax(datasets, port_native, feed_dtype, crop):
    """float32 and bfloat16 crops; the bf16 feed through the native gather
    where it can run (a crop larger than the volume pads on the numpy
    chain)."""
    port, want = datasets
    for seed in SEEDS:
        kw = dict(crop=crop, num_samples=2, batch_size=3, seed=seed, feed_dtype=feed_dtype)
        got = assert_epochs_equal(PL.seg_batches(port, **kw), JPL.seg_batches(want, **kw))
        assert got[0]["labels"].dtype == torch.uint8
        assert got[0]["ct"].shape[1:] == (*crop, 1)
    kw = dict(crop=(8, 8, 8), num_samples=3, batch_size=2, drop_last=True,
              num_samples_per_epoch=5, feed_dtype=feed_dtype)
    assert_epochs_equal(PL.seg_batches(port, **kw), JPL.seg_batches(want, **kw))


def test_linked_batches_match_jax(datasets):
    port, want = datasets
    for seed in SEEDS:
        for bs in (1, 2):
            assert_epochs_equal(PL.linked_batches(port, batch_size=bs, seed=seed),
                                JPL.linked_batches(want, batch_size=bs, seed=seed))


BUILDERS = {
    "dose": (PL.dose_batches, JPL.dose_batches, dict(num_samples_per_epoch=8)),
    "dose_bf16": (PL.dose_batches, JPL.dose_batches,
                  dict(num_samples_per_epoch=8, native_bf16=True)),
    "packed": (PK.packed_dose_batches, JPK.packed_dose_batches, dict(num_samples_per_epoch=8)),
    "seg": (PL.seg_batches, JPL.seg_batches, dict(crop=(8, 8, 8), num_samples=3)),
}


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_process_rows_match_jax_and_tile_the_batch(datasets, builder):
    """Each process's rows against the JAX builder's, and the processes'
    rows together equal the whole batch's (one random stream for all)."""
    port_fn, jax_fn, kw = BUILDERS[builder]
    port, want = datasets
    whole = list(port_fn(port, batch_size=4, seed=3, drop_last=True, **kw))
    parts = []
    for pid in range(2):
        parts.append(assert_epochs_equal(
            port_fn(port, batch_size=4, seed=3, process_rows=(pid, 2), **kw),
            jax_fn(want, batch_size=4, seed=3, process_rows=(pid, 2), **kw)))
    assert len(whole) == len(parts[0]) == len(parts[1])
    for w, a, b in zip(whole, *parts):
        for k, v in w.items():
            np.testing.assert_array_equal(bits(torch.cat([a[k], b[k]])), bits(v), err_msg=k)
    with pytest.raises(ValueError, match="does not divide"):
        next(iter(port_fn(port, batch_size=3, process_rows=(0, 2), **kw)))


def test_pack_patient_matches_jax(datasets):
    port, want = datasets
    for a, b in zip(port.patients, want.patients):
        assert_same(PK.pack_patient(a), JPK.pack_patient(b))
        assert PK.pack_patient(a) is PK.pack_patient(a)      # cached on the patient


def test_pack_declines_nonbinary_masks(datasets):
    import copy

    p = copy.copy(datasets[0][1])
    p.__dict__.pop("_packed_cache", None)
    p.oars = p.oars * 0.5
    assert PK.pack_patient(p) is None and PK.pack_patient(p) is None

    class Cohort:
        patients = [p]

        def __len__(self):
            return 1

        def __getitem__(self, i):
            return p

    with pytest.raises(ValueError, match="not packable"):
        next(iter(PK.packed_dose_batches(Cohort(), batch_size=1)))
    with pytest.raises(ValueError, match="not packable"):
        next(iter(PK.packed_dose_batches(Cohort(), batch_size=2, process_rows=(0, 2))))


@pytest.mark.parametrize("kwargs", [dict(batch_size=1), dict(batch_size=2),
                                    dict(batch_size=3, augment=False, shuffle=False)], ids=str)
def test_packed_dose_batches_match_jax(datasets, kwargs):
    port, want = datasets
    for seed in SEEDS:
        assert_epochs_equal(PK.packed_dose_batches(port, seed=seed, **kwargs),
                            JPK.packed_dose_batches(want, seed=seed, **kwargs))


def every_decision_batch(port_ds):
    """A packed batch of 32 samples: every flip mask with every rot90 k,
    the patients in turn, a distinct shift each."""
    samples = [PK.pack_patient(port_ds[i % len(port_ds)]) for i in range(32)]
    batch = {k: torch.stack([s[k] for s in samples]) for k in PK.PACKED_KEYS}
    batch["flip"] = torch.arange(32, dtype=torch.int32) % 8
    batch["rot_k"] = torch.arange(32, dtype=torch.int32) // 8
    batch["shift"] = torch.linspace(-0.1, 0.1, 32, dtype=torch.float32)
    return batch


def test_unpack_matches_jax_for_every_decision(datasets):
    batch = every_decision_batch(datasets[0])
    jbatch = {k: jnp.asarray(bits(v).view(ml_dtypes.bfloat16) if v.dtype == torch.bfloat16
                             else v.numpy()) for k, v in batch.items()}
    want = jax.jit(JPK.unpack_dose_batch)(jbatch)
    got = PK.unpack_dose_batch(batch)
    assert_same(got, {k: np.asarray(v) for k, v in want.items()})
    assert got["input"].shape == (32, SIZE, SIZE, SIZE, 9)
    assert PK.unpack_dose_batch(got) is got                  # an unpacked batch passes
    with pytest.raises(ValueError, match="D == H"):
        PK.unpack_dose_batch({**batch, "ct": batch["ct"][:, :, :8]})


def test_unpack_follows_the_float32_chain(datasets):
    """The packed feed's on-card augmentation reproduces dose_batches' numpy
    chain for the same seed, at bf16 resolution; masks exact."""
    port = datasets[0]
    for seed in range(6):
        f32 = list(PL.dose_batches(port, batch_size=2, seed=seed))
        pkd = list(PK.packed_dose_batches(port, batch_size=2, seed=seed))
        assert len(f32) == len(pkd)
        for fb, pb in zip(f32, pkd):
            out = PK.unpack_dose_batch(pb)
            np.testing.assert_allclose(out["input"].numpy(), fb["input"].numpy(), atol=0.012)
            np.testing.assert_allclose(out["gt"].numpy(), fb["gt"].numpy(), atol=0.01)
            np.testing.assert_array_equal(out["input"][..., 1:8].numpy(),
                                          fb["input"][..., 1:8].numpy())


def test_batch_payloads(datasets):
    """Host→card bytes of one batch: packed 6 B a voxel, bf16 18, float32 44."""
    port = datasets[0]
    kw = dict(batch_size=2, seed=0, augment=False)
    f32 = next(iter(PL.dose_batches(port, **kw)))
    bf16 = next(iter(PL.dose_batches(port, native_bf16=True, **kw)))
    pkd = next(iter(PK.packed_dose_batches(port, **kw)))
    voxels = 2 * SIZE ** 3
    assert PK.packed_batch_nbytes(f32) == voxels * 11 * 4
    assert PK.packed_batch_nbytes(bf16) == voxels * 11 * 2
    assert PK.packed_batch_nbytes(pkd) == voxels * 6 + 2 * 12


def numbered(n, fail_at=None, made=None):
    for i in range(n):
        if i == fail_at:
            raise KeyError(f"batch {i}")
        if made is not None:
            made.append(i)
        yield {"x": torch.full((2, 3), float(i)), "i": torch.tensor([i], dtype=torch.int32)}


def test_device_prefetch_keeps_order_on_the_cpu():
    got = list(PL.device_prefetch(numbered(12), size=3, device="cpu"))
    assert [int(b["i"]) for b in got] == list(range(12))
    assert all(torch.equal(b["x"], torch.full((2, 3), float(i))) for i, b in enumerate(got))


def test_device_prefetch_raises_the_workers_error():
    seen = []
    with pytest.raises(KeyError, match="batch 4"):
        for b in PL.device_prefetch(numbered(9, fail_at=4), size=2, device="cpu"):
            seen.append(int(b["i"]))
    assert seen == [0, 1, 2, 3]


def test_device_prefetch_releases_the_worker_after_an_early_break():
    """After a break the worker stops taking batches (at most ``size`` staged
    plus one in its hands), and its thread has ended once ``close()``
    returns. The thread is watched by identity: the process's thread count
    also moves with other tests' threads under pytest-xdist."""
    made = []
    before = set(threading.enumerate())
    it = PL.device_prefetch(numbered(1000, made=made), size=2, device="cpu")
    for b in it:
        if int(b["i"]) == 3:
            break
    workers = [t for t in threading.enumerate()
               if t not in before and t.name == "device_prefetch"]
    assert len(workers) == 1
    it.close()
    assert not workers[0].is_alive()
    assert len(made) <= 4 + 2 + 1


def test_device_prefetch_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_port_cuda.py covers it")
    with pytest.raises(RuntimeError, match="cuda"):
        next(PL.device_prefetch(numbered(2), device="cuda"))
