"""The PyTorch port's data I/O (dose_prediction_tpu_torch/data/{nifti,native,
openkbp,synthetic,private_seg,openkbp_prepare}.py) against the JAX package
on the CPU.

Volumes are made with numpy from seeds and written to ``tmp_path``. Every
comparison is exact: arrays bit for bit, affines and spacings equal, except
the native reader's qform affine, which the C++ code computes in double and
stores as float32 (relative 1e-6). ``write_nifti`` gzips with an mtime in the
header, so files are compared decompressed.

The JAX package's reader runs without its native library here: its
``get_lib`` runs ``make -C native``, which writes ``native/libdose_io.so``,
the file tests/test_native.py builds in another worker. The port builds its
own copy under ``dose_prediction_tpu_torch/_build/``; the last test holds
that build.
"""

import gzip
import json
import struct
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu.data import native as JN  # noqa: E402
from dose_prediction_tpu.data import nifti as JNI  # noqa: E402
from dose_prediction_tpu.data import openkbp as JO  # noqa: E402
from dose_prediction_tpu.data import openkbp_prepare as JP  # noqa: E402
from dose_prediction_tpu.data import private_seg as JPS  # noqa: E402
from dose_prediction_tpu.data import synthetic as JSY  # noqa: E402
from dose_prediction_tpu.ops.resize import _interp_matrix as j_interp_matrix  # noqa: E402

from dose_prediction_tpu_torch.data import native as N  # noqa: E402
from dose_prediction_tpu_torch.data import nifti as NI  # noqa: E402
from dose_prediction_tpu_torch.data import openkbp as O  # noqa: E402
from dose_prediction_tpu_torch.data import openkbp_prepare as P  # noqa: E402
from dose_prediction_tpu_torch.data import private_seg as PS  # noqa: E402
from dose_prediction_tpu_torch.data import synthetic as SY  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SHAPE = (20, 16, 12)        # not cubic: the loader's transposes must show
# a permuted, flipped sform: reorient_to_ras has work to do
AFFINE = np.array([[0.0, 0.0, -2.5, 30.0],
                   [3.906, 0.0, 0.0, -4.0],
                   [0.0, 3.906, 0.0, 7.5],
                   [0.0, 0.0, 0.0, 1.0]])


@pytest.fixture(autouse=True)
def jax_reads_with_numpy():
    with mock.patch.object(JN, "get_lib", lambda: None):
        yield


@pytest.fixture(params=["native", "numpy"])
def port_reader(request):
    """The port's reader through its native library, or with the library
    unavailable (the numpy path)."""
    if request.param == "native":
        assert N.native_available(), N.native_build_error()
        yield request.param
    else:
        with mock.patch.object(N, "get_lib", lambda: None):
            yield request.param


def decompressed(path: Path) -> bytes:
    with (gzip.open(path, "rb") if path.suffix == ".gz" else open(path, "rb")) as f:
        return f.read()


def assert_images_equal(a, b):
    assert a.data.dtype == b.data.dtype and a.data.shape == b.data.shape
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(a.affine, b.affine)
    assert a.spacing == b.spacing


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8])
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_nifti_round_trip_across_packages(tmp_path, writer, suffix, dtype):
    """One package writes, both read (numpy path, and the port's native
    reader); the other package's file for the same volume holds the same
    bytes; RAS reorientation and orientation codes agree."""
    rng = np.random.default_rng(3)
    vol = (np.abs(rng.standard_normal(SHAPE)) * 40).astype(dtype)
    spacing = (3.906, 3.906, 2.5)
    w_mod, other = (JNI, NI) if writer == "jax" else (NI, JNI)
    path, twin = tmp_path / f"a{suffix}", tmp_path / f"b{suffix}"
    w_mod.write_nifti(path, vol, affine=AFFINE, spacing=spacing)
    other.write_nifti(twin, vol, affine=AFFINE, spacing=spacing)
    assert decompressed(path) == decompressed(twin)
    want = JNI.read_nifti(path, prefer_native=False)
    got = NI.read_nifti(path, prefer_native=False)
    assert_images_equal(got, want)
    np.testing.assert_array_equal(want.data, vol)
    assert JNI.orientation_codes(want.affine) == NI.orientation_codes(got.affine) != "RAS"
    assert_images_equal(NI.reorient_to_ras(got), JNI.reorient_to_ras(want))
    assert NI.orientation_codes(NI.reorient_to_ras(got).affine) == "RAS"
    native = NI.read_nifti(path)                     # float32 from the C++ decode
    assert native.data.dtype == np.float32
    np.testing.assert_array_equal(native.data, vol.astype(np.float32))
    np.testing.assert_array_equal(native.affine, want.affine)
    assert native.spacing == want.spacing


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_qform_affine_across_packages(tmp_path, suffix):
    """A qform-only header (sform_code 0, qfac −1): both numpy readers give
    one affine, the native reader the same within float32."""
    vol = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)
    plain = tmp_path / "plain.nii"
    NI.write_nifti(plain, vol, spacing=(2.0, 3.0, 4.0))
    raw = bytearray(plain.read_bytes())
    struct.pack_into("<f", raw, 76, -1.0)                         # pixdim[0]: qfac
    struct.pack_into("<hh", raw, 252, 1, 0)                       # qform 1, sform 0
    struct.pack_into("<6f", raw, 256, 0.1, -0.3, 0.2, 5.0, -6.0, 7.0)
    path = tmp_path / f"q{suffix}"
    with (gzip.open(path, "wb") if suffix == ".nii.gz" else open(path, "wb")) as f:
        f.write(bytes(raw))
    want = JNI.read_nifti(path, prefer_native=False)
    got = NI.read_nifti(path, prefer_native=False)
    assert_images_equal(got, want)
    assert not np.allclose(want.affine[:3, :3], np.diag(np.diag(want.affine[:3, :3])))
    native = NI.read_nifti(path)
    np.testing.assert_array_equal(native.data, want.data)
    np.testing.assert_allclose(native.affine, want.affine, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fault", ["truncated_header", "bad_magic", "truncated_voxels",
                                   "bad_vox_offset", "corrupt_gzip"])
def test_malformed_files_raise_as_in_jax(tmp_path, fault):
    """The native reader declines what the numpy reader refuses; both
    packages then raise one ValueError with one message."""
    path = tmp_path / "v.nii"
    NI.write_nifti(path, np.ones(SHAPE, np.float32))
    raw = bytearray(path.read_bytes())
    if fault == "truncated_header":
        raw = raw[:200]
    elif fault == "bad_magic":
        raw[344:348] = b"xx1\x00"
    elif fault == "truncated_voxels":
        raw = raw[:-100]
    elif fault == "bad_vox_offset":
        struct.pack_into("<f", raw, 108, float("nan"))
    path.write_bytes(bytes(raw))
    if fault == "corrupt_gzip":
        path = tmp_path / "v.nii.gz"
        path.write_bytes(gzip.compress(bytes(raw))[:-40])
    with pytest.raises(ValueError) as want:
        JNI.read_nifti(path, prefer_native=False)
    with pytest.raises(ValueError) as got:
        NI.read_nifti(path)
    assert str(got.value) == str(want.value)


def test_native_batch_reader_and_ct_preprocess(tmp_path):
    rng = np.random.default_rng(4)
    vols = [(rng.standard_normal(s) * 900).astype(np.int16)
            for s in (SHAPE, (8, 9, 10), SHAPE)]
    paths = []
    for i, v in enumerate(vols):
        paths.append(tmp_path / f"v{i}.nii.gz")
        NI.write_nifti(paths[-1], v, spacing=(1.0 + i, 2.0, 3.0))
    batch = N.read_batch_f32(paths, n_threads=2)
    for (data, spacing), v, p in zip(batch, vols, paths):
        np.testing.assert_array_equal(data, v.astype(np.float32))
        single = N.read_volume_f32(p)
        np.testing.assert_array_equal(single[0], data)
        assert single[1] == spacing == NI.read_nifti(p, prefer_native=False).spacing
    buf = batch[0][0].ravel().copy()
    want = np.clip(buf, -1024.0, 1500.0) * np.float32(1.0 / 1000.0)   # the C++ multiplies
    np.testing.assert_array_equal(N.preprocess_ct_inplace(buf), want)
    with mock.patch.object(N, "get_lib", lambda: None):
        np.testing.assert_array_equal(N.preprocess_ct_inplace(batch[0][0].ravel().copy()),
                                      np.clip(batch[0][0].ravel(), -1024.0, 1500.0) / 1000.0)
    assert N.read_volume_f32(tmp_path / "missing.nii.gz") is None


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Two synthetic patients of SHAPE from the port's writer; patient 1
    lacks PTV63 and Esophagus."""
    root = tmp_path_factory.mktemp("openkbp_io")
    return SY.make_synthetic_dataset(root, n_patients=2, shape=SHAPE, seed=5)


def test_synthetic_cohort_matches_jax(tmp_path, cohort):
    pattern = JSY.make_synthetic_dataset(tmp_path, n_patients=2, shape=SHAPE, seed=5)
    mine = sorted(Path(cohort).parent.glob("pt_*/*.nii.gz"))
    theirs = sorted(Path(pattern).parent.glob("pt_*/*.nii.gz"))
    assert [p.relative_to(p.parents[1]) for p in mine] == \
        [p.relative_to(p.parents[1]) for p in theirs]
    assert len(mine) == 2 * 13 - 2
    for a, b in zip(mine, theirs):
        assert decompressed(a) == decompressed(b), a.name


PATIENT_FIELDS = ("ct", "ptv", "oars", "dose", "real_dose", "dose_mask", "model_input", "gt",
                  "oars_label_encoded")


def assert_patients_equal(got, want):
    assert got.patient_id == want.patient_id and tuple(got.spacing) == tuple(want.spacing)
    for name in PATIENT_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert sorted(got.structures) == sorted(want.structures)
    for name, mask in want.structures.items():
        np.testing.assert_array_equal(got.structures[name], mask, err_msg=name)


def test_load_patient_matches_jax(cohort, port_reader):
    """Field by field, a full patient and one with missing structures (their
    channels zero, their structures absent)."""
    for d in sorted(Path(cohort).parent.glob("pt_*")):
        want = JO.load_patient(str(d))
        got = O.load_patient(str(d))
        assert_patients_equal(got, want)
        assert got.ct.shape == SHAPE     # the (2,1,0) transpose and RAS cancel
    missing = O.load_patient(str(Path(cohort).parent / "pt_1"))
    assert "PTV63" not in missing.structures and "Esophagus" not in missing.structures
    assert not missing.oars[..., O.OAR_NAMES.index("Esophagus")].any()
    assert O.OAR_NAMES == JO.OAR_NAMES and O.PTV_NAMES == JO.PTV_NAMES
    assert O.OAR_LABELS == JO.OAR_LABELS


def test_dataset_matches_jax(cohort):
    """OpenKBPDataset with its thread pool and without, against the JAX one."""
    want = JO.OpenKBPDataset(cohort, keep_structures=True, num_workers=1)
    for workers in (1, 2):
        got = O.OpenKBPDataset(cohort, keep_structures=True, num_workers=workers)
        assert len(got) == len(want) == 2
        for a, b in zip(got.patients, want.patients):
            assert_patients_equal(a, b)
    assert len(O.OpenKBPDataset(cohort, size=1)) == 1
    with pytest.raises(FileNotFoundError):
        O.OpenKBPDataset(str(Path(cohort).parent / "nobody_*"))


@pytest.mark.parametrize("mode,align", [("linear", False), ("linear", True),
                                        ("nearest", False), ("nearest-exact", False)])
def test_private_seg_interp_matrix_matches_jax(mode, align):
    for n_in, n_out in ((36, 128), (200, 128), (5, 5), (7, 3)):
        np.testing.assert_array_equal(PS._interp_matrix(n_in, n_out, mode, align),
                                      j_interp_matrix(n_in, n_out, mode, align))


@pytest.fixture(scope="module")
def private_cohort(tmp_path_factory):
    """Three private-layout patients: an int16 CT of 40×36×20 on disk and
    four of the 13 OAR masks each."""
    root = tmp_path_factory.mktemp("private_seg")
    rng = np.random.default_rng(9)
    for i in range(3):
        pdir = root / f"p{i}"
        pdir.mkdir()
        NI.write_nifti(pdir / "CT.nii.gz",
                       (rng.standard_normal((40, 36, 20)) * 800).astype(np.int16),
                       spacing=(0.9, 0.9, 2.0 + i))
        for name in PS.PRIVATE_OAR_NAMES[i: i + 4]:
            mask = np.zeros((40, 36, 20), np.uint8)
            c = rng.integers(5, 25, 3)
            mask[c[0]:c[0] + 8, c[1]:c[1] + 6, c[2] // 2:c[2] // 2 + 5] = 1
            NI.write_nifti(pdir / f"{name}.nii.gz", mask)
    return str(root / "p*")


@pytest.mark.parametrize("split", ["train", "val"])
def test_private_seg_matches_jax(private_cohort, split):
    want = JPS.PrivateSegDataset(private_cohort, split=split, val_indices=[1])
    got = PS.PrivateSegDataset(private_cohort, split=split, val_indices=[1])
    assert len(got) == len(want) == (2 if split == "train" else 1)
    for a, b in zip(got.records, want.records):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got[0]["ct"].shape == (128, 128, 128) and got[0]["labels"].max() > 0
    seg_a, seg_b = got.as_seg(), want.as_seg()
    for a, b in zip(seg_a.patients, seg_b.patients):
        assert a.patient_id == b.patient_id and a.spacing == b.spacing
        np.testing.assert_array_equal(a.oars_label_encoded, b.oars_label_encoded)
    with pytest.raises(ValueError, match="unknown split"):
        PS.PrivateSegDataset(private_cohort, split="test")
    assert PS.VAL_SPLIT == JPS.VAL_SPLIT and PS.PRIVATE_OAR_LABELS == JPS.PRIVATE_OAR_LABELS


CSV_SHAPE = (16, 16, 16)


def write_sparse(path, dense, *, mask: bool):
    flat = np.asarray(dense, np.float32).ravel()
    with open(path, "w") as f:
        f.write(",data\n")
        for i in np.flatnonzero(flat):
            f.write(f"{i},\n" if mask else f"{i},{float(flat[i])!r}\n")


@pytest.fixture
def csv_shape(monkeypatch):
    for mod in (P, JP):
        monkeypatch.setattr(mod, "SHAPE", CSV_SHAPE)


def write_csv_patient(pdir: Path, rng, *, missing=()):
    pdir.mkdir(parents=True)
    blob = tuple(slice(4, 12) for _ in range(3))
    ct = np.zeros(CSV_SHAPE, np.float32)
    ct[blob] = np.round(rng.uniform(-500, 1200, ct[blob].shape))
    dose = np.zeros(CSV_SHAPE, np.float32)
    dose[blob] = rng.uniform(0, 70, dose[blob].shape).astype(np.float32)
    write_sparse(pdir / "ct.csv", ct, mask=False)
    write_sparse(pdir / "dose.csv", dose, mask=False)
    write_sparse(pdir / "possible_dose_mask.csv", dose > 0, mask=True)
    for si, name in enumerate(P.PTV_NAMES + P.OAR_NAMES):
        if name not in missing:
            s = np.zeros(CSV_SHAPE, np.uint8)
            s[si % 8: si % 8 + 5, 3:9, 6:11] = 1
            write_sparse(pdir / f"{name}.csv", s, mask=True)
    (pdir / "voxel_dimensions.csv").write_text("3.906\n3.906\n2.5\n")
    return ct, dose


def test_openkbp_prepare_matches_jax(tmp_path, csv_shape, capsys):
    """The CSV cohort converted by both packages gives the same NIfTI
    volumes, and the port's loader reproduces the dense CSV arrays."""
    rng = np.random.default_rng(7)
    truth = {f"pt_{i}": write_csv_patient(tmp_path / "csv" / f"pt_{i}", rng,
                                          missing=("PTV63", "Esophagus") if i else ())
             for i in range(2)}
    assert P.prepare_cohort(tmp_path / "csv", tmp_path / "port", ct_offset=-24.0) == 2
    assert JP.prepare_cohort(tmp_path / "csv", tmp_path / "jax", ct_offset=-24.0) == 2
    port_files = sorted((tmp_path / "port").glob("pt_*/*.nii.gz"))
    assert len(port_files) == 2 * 13 - 2
    for f in port_files:
        twin = tmp_path / "jax" / f.parent.name / f.name
        assert decompressed(f) == decompressed(twin), f
    ds = O.OpenKBPDataset(str(tmp_path / "port" / "pt_*"), num_workers=1)
    for p in ds.patients:
        ct, dose = truth[p.patient_id]
        np.testing.assert_array_equal(p.real_dose, dose)
        np.testing.assert_array_equal(
            p.ct, np.clip(ct - 24.0, -1024.0, 1500.0).astype(np.float32) / 1000.0)
    assert "absent" in capsys.readouterr().out


@pytest.mark.parametrize("fault", ["mixed_values", "index_out_of_range", "non_finite",
                                   "bad_voxel_dimensions", "no_voxel_dimensions",
                                   "not_a_patient"])
def test_openkbp_prepare_refuses_as_jax(tmp_path, csv_shape, fault):
    """The stricter conversion: each bad input raises the same exception,
    with the same message, in both packages."""
    pdir = tmp_path / "pt_0"
    write_csv_patient(pdir, np.random.default_rng(1))
    if fault == "mixed_values":
        with open(pdir / "dose.csv", "a") as f:
            f.write("5,\n")
    elif fault == "index_out_of_range":
        with open(pdir / "ct.csv", "a") as f:
            f.write(f"{int(np.prod(CSV_SHAPE))},1.0\n")
    elif fault == "non_finite":
        with open(pdir / "dose.csv", "a") as f:
            f.write("7,inf\n")
    elif fault == "bad_voxel_dimensions":
        (pdir / "voxel_dimensions.csv").write_text("3.906\n-1\n2.5\n")
    elif fault == "no_voxel_dimensions":
        (pdir / "voxel_dimensions.csv").unlink()
    else:
        (pdir / "ct.csv").unlink()
    errors = []
    for mod, out in ((JP, "jax"), (P, "port")):
        with pytest.raises((ValueError, FileNotFoundError)) as e:
            mod.prepare_patient(pdir, tmp_path / out)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]
    if fault == "no_voxel_dimensions":
        status = P.prepare_patient(pdir, tmp_path / "assumed", default_spacing=(2, 2, 3))
        assert status["CT"] == "written"
        assert NI.read_nifti(tmp_path / "assumed" / "CT.nii.gz").spacing == (2.0, 2.0, 3.0)


def test_native_build_is_locked_and_stays_in_the_port(tmp_path):
    """Two processes build the library at once into an empty build directory:
    one compiles, both load the finished library; the only file a process
    writes or renames is under that directory, and the one compiler command
    writes there too (never under native/, never through make)."""
    build_dir = tmp_path / "build"
    script = textwrap.dedent("""
        import json, os, sys
        from pathlib import Path
        events = []
        def hook(event, args):
            if event == "open" and args[1] is not None and any(c in str(args[1]) for c in "wax+"):
                events.append(["write", str(args[0])])
            elif event in ("os.rename", "os.replace"):
                events.append(["rename", str(args[0]), str(args[1])])
            elif event == "subprocess.Popen":
                events.append(["run", [str(a) for a in args[1]]])
        from dose_prediction_tpu_torch.data import native as N
        N.BUILD_DIR = Path(sys.argv[1])
        sys.addaudithook(hook)
        lib = N.get_lib()
        print(json.dumps({"ok": lib is not None, "error": N.native_build_error(),
                          "path": str(N.library_path()), "events": events}))
    """)
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": str(tmp_path)}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(build_dir)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in outs]
    results = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    assert all(r["ok"] and r["error"] is None for r in results), results
    lib = Path(results[0]["path"])
    assert lib.parent == build_dir and lib.is_file()
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(["libdose_io.lock", lib.name])
    compiles = [e[1] for r in results for e in r["events"] if e[0] == "run"]
    assert len(compiles) == 1, compiles           # the second found the finished library
    cmd = compiles[0]
    assert cmd[0] == "g++" and "make" not in cmd
    assert Path(cmd[cmd.index("-o") + 1]).parent == build_dir
    for r in results:
        for e in r["events"]:
            if e[0] in ("write", "rename"):
                assert all(Path(p).is_relative_to(build_dir) for p in e[1:]), e
