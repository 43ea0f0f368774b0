"""The port's mesh in gloo worker processes on the CPU (modelled on
tests/test_multihost.py, tests/test_multihost_trainer.py and
tests/test_multihost_seg.py).

Worker processes import torch and the port only. This file starts four,
once: they join a world of four through parallel/multihost.py::initialize
on a free port (from a socket bound to port 0: ``--dist loadfile`` runs
test files side by side) for the {'data': 2, 'model': 2} job and leave it;
then ranks 0 and 1 join a world of two and run every two-process job in
turn, while ranks 2 and 3 run the one-process references, each alone. The
workers are waited for with one timeout and killed on expiry; a worker
writes its output to a file (a pipe nobody reads would stop it mid-job).
Every run starts from the port's seeded weights, which the JAX trainers
import (no JAX init is compiled). While the workers run, this process runs
the JAX package, one program at a time: the packages' forward gaps that
size the noise runs, its windows, its fits.

- The toy step: a data-parallel step of a linear model on {'data': 2},
  whose masked mean divides by the global mask count with one rank's mask
  empty, against numpy; the clip's global norm with one split and one
  replicated leaf on {'model': 2} against ``_clip`` in one process; two
  adam8bit updates of a split and a replicated leaf on {'model': 2}, whole
  leaves and 8-bit moments bit for bit the one-process update's; a
  replicated leaf whose gradient differs between the model ranks updated
  alike on both, with the first rank's.
- BatchNorm on {'data': 2} (DOSE-PYFER's decoders hold eight): the
  global batch's statistics, against the one-process BatchNorm3d.
- ``PyferTrainer.fit`` at the tiny widths of __graft_entry__.py:81-84 on two
  32³ patients, two epochs, AdamW: on {'data': 2} with batch 2 and on
  {'model': 2} with batch 1, each against the port's one-process fit of the
  same global batch from the same weights; {'model': 2} with adam8bit
  (its quantization over whole leaves) against the one-process adam8bit;
  {'data': 2} also against the JAX package's single-process PyferTrainer,
  whose initial weights every run starts from. The bars are
  tests/test_torch_port_trainers.py's: the first epoch's train loss within
  rel 1e-5, then the noise-run rule for the later loss and every
  parameter leaf, with two seeded noise runs of the one-process fit (their
  amplitude the packages' forward gap, at least 1e-6); adam8bit's second
  epoch loss within that file's 2e-3, and its 8-bit moments laid out in
  the single-device blocks (after four updates their codes differ as the
  trajectories do: the quantizer magnifies rounding). The validation over
  the data axis at the initial weights within rel 1e-5 of the batch-1
  sweep.
- A slot written on {'model': 2} after the first epoch (whole leaves)
  resumes in one process, whose second epoch lands where the mesh's did.
- {'data': 2, 'model': 2} in four processes: one step in lockstep, its
  loss and the validation at the initial weights as the one process's.
- TranSeg: the CLIs' small one (feature size 2, ViT 24/48, four layers,
  two heads) on 32³ crops of the same two patients, as
  tests/test_torch_port_trainers_seg_c3d.py trains it. At 16³ a window is
  one ViT token, whose softmax is exactly 1: q and k would get no
  gradient, and the {'model': 2} split of attention would be held through
  v alone; here each window is 2³ tokens. With two ViT layers (the JAX
  seg tests' widths) the {'model': 2} fit's second-epoch loss departs from
  one process by more than twice its two noise runs do, though less than
  other noise seeds' runs depart: two seeds then size the bar too tightly.
- The sharded sliding window (infer/sliding_window.py) on {'data': 2}: a
  72 × 72 × 32 volume in 32³ windows, whose 9 windows become 10, against the JAX
  package's sliding_window_inference_sharded on a two-device JAX mesh at
  rel/abs 1e-5 (tests/test_parallel.py:77-95's bar), with that test's
  affine predictor; with the TranSeg, whose forwards differ between the
  packages, within 1e-5 beyond their forward gap on that volume's
  windows; each rank predicts its 5 windows in one call, and both blend
  alike.
- ``TranSegTrainer.fit``, two epochs of two crops a patient, AdamW, as
  PyferTrainer's: {'data': 2} with batch 2 and {'model': 2} with batch 1
  against the one-process fit of the same global batch, {'data': 2} also
  against the JAX package's TranSegTrainer; the validation on each mesh at
  the initial weights within rel 1e-4 of the one-process sweep (the JAX
  test's bar, tests/test_mesh_val.py:98-104), for the val loss, Dice and
  HD95; the {'model': 2} slot after the first epoch resumes in one
  process.
"""
import dataclasses
import json
import shutil
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu.core import torch_import as TI  # noqa: E402
from dose_prediction_tpu.infer.sliding_window import (  # noqa: E402
    sliding_window_inference_sharded as jax_sharded_window,
)
from dose_prediction_tpu.models import DosePyfer as JDosePyfer  # noqa: E402
from dose_prediction_tpu.models import TranSeg as JTranSeg  # noqa: E402
from dose_prediction_tpu.parallel import mesh as JPM  # noqa: E402
from dose_prediction_tpu.train import trainers as JT  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.infer.sliding_window import (  # noqa: E402
    sliding_window_inference,
    sliding_window_inference_sharded,
    window_grid,
)
from dose_prediction_tpu_torch.models import DosePyfer, TranSeg  # noqa: E402
from dose_prediction_tpu_torch.train import losses as L  # noqa: E402
from dose_prediction_tpu_torch.train import state as S  # noqa: E402
from dose_prediction_tpu_torch.train.adam8bit import Adam8bit  # noqa: E402
from dose_prediction_tpu_torch.train import trainers as T  # noqa: E402

from test_torch_port_trainers import (  # noqa: E402,F401
    REL_EPOCH,
    ZERO_GRAD_CONV31,
    assert_params_by_noise_rule,
    check_epochs,
    jax_without_native,
    make_cohort,
    noise_amplitude,
    records,
    variables_of,
)
from test_torch_port_models import to_jax  # noqa: E402
from test_torch_port_zoo_train import initialized  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TINY = dict(out_ch=1, list_ch_A=(-1, 4, 8, 16, 32, 64), feature_size=4, hidden_size=48,
            mlp_dim=96, num_layers=8, num_heads=6)
SHAPE = (1, 32, 32, 32, 9)
# the CLIs' small TranSeg on 32³ crops of the 32³ cohort, as
# tests/test_torch_port_trainers_seg_c3d.py trains it (module docstring)
SEG_TINY = dict(out_ch=8, feature_size=2, hidden_size=24, mlp_dim=48, num_layers=4,
                num_heads=2)
CROP, SEG_SAMPLES = (32, 32, 32), 2
WINDOW_VOLUME = (1, 2, 72, 72, 32)     # 3 × 3 × 1 windows of 32³, padded to 10 over two ranks
WORLD_TIMEOUT_S = 900
NO_VAL = 5          # a check_val past the two epochs: the one-process fits skip validation
EXCLUDE = ("net_A.", "conv_out_A.")
REL_SEG_VAL = 1e-4

WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)
    a = json.load(open(sys.argv[1]))
    from dose_prediction_tpu_torch.parallel import multihost as MH
    RANK = a["rank"]
    MH.initialize("127.0.0.1:%d" % a["port"], a["world"], RANK, device="cpu")
    from dose_prediction_tpu_torch.parallel import mesh as PM


    def toy(a):
        from dose_prediction_tpu_torch.parallel.collectives import all_reduce_
        from dose_prediction_tpu_torch.train import losses as L
        from dose_prediction_tpu_torch.train import state as S
        out = {{}}
        x, y, m = (torch.tensor(a[k]) for k in ("x", "y", "mask"))
        mesh = PM.create_mesh({{"data": 2}})
        rows = PM.batch_sharding(mesh).rows(x.shape[0])
        lin = torch.nn.Linear(3, 1, bias=False)
        with torch.no_grad():
            lin.weight.fill_(0.1)
        opt = S.Adam(list(lin.parameters()), lr=0.01)
        opt.distribute(PM.ShardPlan(mesh, {{}}, lin))
        share = L.masked_l1(lin(x[rows])[:, 0], y[rows], m[rows], mesh.group("data"))
        share.backward()
        out["share"] = float(share)
        out["loss"] = float(all_reduce_(share.detach().clone(), mesh.group("data")))
        opt.step()
        out["grad"] = lin.weight.grad[0].tolist()
        out["w"] = lin.weight[0].tolist()
        tp = PM.create_mesh({{"model": 2}})
        shard = PM.Shard("model", 0, 2)
        net = torch.nn.Module()
        net.a = torch.nn.Parameter(shard.take(torch.tensor(a["ga"]), tp.index("model")))
        net.b = torch.nn.Parameter(torch.tensor(a["gb"]))
        clip = S.Adam(list(net.parameters()), lr=0.01, grad_clip_norm=a["clip"])
        clip.distribute(PM.ShardPlan(tp, {{"a": shard}}, net))
        ga, gb = clip._clip([[net.a.detach(), net.b.detach()]])[0]
        out["clipped_a"] = shard.gather(ga, tp).tolist()
        out["clipped_b"] = gb.tolist()
        from dose_prediction_tpu_torch.train.adam8bit import Adam8bit
        q = torch.nn.Module()
        q.a = torch.nn.Parameter(shard.take(torch.tensor(a["qa"]), tp.index("model")))
        q.b = torch.nn.Parameter(torch.tensor(a["qb"]))
        opt8 = Adam8bit(list(q.parameters()), lr=0.01, weight_decay=0.1)
        opt8.distribute(PM.ShardPlan(tp, {{"a": shard}}, q))
        for g in a["qgrads"]:
            q.a.grad = shard.take(torch.tensor(g[0]), tp.index("model"))
            q.b.grad = torch.tensor(g[1])
            opt8.step()
        out["q"] = [shard.gather(q.a.detach(), tp).tolist(), q.b.tolist()]
        # a replicated leaf whose gradient differs between the model ranks:
        # every rank updates with the first rank's
        rep = torch.nn.Parameter(torch.zeros(3))
        rep.grad = torch.tensor([1.0, -1.0, 2.0]) * (1 - 2 * tp.index("model"))
        opt_r = S.Adam([rep], lr=0.01)
        opt_r.distribute(PM.ShardPlan(tp, {{}}, torch.nn.Module()))
        opt_r.step()
        out["rep"] = rep.tolist()
        out["q_moments"] = [t.tolist() for k in ("mu", "nu")
                            for t in opt8.state_dict()["moments"][k].values()]
        return out


    def bn(a):
        from dose_prediction_tpu_torch.nn.layers import BatchNorm3d
        from dose_prediction_tpu_torch.parallel import sharded
        from dose_prediction_tpu_torch.parallel.collectives import all_reduce_
        out = {{}}
        mesh = PM.create_mesh({{"data": 2}})
        x, w = torch.tensor(a["x"]), torch.tensor(a["w"])
        rows = PM.batch_sharding(mesh).rows(x.shape[0])
        net = torch.nn.Sequential(BatchNorm3d(x.shape[1]))
        with torch.no_grad():
            net[0].weight.copy_(torch.tensor(a["gamma"]))
        sharded.swap_modules(net, mesh, {{}})
        out["cls"] = type(net[0]).__name__
        xr = x[rows].clone().requires_grad_(True)
        y = net(xr)
        (y * w[rows]).sum().backward()
        data = mesh.group("data")
        out["y"], out["dx"] = y.tolist(), xr.grad.tolist()
        out["dgamma"] = all_reduce_(net[0].weight.grad.clone(), data).tolist()
        out["dbeta"] = all_reduce_(net[0].bias.grad.clone(), data).tolist()
        out["running"] = [net[0].running_mean.tolist(), net[0].running_var.tolist()]
        return out


    def fit(a):
        from dose_prediction_tpu_torch.data.openkbp import OpenKBPDataset
        from dose_prediction_tpu_torch.models import DosePyfer
        from dose_prediction_tpu_torch.train import trainers as T
        ds = OpenKBPDataset(a["pattern"], keep_structures=True, num_workers=1)
        model = DosePyfer(img_size=32, device="cpu", **a["tiny"])
        model.load_state_dict(torch.load(a["init"], weights_only=True))
        cfg = T.TrainConfig(max_epochs=a["epochs"], check_val=2, batch_size=a["batch"],
                            device="cpu",
                            optimizer=a["optimizer"], mesh_shape=a["mesh"],
                            save_per_epoch=1, ckpt_dir=a["ckpt"], log_dir=a["log"])
        tr = T.PyferTrainer(cfg, model=model, example_shape=(1, 32, 32, 32, 9))
        out = {{"validate": tr.validate(ds)}}
        tr.fit(ds, ds, resume=False)
        out["step"] = tr.state.step
        out["moving_loss"] = float(tr.state.moving_loss)
        return out


    def seg_model(a):
        from dose_prediction_tpu_torch.models import TranSeg
        model = TranSeg(img_size=a["crop"], device="cpu", **a["seg_tiny"])
        model.load_state_dict(torch.load(a["init"], weights_only=True))
        return model


    def wait(path):
        # path, once the test process has written it (the noise runs' amplitude)
        import os, time
        deadline = time.monotonic() + a["timeout"]
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise TimeoutError(path)
            time.sleep(0.2)
        return path


    def noisy_outputs(seed, amplitude):
        # tests/test_torch_port_trainers.py::noisy_outputs
        from unittest import mock
        from dose_prediction_tpu_torch.nn.layers import InstanceNorm3d, Linear
        g = torch.Generator().manual_seed(seed)

        def noisy(forward):
            def run(self, inp):
                out = forward(self, inp)
                u = torch.rand(out.shape, generator=g) * 2 - 1
                return out + (out * (amplitude * u)).detach()
            return run

        patches = [mock.patch.object(InstanceNorm3d, "forward", noisy(InstanceNorm3d.forward)),
                   mock.patch.object(Linear, "forward", noisy(Linear.forward))]
        for p in patches:
            p.start()
        return patches


    def one_trainer(a, mesh=None, **kw):
        from dose_prediction_tpu_torch.data.openkbp import OpenKBPDataset
        from dose_prediction_tpu_torch.models import DosePyfer
        from dose_prediction_tpu_torch.train import trainers as T
        ds = OpenKBPDataset(a["pattern"], keep_structures=True, num_workers=1)
        cfg = T.TrainConfig(max_epochs=2, batch_size=a["batch"], device="cpu",
                            mesh_shape=mesh, ckpt_dir=a["ckpt"], log_dir=a["log"], **kw)
        if a["model"] == "seg":
            return ds, T.TranSegTrainer(cfg, model=seg_model(a), crop=a["crop"])
        model = DosePyfer(img_size=32, device="cpu", **a["tiny"])
        model.load_state_dict(torch.load(a["init"], weights_only=True))
        return ds, T.PyferTrainer(cfg, model=model, example_shape=(1, 32, 32, 32, 9))


    def ref_validate(a):
        ds, tr = one_trainer(a)
        return {{"validate": tr.validate(ds, **a["validate_kw"])}}


    def ref_fit(a):
        # the one-process fit of a global batch, a noise run with "seed"
        ds, tr = one_trainer(a, check_val=a["no_val"], optimizer=a["optimizer"])
        patches = []
        if a["seed"] is not None:
            amplitude = json.load(open(wait(a["amplitude"])))[a["model"]]
            patches = noisy_outputs(a["seed"], amplitude)
        tr.fit(ds, ds, resume=False, **a["fit_kw"])
        for p in patches:
            p.stop()
        out = {{"model": tr.model.state_dict(), "step": tr.state.step}}
        if a["optimizer"] == "adam8bit":
            out["moments"] = tr.state.optimizer.state_dict()["moments"]
        torch.save(out, a["out"])
        return {{}}


    def leave(a):
        import torch.distributed as dist
        dist.destroy_process_group()
        return {{}}


    def join(a):
        # a new world of the ranks a["ranks"], on a["port"]
        MH.initialize("127.0.0.1:%d" % a["port"], len(a["ranks"]), a["ranks"].index(RANK),
                      device="cpu")
        return {{}}


    def seg_window(a):
        from dose_prediction_tpu_torch.infer.sliding_window import (
            sliding_window_inference_sharded)
        mesh = PM.create_mesh({{"data": 2}})
        vol = torch.from_numpy(np.load(a["volume"]))
        model = seg_model(a).eval()
        calls = []

        def counted(predictor):
            def run(windows):
                calls.append(windows.shape[0])
                return predictor(windows)
            return run

        affine = sliding_window_inference_sharded(
            vol, counted(lambda w: w * 2.0 + 1.0), mesh, roi_size=a["crop"])
        with torch.no_grad():
            logits = sliding_window_inference_sharded(vol[:, :1], counted(model), mesh,
                                                      roi_size=a["crop"], out_channels=8)
        for name, t in (("affine", affine), ("logits", logits)):
            np.save("%s_%s_%d.npy" % (a["out"], name, RANK), t.numpy())
        return {{"calls": calls}}


    def seg_fit(a):
        ds, tr = one_trainer(a, a["mesh"], check_val=2, save_per_epoch=1)
        out = {{"validate": tr.validate(ds, sw_batch_size=2),
               "split_leaves": sorted(tr.state.plan.shards)}}
        tr.fit(ds, ds, num_samples=a["samples"], resume=False)
        out["step"] = tr.state.step
        out["moving_loss"] = float(tr.state.moving_loss)
        return out


    for job in a["jobs"]:
        if RANK not in job.get("on", [RANK]):
            continue
        out = {{"toy": toy, "bn": bn, "fit": fit, "seg_window": seg_window,
               "seg_fit": seg_fit, "leave": leave, "join": join, "ref_validate": ref_validate,
               "ref_fit": ref_fit}}[job["job"]](job)
        print("RESULT " + json.dumps({{"tag": job["tag"], **out}}), flush=True)
""").format(repo=str(REPO))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(jobs: list, where: Path, world: int):
    """``world`` worker processes on a free port that run ``jobs`` in turn in
    one world, each reading its arguments from a JSON file under ``where``
    and writing its output to a log file there (a pipe that nobody reads
    while the other rank is waited for would block a rank mid-job)."""
    port, procs = free_port(), []
    for rank in range(world):
        args = where / f"world_{port}_{rank}.json"
        args.write_text(json.dumps({"jobs": jobs, "rank": rank, "port": port, "world": world,
                                    "timeout": WORLD_TIMEOUT_S}))
        with open(where / f"world_{port}_{rank}.log", "w") as out:
            procs.append((subprocess.Popen([sys.executable, "-c", WORKER, str(args)],
                                           stdout=out, stderr=subprocess.STDOUT),
                          where / f"world_{port}_{rank}.log"))
    return procs


def kill(procs) -> None:
    """Kill the workers still running."""
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def results(procs) -> dict:
    """{job tag: [each rank's RESULT]}, waiting for the world with its own
    timeout; on a timeout or a failure all are killed and the test fails
    with their output."""
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    for p, _ in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            kill(procs)
            pytest.fail("mesh worker hung; output:\n" +
                        "\n---\n".join(log.read_text()[-6000:] for _, log in procs))
        if p.returncode != 0:
            kill(procs)
            pytest.fail(f"mesh worker failed ({p.returncode}):\n" +
                        "\n---\n".join(log.read_text()[-6000:] for _, log in procs))
    got = {}
    for _, log in procs:
        for line in log.read_text().splitlines():
            if line.startswith("RESULT "):
                rec = json.loads(line[7:])
                got.setdefault(rec.pop("tag"), []).append(rec)
    return got


def toy_inputs():
    rng = np.random.default_rng(3)
    return {"x": rng.normal(size=(8, 3)).astype(np.float32).tolist(),
            "y": rng.normal(size=8).astype(np.float32).tolist(),
            # rank 0's rows hold three mask voxels, rank 1's none
            "mask": [1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0],
            "ga": rng.normal(size=(4, 3)).astype(np.float32).tolist(),
            "gb": rng.normal(size=5).astype(np.float32).tolist(), "clip": 0.5,
            # adam8bit: a split leaf of four 2048-blocks, a replicated one of three
            "qa": rng.normal(size=(64, 128)).astype(np.float32).tolist(),
            "qb": rng.normal(size=5000).astype(np.float32).tolist(),
            "qgrads": [[rng.normal(size=(64, 128)).astype(np.float32).tolist(),
                        rng.normal(size=5000).astype(np.float32).tolist()] for _ in range(2)]}


def bn_inputs():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 3, 2, 3, 2)).astype(np.float32)
    x[2:] = 3 * x[2:] + 1           # rank 1's rows: another mean and spread
    return {"x": x.tolist(), "w": rng.normal(size=x.shape).astype(np.float32).tolist(),
            "gamma": rng.uniform(0.5, 1.5, size=3).astype(np.float32).tolist()}


def port_model(start):
    model = DosePyfer(img_size=32, device="cpu", **TINY)
    model.load_state_dict(weights.jax_to_torch(start, model), strict=True)
    return model


def port_seg_model(start):
    model = TranSeg(img_size=CROP, device="cpu", **SEG_TINY)
    model.load_state_dict(weights.jax_to_torch(start, model), strict=True)
    return model


def state_of(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


@dataclasses.dataclass
class Ref:
    """A one-process fit of a global batch that a worker ran after the mesh
    jobs: its step count, final state (numpy), metric records and, for
    adam8bit, its moments."""

    step: int
    final: dict
    recs: dict
    moments: dict = None


def ref_jobs(root, common, tag, batch, optimizer="adamw", noise=(0, 1)):
    """The one-process fit of ``tag``'s global batch and its noise runs
    (seeds ``noise``), as worker jobs."""
    return [{"job": "ref_fit", "tag": f"{tag}_{name}", **common, "batch": batch,
             "optimizer": optimizer, "seed": seed, "no_val": NO_VAL,
             "amplitude": str(root / "amplitude.json"), "out": str(root / f"{tag}_{name}.pt"),
             "ckpt": str(root / f"{tag}_{name}_ck"), "log": str(root / f"{tag}_{name}_log")}
            for name, seed in [("one", None)] + [(f"noise{s}", s) for s in noise]]


def load_ref(root, tag, name) -> Ref:
    out = torch.load(root / f"{tag}_{name}.pt", weights_only=True)
    return Ref(out["step"], {k: v.numpy() for k, v in out["model"].items()},
               records(root / f"{tag}_{name}_log"), out.get("moments"))


def fit_jobs(root, pattern, tags):
    """The PyferTrainer jobs by tag: (mesh, global batch, optimizer, epochs)."""
    return [{"job": "fit", "tag": tag, "pattern": pattern, "init": str(root / "init.pt"),
             "tiny": TINY, "mesh": mesh, "batch": batch, "optimizer": opt, "epochs": epochs,
             "ckpt": str(root / f"{tag}_mesh_ck"), "log": str(root / f"{tag}_mesh_log")}
            for tag, (mesh, batch, opt, epochs) in tags.items()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Four worker processes, all this file starts: in a world of four they
    run the {'data': 2, 'model': 2} job and leave it; then ranks 0 and 1
    join a world of two for the two-process jobs, while ranks 2 and 3 run
    the one-process references, each alone. The initial weights are the
    port's, seeded and written before the workers start; the JAX trainers
    start from them through their import
    (tests/test_torch_port_zoo_train.py::initialized: no JAX init is
    compiled). Meanwhile this process runs the JAX package, one program at a
    time: the forward gaps that size the noise runs, its windows, its two
    fits."""
    root = tmp_path_factory.mktemp("mesh")
    ds, jds = make_cohort(root / "cohort", 32)
    volume = np.random.default_rng(11).standard_normal(WINDOW_VOLUME).astype(np.float32)
    np.save(root / "volume.npy", volume)
    pattern = str(root / "cohort" / "pt_*")
    seeded = T.seeded(0, lambda: DosePyfer(img_size=32, device="cpu", **TINY))
    seg_seeded = T.seeded(1, lambda: TranSeg(img_size=CROP, device="cpu", **SEG_TINY))
    torch.save(seeded.state_dict(), root / "init.pt")
    torch.save(seg_seeded.state_dict(), root / "seg_init.pt")
    pyfer = {"model": "pyfer", "pattern": pattern, "init": str(root / "init.pt"), "tiny": TINY,
             "fit_kw": {}, "validate_kw": {}}
    seg = {"model": "seg", "pattern": pattern,
           "init": str(root / "seg_init.pt"), "seg_tiny": SEG_TINY, "crop": CROP,
           "fit_kw": {"num_samples": SEG_SAMPLES}, "validate_kw": {"sw_batch_size": 2}}
    jobs = {"dp": ({"data": 2}, 2, "adamw"), "tp": ({"model": 2}, 1, "adamw"),
            "tp8": ({"model": 2}, 1, "adam8bit")}
    seg_jobs = {"seg_dp": ({"data": 2}, 2), "seg_tp": ({"model": 2}, 1)}
    pair = [{"job": "join", "tag": "join", "ranks": [0, 1], "port": free_port()},
            {"job": "toy", "tag": "toy", **toy_inputs()},
            {"job": "bn", "tag": "bn", **bn_inputs()},
            *fit_jobs(root, pattern, {tag: (*job, 2) for tag, job in jobs.items()}),
            {"job": "seg_window", "tag": "seg_window", "volume": str(root / "volume.npy"),
             "out": str(root / "window"), **seg},
            *[{"job": "seg_fit", "tag": tag, **seg, "mesh": mesh, "batch": batch,
               "samples": SEG_SAMPLES, "ckpt": str(root / f"{tag}_mesh_ck"),
               "log": str(root / f"{tag}_mesh_log")} for tag, (mesh, batch) in seg_jobs.items()]]
    # the references, about 35 s a rank; the noise runs last, as they wait
    # for the forward gaps
    refs = [[{"job": "ref_validate", "tag": "validate", **pyfer, "batch": 1,
              "ckpt": str(root / "probe_ck"), "log": str(root / "probe_log")},
             *ref_jobs(root, pyfer, "tp8", 1, "adam8bit", noise=()),
             *ref_jobs(root, pyfer, "dp", 2), *ref_jobs(root, seg, "seg_dp", 2)],
            [{"job": "ref_validate", "tag": "seg_validate", **seg, "batch": 1,
              "ckpt": str(root / "seg_probe_ck"), "log": str(root / "seg_probe_log")},
             *ref_jobs(root, pyfer, "tp", 1), *ref_jobs(root, seg, "seg_tp", 1)]]
    workers = launch(
        [*fit_jobs(root, pattern, {"dptp": ({"data": 2, "model": 2}, 2, "adamw", 1)}),
         {"job": "leave", "tag": "leave"},
         *[{**job, "on": [0, 1]} for job in pair],
         *[{**job, "on": [2 + rank]} for rank, rank_jobs in enumerate(refs) for job in rank_jobs]],
        root, 4)
    try:
        def jax_trainer(model, port, importer, shape, tag, cls, **kw):
            variables, _ = to_jax(port, model, importer, shape)
            cfg = JT.TrainConfig(max_epochs=2, check_val=NO_VAL, batch_size=2, seed=0,
                                 ckpt_dir=str(root / f"{tag}_ck"), log_dir=str(root / f"{tag}_log"))
            fields = {f.name: getattr(model, f.name) for f in dataclasses.fields(model)
                      if f.init and f.name not in ("parent", "name")}
            tr = cls(cfg, model=initialized(type(model), variables, **fields), **kw)
            start = variables_of(tr.state)
            # the JAX start carried back is the workers' start, bit for bit
            for k, v in weights.jax_to_torch(start, port).items():
                assert torch.equal(v, port.state_dict()[k]), k
            return tr, start

        jtr, start = jax_trainer(JDosePyfer(**TINY), seeded, TI.import_pyfer, SHAPE, "jax",
                                 JT.PyferTrainer, example_shape=SHAPE)
        sjtr, seg_start = jax_trainer(JTranSeg(**SEG_TINY), seg_seeded, TI.import_transeg,
                                      (1, *CROP, 1), "seg_jax", JT.TranSegTrainer, crop=CROP)
        # the packages' forward gaps size the noise runs
        from dose_prediction_tpu.data.pipeline import dose_batches

        first = next(dose_batches(jds, batch_size=1, shuffle=False, augment=False))
        tr0 = T.PyferTrainer(T.TrainConfig(device="cpu", log_dir=str(root / "gap_log"),
                                           ckpt_dir=str(root / "gap_ck")),
                             model=port_model(start), example_shape=SHAPE)
        gaps = {"pyfer": noise_amplitude(
            tr0.eval_step({k: torch.from_numpy(np.asarray(v)) for k, v in first.items()})
            ["prediction"], jtr.eval_step(jtr.state, first)["prediction"])}
        seg_apply = jax.jit(lambda x, variables: sjtr.model.apply(
            variables, x, train=False, mutable=["batch_stats"])[0])
        ct = jds.patients[0].ct[None, ..., None]
        with torch.no_grad():
            port_logits = seg_seeded.eval()(torch.from_numpy(np.ascontiguousarray(
                ct.transpose(0, 4, 1, 2, 3)))).numpy()
        gaps["seg"] = noise_amplitude(
            port_logits, np.asarray(seg_apply(ct, seg_start)).transpose(0, 4, 1, 2, 3))
        (root / "amplitude.json.tmp").write_text(json.dumps(gaps))
        (root / "amplitude.json.tmp").rename(root / "amplitude.json")
        one = {"start": start, "seg_start": seg_start}
        # the window: the port's one-process sweep at sw batch 5 (the ranks'
        # batches), the packages' forward gap on each of the volume's
        # windows (the gap's program), the JAX package's sharded window on
        # two virtual devices
        with torch.no_grad():
            one["port_window"] = sliding_window_inference(
                torch.from_numpy(volume[:, :1]), seg_seeded, roi_size=CROP, sw_batch_size=5,
                out_channels=8).numpy()
            window_gaps = []
            for z, y, x in window_grid(WINDOW_VOLUME[2:], CROP):
                w = np.ascontiguousarray(volume[:, :1, z:z + CROP[0], y:y + CROP[1], x:x + CROP[2]])
                jax_w = np.asarray(seg_apply(np.ascontiguousarray(w.transpose(0, 2, 3, 4, 1)),
                                             seg_start)).transpose(0, 4, 1, 2, 3)
                window_gaps.append(np.abs(seg_seeded(torch.from_numpy(w)).numpy() - jax_w).max())
            one["window_gap"] = float(max(window_gaps))
        vol = jnp.asarray(volume.transpose(0, 2, 3, 4, 1))
        jmesh = JPM.create_mesh({"data": 2}, devices=jax.devices()[:2])
        one["jax_window"] = {
            "affine": np.asarray(jax_sharded_window(vol, lambda w: w * 2.0 + 1.0, jmesh,
                                                    roi_size=CROP)),
            "logits": np.asarray(jax_sharded_window(vol[..., :1], seg_apply, jmesh, roi_size=CROP,
                                                    out_channels=8, predictor_args=(seg_start,)))}
        jtr.fit(jds, jds, resume=False)
        sjtr.fit(jds, jds, num_samples=SEG_SAMPLES, resume=False)
        one["jax"] = (jtr, records(root / "jax_log"))
        one["seg_jax"] = (sjtr, records(root / "seg_jax_log"))
        mesh = results(workers)
    finally:
        kill(workers)
    one["validate"] = mesh["validate"][0]["validate"]
    one["seg_validate"] = mesh["seg_validate"][0]["validate"]
    for tag in (*jobs, *seg_jobs):
        one[tag] = load_ref(root, tag, "one")
        if tag != "tp8":
            one[tag + "_noise"] = [(r.final, r.recs) for r in (load_ref(root, tag, f"noise{s}")
                                                               for s in (0, 1))]
    return root, ds, one, mesh


LR = T.TrainConfig().learning_rate      # every fit's


def mesh_final(root, tag, model):
    """The mesh run's final whole leaves (rank 0's 'last' slot) as numpy."""
    slot = torch.load(root / f"{tag}_mesh_ck" / "last.pt", weights_only=True)
    assert set(slot["model"]) == set(model.state_dict())
    return {k: v.numpy() for k, v in slot["model"].items()}, slot


def hold(init, one_final, noisy, mesh_state, updates):
    assert_params_by_noise_rule(init, one_final, [r for r, _ in noisy], mesh_state,
                                ZERO_GRAD_CONV31, LR, updates, exclude=EXCLUDE)


def test_batchnorm_takes_the_global_batch_statistics(runs):
    """DOSE-PYFER's decoders hold BatchNorm3d: on {'data': 2} it is recast as
    DataBatchNorm3d, whose forward, input gradient, summed affine gradients
    and running statistics are the one-process BatchNorm3d's over the
    global batch (rows of unequal spread on the two ranks)."""
    from dose_prediction_tpu_torch.nn.layers import BatchNorm3d

    got = runs[3]["bn"]
    inp = bn_inputs()
    bn = BatchNorm3d(3)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(inp["gamma"]))
    xt = torch.tensor(inp["x"], requires_grad=True)
    y = bn(xt)
    (y * torch.tensor(inp["w"])).sum().backward()
    close = dict(rtol=1e-5, atol=1e-6)
    for rank, g in enumerate(got):
        rows = slice(2 * rank, 2 * rank + 2)
        assert g["cls"] == "DataBatchNorm3d"
        assert np.allclose(g["y"], y[rows].detach().numpy(), **close)
        assert np.allclose(g["dx"], xt.grad[rows].numpy(), **close)
        assert np.allclose(g["dgamma"], bn.weight.grad.numpy(), **close)
        assert np.allclose(g["dbeta"], bn.bias.grad.numpy(), **close)
        assert np.allclose(g["running"][0], bn.running_mean.numpy(), **close)
        assert np.allclose(g["running"][1], bn.running_var.numpy(), **close)


def test_toy_step_and_clip_match_one_process(runs):
    inp = toy_inputs()
    got = runs[3]["toy"]
    assert got[0]["grad"] == got[1]["grad"] and got[0]["w"] == got[1]["w"]
    x, y, m = (np.asarray(inp[k], np.float64) for k in ("x", "y", "mask"))
    r = x @ np.full(3, 0.1) - y
    loss = np.sum(np.abs(r) * m) / m.sum()
    grad = (np.sign(r) * m) @ x / m.sum()
    assert got[1]["share"] == 0.0                       # an empty mask's share
    assert abs(got[0]["share"] + got[1]["share"] - loss) <= 1e-6 * loss
    assert got[0]["loss"] == got[1]["loss"] and abs(got[0]["loss"] - loss) <= 1e-6 * loss
    assert np.allclose(got[0]["grad"], grad, rtol=1e-5, atol=1e-7)
    # the first Adam step: -lr · g / (|g| + eps)
    assert np.allclose(got[0]["w"], 0.1 - 0.01 * grad / (np.abs(grad) + 1e-8), rtol=1e-6)
    # one process: the masked mean of the global batch and _clip of whole leaves
    one = L.masked_l1(torch.tensor(x @ np.full(3, 0.1), dtype=torch.float32),
                      torch.tensor(inp["y"]), torch.tensor(inp["mask"]))
    assert abs(float(one) - loss) <= 1e-6 * loss
    ga, gb = torch.tensor(inp["ga"]), torch.tensor(inp["gb"])
    opt = S.Adam([torch.nn.Parameter(ga), torch.nn.Parameter(gb)], lr=0.01,
                 grad_clip_norm=inp["clip"])
    want_a, want_b = opt._clip([[ga, gb]])[0]
    assert float(torch.sqrt(ga.square().sum() + gb.square().sum())) > inp["clip"]
    for g in got:
        assert np.allclose(g["clipped_a"], want_a.numpy(), rtol=1e-6, atol=0)
        assert np.allclose(g["clipped_b"], want_b.numpy(), rtol=1e-6, atol=0)
    # adam8bit over the whole leaves: bit for bit the one-process update
    q = [torch.nn.Parameter(torch.tensor(inp[k])) for k in ("qa", "qb")]
    opt8 = Adam8bit(q, lr=0.01, weight_decay=0.1)
    for ga, gb in inp["qgrads"]:
        q[0].grad, q[1].grad = torch.tensor(ga), torch.tensor(gb)
        opt8.step()
    moments = [t.tolist() for k in ("mu", "nu") for t in opt8.state_dict()["moments"][k].values()]
    # the replicated leaf: both ranks update with rank 0's gradient
    rep = torch.nn.Parameter(torch.zeros(3))
    rep.grad = torch.tensor([1.0, -1.0, 2.0])
    S.Adam([rep], lr=0.01).step()
    for g in got:
        assert g["q"] == [q[0].tolist(), q[1].tolist()] and g["q_moments"] == moments
        assert g["rep"] == rep.tolist()


@pytest.mark.parametrize("tag", ["dp", "tp"])
def test_mesh_fit_matches_one_process(runs, tag):
    root, _, one, mesh = runs
    ref = one[tag]
    ranks = mesh[tag]
    assert ranks[0]["moving_loss"] == ranks[1]["moving_loss"]     # replicas in lockstep
    assert ranks[0]["step"] == ref.step == (2 if tag == "dp" else 4)
    model = port_model(one["start"])
    got, slot = mesh_final(root, tag, model)
    assert slot["step"] == ref.step
    mrec = records(root / f"{tag}_mesh_log")
    assert (root / f"{tag}_mesh_log" / "metrics.p1.jsonl").exists()
    check_epochs(ref.recs, mrec, one[tag + "_noise"], "train_mean_loss", ())
    hold(state_of(model), ref.final, one[tag + "_noise"], got, ref.step)
    # before any update the mesh validates as the batch-1 sweep
    for k in ("mean_dose_score", "val_loss"):
        assert abs(ranks[0]["validate"][k] - one["validate"][k]) <= \
            REL_EPOCH * abs(one["validate"][k])


def test_dp_mesh_matches_jax(runs):
    root, ds, one, _ = runs
    jtr, jrec = one["jax"]
    model = port_model(one["start"])
    got, _ = mesh_final(root, "dp", model)
    mrec = records(root / "dp_mesh_log")
    check_epochs(mrec, jrec, one["dp_noise"], "train_mean_loss", ())
    jax_final = {k: v.numpy()
                 for k, v in weights.jax_to_torch(variables_of(jtr.state), model).items()}
    assert int(jtr.state.step) == 2
    hold(state_of(model), got, one["dp_noise"], jax_final, 2)


def test_tp_adam8bit_matches_one_process(runs):
    """adam8bit on {'model': 2} quantizes whole leaves, in the single-device
    blocks, by tests/test_torch_port_trainers.py's adam8bit bars (its codes
    may differ by a step where rounding differs)."""
    root, _, one, _ = runs
    ref = one["tp8"]
    recs = ref.recs
    _, slot = mesh_final(root, "tp8", port_model(one["start"]))
    mrec = records(root / "tp8_mesh_log")
    assert abs(mrec["train_mean_loss"][0] - recs["train_mean_loss"][0]) <= \
        REL_EPOCH * abs(recs["train_mean_loss"][0])
    assert abs(mrec["train_mean_loss"][1] - recs["train_mean_loss"][1]) <= \
        2e-3 * abs(recs["train_mean_loss"][1])
    mine, theirs = slot["optimizer"]["moments"], ref.moments
    assert mine["quant"] == theirs["quant"] and mine["small"] == theirs["small"]
    for k in ("mu", "nu"):
        for f, v in theirs[k].items():
            assert mine[k][f].shape == v.shape and mine[k][f].dtype == v.dtype


def test_mesh_slot_resumes_in_one_process(runs, tmp_path):
    """The {'model': 2} run's slot after its first epoch (iter_2, whole
    leaves) resumes in one process; its second epoch ends where the mesh's
    did, by the noise-run rule."""
    root, ds, one, _ = runs
    ck = tmp_path / "ck"
    ck.mkdir()
    shutil.copy(root / "tp_mesh_ck" / "iter_2.pt", ck / "last.pt")
    cfg = T.TrainConfig(max_epochs=2, check_val=2, batch_size=1, device="cpu",
                        ckpt_dir=str(ck), log_dir=str(tmp_path / "log"))
    resumed = T.PyferTrainer(cfg, model=T.seeded(5, lambda: DosePyfer(img_size=32, device="cpu",
                                                                     **TINY)),
                             example_shape=SHAPE)
    resumed.fit(ds, ds, resume=True)
    assert resumed.state.step == 4 and len(records(cfg.log_dir)["train_mean_loss"]) == 1
    model = port_model(one["start"])
    got, _ = mesh_final(root, "tp", model)
    hold(state_of(model), state_of(resumed.model), one["tp_noise"], got, 4)
    # the second epoch's loss by check_epochs' noise rule
    one_rec, mrec = records(cfg.log_dir), records(root / "tp_mesh_log")
    check_epochs({"loss": [mrec["train_mean_loss"][0]] + one_rec["train_mean_loss"]},
                 {"loss": mrec["train_mean_loss"]},
                 [(None, {"loss": r["train_mean_loss"]}) for _, r in one["tp_noise"]],
                 "loss", ())


def test_dp_tp_mesh_trains_in_four_processes(runs):
    """{'data': 2, 'model': 2} in four processes: the four ranks in
    lockstep, and the first step's loss (taken before any update) within
    rel 1e-5 of the one-process batch of 2."""
    root, _, one, mesh = runs
    ranks = mesh["dptp"]
    assert len(ranks) == 4
    assert len({r["moving_loss"] for r in ranks}) == 1 and {r["step"] for r in ranks} == {1}
    got = records(root / "dptp_mesh_log")["train_mean_loss"][0]
    want = one["dp"].recs["train_mean_loss"][0]
    assert abs(got - want) <= REL_EPOCH * abs(want), (got, want)
    for k in ("mean_dose_score", "val_loss"):
        assert abs(ranks[0]["validate"][k] - one["validate"][k]) <= \
            REL_EPOCH * abs(one["validate"][k])


@pytest.mark.parametrize("predictor", ["affine", "logits"])
def test_sharded_window_matches_jax(runs, predictor):
    """{'data': 2}: 9 windows padded to 10, 5 a rank in one predictor call;
    both ranks' blends equal, within rel/abs 1e-5 of the JAX package's
    sharded window on two devices. With TranSeg the two packages' forwards
    themselves differ: its blend is held within rel/abs 1e-5 of the port's
    one-process sweep of the same volume (sw batch 5, the batches the ranks
    run), and departs from the JAX package's sharded blend by no more than
    1e-5 beyond the packages' largest forward gap on that volume's windows
    (a blend is a mean of window predictions, so it departs by no more than
    they do)."""
    root, _, one, mesh = runs
    assert [r["calls"] for r in mesh["seg_window"]] == [[5, 5]] * 2
    ranks = [np.load(root / f"window_{predictor}_{rank}.npy") for rank in (0, 1)]
    assert np.array_equal(ranks[0], ranks[1])
    want = one["jax_window"][predictor].transpose(0, 4, 1, 2, 3)
    assert ranks[0].shape == want.shape == \
        (1, 2 if predictor == "affine" else 8) + WINDOW_VOLUME[2:]
    if predictor == "affine":
        np.testing.assert_allclose(ranks[0], want, rtol=1e-5, atol=1e-5)
        return
    np.testing.assert_allclose(ranks[0], one["port_window"], rtol=1e-5, atol=1e-5)
    print(f"sharded gap {np.abs(ranks[0] - want).max():.3g}, "
          f"windows' gap {one['window_gap']:.3g}")
    assert np.abs(ranks[0] - want).max() <= one["window_gap"] + 1e-5


def test_sharded_window_refuses_a_batch():
    with pytest.raises(ValueError, match="expects batch size 1"):
        sliding_window_inference_sharded(torch.zeros((2, 1) + CROP), lambda w: w, None,
                                         roi_size=CROP)


def assert_seg_validation(got, want):
    """Dice, HD95 and the val loss within rel 1e-4 (a NaN where the other is
    NaN), as tests/test_mesh_val.py holds the JAX package's."""
    for a, b in zip(got, want):
        if np.isnan(b):
            assert np.isnan(a)
        else:
            assert abs(a - b) <= REL_SEG_VAL * abs(b) + 1e-6, (got, want)


@pytest.mark.parametrize("tag", ["seg_dp", "seg_tp"])
def test_seg_mesh_fit_matches_one_process(runs, tag):
    """TranSegTrainer on {'data': 2} (batch 2: BatchNorm over the global
    batch, the window batch split over the ranks) and {'model': 2} (batch
    1: the ViT's two heads one a rank, decoder4's convs by output channel)
    against the one-process fit of the same global batch; its validation at
    the initial weights against the one-process sweep."""
    root, _, one, mesh = runs
    ref = one[tag]
    ranks = mesh[tag]
    assert ranks[0]["moving_loss"] == ranks[1]["moving_loss"]
    assert ranks[0]["step"] == ref.step == (4 if tag == "seg_dp" else 8)
    split = ranks[0]["split_leaves"]
    if tag == "seg_tp":     # five ViT leaves a layer and decoder4's six convs
        assert len(split) == 5 * SEG_TINY["num_layers"] + 6 and \
            sum(n.startswith("decoder4.") for n in split) == 6
    else:
        assert split == []
    model = port_seg_model(one["seg_start"])
    got, slot = mesh_final(root, tag, model)
    assert slot["step"] == ref.step
    mrec = records(root / f"{tag}_mesh_log")
    check_epochs(ref.recs, mrec, one[tag + "_noise"], "train_loss", ())
    hold(state_of(model), ref.final, one[tag + "_noise"], got, ref.step)
    for r in ranks:
        assert_seg_validation(r["validate"], one["seg_validate"])
    # the validation inside the fit, at epoch 2
    assert len(mrec["val_loss"]) == 1 and {"dice_metric", "hd95_metric"} <= mrec.keys()


def test_seg_dp_mesh_matches_jax(runs):
    root, _, one, _ = runs
    jtr, jrec = one["seg_jax"]
    model = port_seg_model(one["seg_start"])
    got, _ = mesh_final(root, "seg_dp", model)
    mrec = records(root / "seg_dp_mesh_log")
    check_epochs(mrec, jrec, one["seg_dp_noise"], "train_loss", ())
    jax_final = {k: v.numpy()
                 for k, v in weights.jax_to_torch(variables_of(jtr.state), model).items()}
    assert int(jtr.state.step) == 4
    hold(state_of(model), got, one["seg_dp_noise"], jax_final, 4)


def test_seg_mesh_slot_resumes_in_one_process(runs, tmp_path):
    """The TranSeg {'model': 2} slot after its first epoch (iter_4, whole
    leaves) resumes in one process, whose second epoch ends where the
    mesh's did, by the noise-run rule."""
    root, ds, one, _ = runs
    ck = tmp_path / "ck"
    ck.mkdir()
    shutil.copy(root / "seg_tp_mesh_ck" / "iter_4.pt", ck / "last.pt")
    cfg = T.TrainConfig(max_epochs=2, check_val=NO_VAL, batch_size=1, device="cpu",
                        ckpt_dir=str(ck), log_dir=str(tmp_path / "log"))
    resumed = T.TranSegTrainer(cfg, model=T.seeded(5, lambda: TranSeg(
        img_size=CROP, device="cpu", **SEG_TINY)), crop=CROP)
    resumed.fit(ds, ds, num_samples=SEG_SAMPLES, resume=True)
    assert resumed.state.step == 8 and len(records(cfg.log_dir)["train_loss"]) == 1
    model = port_seg_model(one["seg_start"])
    got, _ = mesh_final(root, "seg_tp", model)
    hold(state_of(model), state_of(resumed.model), one["seg_tp_noise"], got, 8)
    one_rec, mrec = records(cfg.log_dir), records(root / "seg_tp_mesh_log")
    check_epochs({"loss": [mrec["train_loss"][0]] + one_rec["train_loss"]},
                 {"loss": mrec["train_loss"]},
                 [(None, {"loss": r["train_loss"]}) for _, r in one["seg_tp_noise"]],
                 "loss", ())
