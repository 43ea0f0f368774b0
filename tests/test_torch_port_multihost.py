"""The port's mesh in two gloo processes on the CPU (modelled on
tests/test_multihost.py and tests/test_multihost_trainer.py).

Worker processes import torch and the port only; each joins a world of two
through parallel/multihost.py::initialize on a free port (from a socket
bound to port 0: ``--dist loadfile`` runs test files side by side), is
waited for with its own timeout and killed on expiry, with its pair.

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
  trajectories do: the quantizer magnifies rounding). The validation over the data axis at the
  initial weights within rel 1e-5 of the batch-1 sweep.
- A slot written on {'model': 2} after the first epoch (whole leaves)
  resumes in one process, whose second epoch lands where the mesh's did.
- {'data': 2, 'model': 2} in four processes: one step in lockstep, its
  loss and the validation at the initial weights as the one process's.
"""
import json
import math
import shutil
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from dose_prediction_tpu.models import DosePyfer as JDosePyfer  # noqa: E402
from dose_prediction_tpu.train import trainers as JT  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.models import DosePyfer  # noqa: E402
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
    noisy_outputs,
    records,
    variables_of,
)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(out_ch=1, list_ch_A=(-1, 4, 8, 16, 32, 64), feature_size=4, hidden_size=48,
            mlp_dim=96, num_layers=8, num_heads=6)
SHAPE = (1, 32, 32, 32, 9)
WORKER_TIMEOUT_S = 240
NO_VAL = 5          # a check_val past the two epochs: the one-process fits skip validation
EXCLUDE = ("net_A.", "conv_out_A.")

WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(1)
    a = json.load(open(sys.argv[1]))
    from dose_prediction_tpu_torch.parallel import multihost as MH
    MH.initialize("127.0.0.1:%d" % a["port"], a["world"], a["rank"], device="cpu")
    from dose_prediction_tpu_torch.parallel import mesh as PM
    out = {{}}
    if a["job"] == "toy":
        from dose_prediction_tpu_torch.parallel.collectives import all_reduce_
        from dose_prediction_tpu_torch.train import losses as L
        from dose_prediction_tpu_torch.train import state as S
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
    elif a["job"] == "bn":
        from dose_prediction_tpu_torch.nn.layers import BatchNorm3d
        from dose_prediction_tpu_torch.parallel import sharded
        from dose_prediction_tpu_torch.parallel.collectives import all_reduce_
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
    else:
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
        out["validate"] = tr.validate(ds)
        tr.fit(ds, ds, resume=False)
        out["step"] = tr.state.step
        out["moving_loss"] = float(tr.state.moving_loss)
    print("RESULT " + json.dumps(out), flush=True)
""").format(repo=str(REPO))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(job: dict, where: Path, world: int = 2):
    """``world`` worker processes of ``job`` on a free port, each reading
    its arguments from a JSON file under ``where``."""
    port, procs = free_port(), []
    for rank in range(world):
        args = where / f"job_{port}_{rank}.json"
        args.write_text(json.dumps({**job, "rank": rank, "port": port, "world": world}))
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER, str(args)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return procs


def results(procs) -> list:
    """Each worker's RESULT, waiting for each with its own timeout; on a
    timeout or a failure both are killed and the test fails with their
    output."""
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            partial = []
            for q in procs:
                q.kill()
                partial.append(q.communicate()[0])
            pytest.fail("mesh worker hung; output:\n" + "\n---\n".join(partial))
        if p.returncode != 0:
            for q in procs:
                q.kill()
            pytest.fail(f"mesh worker failed ({p.returncode}):\n{out}")
        outs.append(out)
    return [json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1][7:])
            for out in outs]


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


def test_batchnorm_takes_the_global_batch_statistics(tmp_path):
    """DOSE-PYFER's decoders hold BatchNorm3d: on {'data': 2} it is recast as
    DataBatchNorm3d, whose forward, input gradient, summed affine gradients
    and running statistics are the one-process BatchNorm3d's over the
    global batch (rows of unequal spread on the two ranks)."""
    from dose_prediction_tpu_torch.nn.layers import BatchNorm3d

    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 3, 2, 3, 2)).astype(np.float32)
    x[2:] = 3 * x[2:] + 1           # rank 1's rows: another mean and spread
    inp = {"x": x.tolist(), "w": rng.normal(size=x.shape).astype(np.float32).tolist(),
           "gamma": rng.uniform(0.5, 1.5, size=3).astype(np.float32).tolist()}
    got = results(launch({"job": "bn", **inp}, tmp_path))
    bn = BatchNorm3d(3)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(inp["gamma"]))
    xt = torch.tensor(x, requires_grad=True)
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


def test_toy_step_and_clip_match_one_process(tmp_path):
    inp = toy_inputs()
    got = results(launch({"job": "toy", **inp}, tmp_path))
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


def port_model(start):
    model = DosePyfer(img_size=32, device="cpu", **TINY)
    model.load_state_dict(weights.jax_to_torch(start, model), strict=True)
    return model


def state_of(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def one_process(root, tag, start, ds, batch, optimizer, amplitude=None, seed=None):
    """The port's fit of the same global batch in this process: (trainer,
    final state, records); with ``amplitude``, a noise run of ``seed``."""
    cfg = T.TrainConfig(max_epochs=2, check_val=NO_VAL, batch_size=batch, device="cpu",
                        optimizer=optimizer, ckpt_dir=str(root / f"{tag}_ck"),
                        log_dir=str(root / f"{tag}_log"))
    tr = T.PyferTrainer(cfg, model=port_model(start), example_shape=SHAPE)
    if amplitude is None:
        tr.fit(ds, ds, resume=False)
    else:
        with noisy_outputs(seed, amplitude):
            tr.fit(ds, ds, resume=False)
    return tr, state_of(tr.model), records(cfg.log_dir)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The mesh runs in worker pairs, and, while they run, the one-process
    fits, their noise runs and the JAX fit."""
    root = tmp_path_factory.mktemp("mesh")
    ds, jds = make_cohort(root / "cohort", 32)
    jcfg = JT.TrainConfig(max_epochs=2, check_val=NO_VAL, batch_size=2, seed=0,
                          ckpt_dir=str(root / "jax_ck"), log_dir=str(root / "jax_log"))
    jtr = JT.PyferTrainer(jcfg, model=JDosePyfer(**TINY), example_shape=SHAPE)
    start = variables_of(jtr.state)
    torch.save(port_model(start).state_dict(), root / "init.pt")
    jobs = {"dp": ({"data": 2}, 2, "adamw"), "tp": ({"model": 2}, 1, "adamw"),
            "tp8": ({"model": 2}, 1, "adam8bit")}
    # (mesh, global batch, optimizer, epochs) by tag; 'dptp', four
    # processes, one epoch of one step
    runs_on = {**{tag: (*job, 2) for tag, job in jobs.items()},
               "dptp": ({"data": 2, "model": 2}, 2, "adamw", 1)}
    procs = {tag: launch({"job": "fit", "pattern": str(root / "cohort" / "pt_*"),
                          "init": str(root / "init.pt"), "tiny": TINY, "mesh": mesh,
                          "batch": batch, "optimizer": opt, "epochs": epochs,
                          "ckpt": str(root / f"{tag}_mesh_ck"),
                          "log": str(root / f"{tag}_mesh_log")}, root, math.prod(mesh.values()))
             for tag, (mesh, batch, opt, epochs) in runs_on.items()}
    try:
        from dose_prediction_tpu.data.pipeline import dose_batches

        first = next(dose_batches(jds, batch_size=1, shuffle=False, augment=False))
        probe = port_model(start)
        tr0 = T.PyferTrainer(T.TrainConfig(device="cpu", log_dir=str(root / "probe_log"),
                                           ckpt_dir=str(root / "probe_ck")),
                             model=probe, example_shape=SHAPE)
        amplitude = noise_amplitude(
            tr0.eval_step({k: torch.from_numpy(np.asarray(v)) for k, v in first.items()})
            ["prediction"], jtr.eval_step(jtr.state, first)["prediction"])
        one = {"validate": tr0.validate(ds), "amplitude": amplitude, "start": start}
        for tag, (_, batch, opt) in jobs.items():
            one[tag] = one_process(root, f"{tag}_one", start, ds, batch, opt)
            if opt == "adamw":
                one[tag + "_noise"] = [one_process(root, f"{tag}_noise{s}", start, ds, batch,
                                                   opt, amplitude, s)[1:] for s in (0, 1)]
        jtr.fit(jds, jds, resume=False)
        one["jax"] = (jtr, records(jcfg.log_dir))
        mesh = {tag: results(p) for tag, p in procs.items()}
    finally:
        for p in (q for pair in procs.values() for q in pair):
            if p.poll() is None:
                p.kill()
                p.communicate()
    return root, ds, one, mesh


def mesh_final(root, tag, model):
    """The mesh run's final whole leaves (rank 0's 'last' slot) as numpy."""
    slot = torch.load(root / f"{tag}_mesh_ck" / "last.pt", weights_only=True)
    assert set(slot["model"]) == set(model.state_dict())
    return {k: v.numpy() for k, v in slot["model"].items()}, slot


def hold(init, one_final, noisy, mesh_state, lr, updates):
    assert_params_by_noise_rule(init, one_final, [r for r, _ in noisy], mesh_state,
                                ZERO_GRAD_CONV31, lr, updates, exclude=EXCLUDE)


@pytest.mark.parametrize("tag", ["dp", "tp"])
def test_mesh_fit_matches_one_process(runs, tag):
    root, _, one, mesh = runs
    tr, final, recs = one[tag]
    ranks = mesh[tag]
    assert ranks[0]["moving_loss"] == ranks[1]["moving_loss"]     # replicas in lockstep
    assert ranks[0]["step"] == tr.state.step == (2 if tag == "dp" else 4)
    got, slot = mesh_final(root, tag, tr.model)
    assert slot["step"] == tr.state.step
    mrec = records(root / f"{tag}_mesh_log")
    assert (root / f"{tag}_mesh_log" / "metrics.p1.jsonl").exists()
    check_epochs(recs, mrec, one[tag + "_noise"], "train_mean_loss", ())
    init = {k: v.numpy() for k, v in port_model(one["start"]).state_dict().items()}
    hold(init, final, one[tag + "_noise"], got, tr.cfg.learning_rate, tr.state.step)
    # before any update the mesh validates as the batch-1 sweep
    for k in ("mean_dose_score", "val_loss"):
        assert abs(ranks[0]["validate"][k] - one["validate"][k]) <= \
            REL_EPOCH * abs(one["validate"][k])


def test_dp_mesh_matches_jax(runs):
    root, ds, one, _ = runs
    jtr, jrec = one["jax"]
    tr, _, _ = one["dp"]
    got, _ = mesh_final(root, "dp", tr.model)
    mrec = records(root / "dp_mesh_log")
    check_epochs(mrec, jrec, one["dp_noise"], "train_mean_loss", ())
    init = {k: v.numpy() for k, v in port_model(one["start"]).state_dict().items()}
    jax_final = {k: v.numpy()
                 for k, v in weights.jax_to_torch(variables_of(jtr.state), tr.model).items()}
    assert int(jtr.state.step) == 2
    hold(init, got, one["dp_noise"], jax_final, tr.cfg.learning_rate, 2)


def test_tp_adam8bit_matches_one_process(runs):
    """adam8bit on {'model': 2} quantizes whole leaves, in the single-device
    blocks, by tests/test_torch_port_trainers.py's adam8bit bars (its codes
    may differ by a step where rounding differs)."""
    root, _, one, _ = runs
    tr, _, recs = one["tp8"]
    _, slot = mesh_final(root, "tp8", tr.model)
    mrec = records(root / "tp8_mesh_log")
    assert abs(mrec["train_mean_loss"][0] - recs["train_mean_loss"][0]) <= \
        REL_EPOCH * abs(recs["train_mean_loss"][0])
    assert abs(mrec["train_mean_loss"][1] - recs["train_mean_loss"][1]) <= \
        2e-3 * abs(recs["train_mean_loss"][1])
    mine, theirs = slot["optimizer"]["moments"], tr.state.optimizer.state_dict()["moments"]
    assert mine["quant"] == theirs["quant"] and mine["small"] == theirs["small"]
    for k in ("mu", "nu"):
        for f, v in theirs[k].items():
            assert mine[k][f].shape == v.shape and mine[k][f].dtype == v.dtype


def test_mesh_slot_resumes_in_one_process(runs, tmp_path):
    """The {'model': 2} run's slot after its first epoch (iter_2, whole
    leaves) resumes in one process; its second epoch ends where the mesh's
    did, by the noise-run rule."""
    root, ds, one, _ = runs
    tr, _, _ = one["tp"]
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
    got, _ = mesh_final(root, "tp", tr.model)
    init = {k: v.numpy() for k, v in port_model(one["start"]).state_dict().items()}
    hold(init, state_of(resumed.model), one["tp_noise"], got, tr.cfg.learning_rate, 4)
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
    assert len({r["moving_loss"] for r in ranks}) == 1 and {r["step"] for r in ranks} == {1}
    got = records(root / "dptp_mesh_log")["train_mean_loss"][0]
    want = one["dp"][2]["train_mean_loss"][0]
    assert abs(got - want) <= REL_EPOCH * abs(want), (got, want)
    for k in ("mean_dose_score", "val_loss"):
        assert abs(ranks[0]["validate"][k] - one["validate"][k]) <= \
            REL_EPOCH * abs(one["validate"][k])
