"""The port's C3D cascade and TranSeg trainers against the JAX package's on
the CPU: tests/test_torch_port_trainers.py's set-up and bars, on the 32³
cohort.

The C3D trainer's first epoch (two steps) is held by the noise rule, as
its later epochs are, and not at rel 1e-5: its second step's loss follows
one Adam update, and that update depends on the order of a reduction.
The first step's loss is bit-equal in one and in eight torch threads, but
the convolutions' weight gradients (oneDNN's conv3d backward, summed over
the voxels in an order set by the thread count) are not: in one thread
against eight, 63 of the 172 gradient leaves differ in the sign of 1 to 95
near-zero elements (the conv biases that feed an InstanceNorm among them),
and Adam's first update, about lr · sign(g), moves each such element by up
to 2 · lr. The second step's loss then moves by 1.2e-4 relative between
the thread counts (the conv weights of net_B.decoder.decoder_conv_3.0,
net_B.encoder.encoder_2.1 and net_B.decoder.upconv_4 move it most). In one
thread the packages' first epochs differ by 1.9e-5 (cosine) and 3.5e-4
(plateau), and the noise runs move them by up to 2.6e-3 and 7e-4. The
order of that sum is the library's, so the bar comes from the noise runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dose_prediction_tpu.cli import main as JCLI  # noqa: E402
from dose_prediction_tpu.models import CascadeC3D as JCascadeC3D  # noqa: E402
from dose_prediction_tpu.train import trainers as JT  # noqa: E402

from dose_prediction_tpu_torch import weights  # noqa: E402
from dose_prediction_tpu_torch.cli import main as CLI  # noqa: E402
from dose_prediction_tpu_torch.train import trainers as T  # noqa: E402

from torch_threads import one_torch_thread  # noqa: E402,F401

from test_torch_port_trainers import (  # noqa: E402,F401
    REL_EPOCH,
    REL_TEST,
    SHAPE32,
    SIZE32,
    ZERO_GRAD_C3D,
    ZERO_GRAD_CONV31,
    assert_close_dict,
    assert_params_by_noise_rule,
    check_epochs,
    cohort32,
    configs,
    jax_state_numpy,
    jax_val_batches,
    jax_without_native,
    noise_amplitude,
    noise_runs,
    records,
    rel_close,
    state_numpy,
    variables_of,
)


@pytest.mark.parametrize("sched", [
    dict(scheduler="cosine", t_max=4, lr_encoder=1e-3, lr_decoder=2e-3),
    dict(scheduler="plateau", learning_rate=1e-3),
])
def test_cascade_c3d_trainer_matches_jax(tmp_path, cohort32, sched):
    ds, jds = cohort32
    jcfg, cfg = configs(tmp_path, "c", **sched)
    jtr = JT.CascadeC3DTrainer(jcfg, model=JCascadeC3D(
        out_ch=1, list_ch_A=CLI.SMALL_LIST_CH, list_ch_B=CLI.SMALL_LIST_CH),
        example_shape=SHAPE32)
    start = variables_of(jtr.state)
    plateau = sched["scheduler"] == "plateau"

    def never_improves(trainer):       # a plateau that never improves: the rate halves
        if plateau:
            trainer.plateau.patience, trainer.plateau.best = 0, -np.inf
        return trainer

    def make(tag):
        model = CLI.small_c3d(device="cpu")
        model.load_state_dict(weights.jax_to_torch(start, model), strict=True)
        return never_improves(T.CascadeC3DTrainer(configs(tmp_path, tag, **sched)[1],
                                                  model=model, example_shape=SHAPE32))

    never_improves(jtr)
    tr = make("c")
    init = state_numpy(tr.model)
    x = next(jax_val_batches(jds))["input"]
    amplitude = noise_amplitude(tr.predict(torch.from_numpy(np.asarray(x))),
                                jtr._predict(jtr.state.params, x))
    scores = ("mean_dose_score", "mean_dvh_score")
    assert_close_dict(tr.test(ds), jtr.test(jds), scores, REL_TEST)
    jtr.fit(jds, jds, resume=False)
    tr.fit(ds, ds, resume=False)
    runs = noise_runs(make, lambda t: t.fit(ds, ds, resume=False), amplitude)
    port, ref = records(cfg.log_dir), records(jcfg.log_dir)
    check_epochs(port, ref, runs, "train_mean_loss", ("mean_dose_score",), strict_first=False)
    if plateau:
        from dose_prediction_tpu.train import state as JS
        from dose_prediction_tpu_torch.train import state as S

        assert S.get_learning_rate(tr.state.optimizer) == pytest.approx(
            JS.get_learning_rate(jtr.state.opt_state)) == pytest.approx(2.5e-4)
        assert port["lr"] == ref["lr"]
    lr = max(sched.get("lr_decoder", 0.0), sched.get("learning_rate", 0.0))
    assert_params_by_noise_rule(init, state_numpy(tr.model), [r for r, _ in runs],
                                jax_state_numpy(jtr.state, tr.model), ZERO_GRAD_C3D, lr, 4)
    tr.model.load_state_dict(weights.jax_to_torch(variables_of(jtr.state), tr.model))
    assert_close_dict(tr.test(ds), jtr.test(jds), scores, REL_TEST)


def test_transeg_trainer_matches_jax(tmp_path, cohort32):
    ds, jds = cohort32
    jcfg, cfg = configs(tmp_path, "s", batch_size=2)
    crop = (SIZE32,) * 3
    jtr = JT.TranSegTrainer(jcfg, model=JCLI.default_seg_model(small=True), crop=crop)
    start = variables_of(jtr.state)

    def make(tag):
        model = CLI.default_seg_model(small=True, img_size=crop, device="cpu")
        model.load_state_dict(weights.jax_to_torch(start, model), strict=True)
        return T.TranSegTrainer(configs(tmp_path, tag, batch_size=2)[1], model=model, crop=crop)

    tr = make("s")
    init = state_numpy(tr.model)
    ct = jds.patients[0].ct[None, ..., None]
    with torch.no_grad():
        port_logits = tr.model.eval()(torch.from_numpy(np.ascontiguousarray(
            ct.transpose(0, 4, 1, 2, 3))))
    jax_logits, _ = jtr.model.apply(start, ct, train=False, mutable=["batch_stats"])
    amplitude = noise_amplitude(port_logits.numpy(),
                                np.asarray(jax_logits).transpose(0, 4, 1, 2, 3))
    # before any update: Dice, HD95 and the val loss of the sliding-window sweep
    assert rel_close(tr.validate(ds, sw_batch_size=2), jtr.validate(jds, sw_batch_size=2),
                     REL_EPOCH)
    jtr.fit(jds, jds, num_samples=2, resume=False)
    tr.fit(ds, ds, num_samples=2, resume=False)
    runs = noise_runs(make, lambda t: t.fit(ds, ds, num_samples=2, resume=False), amplitude)
    port, ref = records(cfg.log_dir), records(jcfg.log_dir)
    check_epochs(port, ref, runs, "train_loss", ("val_loss", "dice_metric"))
    assert_params_by_noise_rule(init, state_numpy(tr.model), [r for r, _ in runs],
                                jax_state_numpy(jtr.state, tr.model), ZERO_GRAD_CONV31,
                                cfg.learning_rate, int(jtr.state.step))
    tr.model.load_state_dict(weights.jax_to_torch(variables_of(jtr.state), tr.model))
    got = tr.validate(ds, sw_batch_size=2)
    assert rel_close(got, (ref["dice_metric"][-1], ref["hd95_metric"][-1], ref["val_loss"][-1]),
                     REL_EPOCH), (got, ref)
