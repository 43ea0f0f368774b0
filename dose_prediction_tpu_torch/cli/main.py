"""The port's command line (counterpart of dose_prediction_tpu/cli/main.py).

    python -m dose_prediction_tpu_torch train pyfer --data 'data/pt_*' --val-data ...
    python -m dose_prediction_tpu_torch train c3d|hdunet|dosegan|vitgan|exp|transeg ...
    python -m dose_prediction_tpu_torch eval --data ... --ckpt ckpt/last.pt [--device-metrics]
    python -m dose_prediction_tpu_torch seg-eval|predict|infer|score|import-torch ...
    python -m dose_prediction_tpu_torch linked-eval --data ... --seg-ckpt ... --dose-ckpt ...
    python -m dose_prediction_tpu_torch tune --data ... --num-samples 10 [--resume]
    python -m dose_prediction_tpu_torch kfold --data ... --folds 6
    python -m dose_prediction_tpu_torch doctor [--probe] [--json] [--strict]

Everything runs on the card (``--device cuda``, the default) unless the
caller passes ``--device cpu``; a missing card is an error, never a silent
CPU run. ``--device`` takes the place of the JAX CLI's ``--platform``.
The seg task takes TranSeg (``--mode-model 1``, any ``--block-family`` and
``--k7-mode``) or the plain UNETR (``--mode-model 0``). ``tune`` searches
DOSE-PYFER's act, multiS_conv, rate and weight decay with ASHA over the
validation rounds, its concurrent trials spread over the visible cards;
``kfold`` cross-validates DOSE-PYFER. ``train vitgan`` trains ViT-GAN (its
critic optionally from a MedicalNet pickle, ``--pretrained-critic``) and
``train exp`` the exp model; both validate, evaluate and predict through
the sliding window at ×80. ``infer`` and ``linked-eval`` with
``--serve-dtype bfloat16`` serve on the card through the captured stages
(infer/aot.py). ``doctor`` reports what a run on the card needs. Every
subcommand on the card but ``score``, ``doctor`` and ``openkbp-prepare``
first builds or finds the kernel library (core/bootstrap.py). Choices the
port does not have yet (meshes and the bench subcommand) are refused with
the ROADMAP item that brings them; nothing falls back to another model.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

# the pyfer-tuned default (train_light_pyfer.py:296)
_DEFAULT_LR = 0.0006130697604327541
# ROADMAP queue 1 items of what the port refuses
_INFRA = "ROADMAP queue 1 item 7.4 (the CLI's and the other trainers' meshes)"
_UNPORTED_COMMANDS = {
    "bench": "ROADMAP queue 1 item 1 (bench_gpu.py)",
}
_DOSE_MODELS = ["pyfer", "c3d", "hdunet", "dosegan", "vitgan", "exp"]
SMALL_LIST_CH = (-1, 2, 4, 8, 16, 32)
SEG_PATCH = 16   # TranSeg's ViT patch: the dense seg's token grid is roi // 16
# model-constructor arguments that may differ between training and
# evaluation or serving: they change execution, not the learned function
_EXEC_ONLY_FIELDS = {"remat_blocks", "trained_grid"}


def refuse(what: str, roadmap: str) -> SystemExit:
    return SystemExit(f"{what} is not ported to dose_prediction_tpu_torch yet: {roadmap}. "
                      "The JAX package (python -m dose_prediction_tpu) has it.")


def resolve_optimizer(explicit, model_name) -> str:
    """adam8bit for pyfer (the reference trains the flagship with bnb
    Adam8bit, train_light_pyfer.py:12,195), adamw otherwise; an explicit
    flag wins (:26-33)."""
    if explicit:
        return explicit
    return "adam8bit" if model_name == "pyfer" else "adamw"


def default_flagship_model(act="mish", remat_blocks=False, small=False, img_size=128,
                           device="cuda", multiS_conv=True):
    """The DosePyfer of ``train pyfer`` (:36-56): the reference's tuned
    config, or at ``small`` the reduced-width development model; ``tune``
    also searches ``act`` and ``multiS_conv``. The dtype is the input's
    (``infer --serve-dtype``)."""
    from dose_prediction_tpu_torch.models import DosePyfer

    kw = dict(act=act, remat_blocks=remat_blocks, multiS_conv=multiS_conv, img_size=img_size,
              device=device)
    if small:
        return DosePyfer(out_ch=1, list_ch_A=SMALL_LIST_CH, feature_size=2, hidden_size=24,
                         mlp_dim=48, num_layers=4, num_heads=2, **kw)
    return DosePyfer(**kw)


def default_seg_model(out_ch=8, block_family="seg", trained_grid=None, remat_blocks=False,
                      k7_mode="dense", small=False, img_size=96, device="cuda"):
    """The TranSeg of ``train transeg`` (:59-75), of any block family and
    k7 mode."""
    from dose_prediction_tpu_torch.models import TranSeg

    kw = dict(out_ch=out_ch, block_family=block_family, k7_mode=k7_mode,
              trained_grid=trained_grid, remat_blocks=remat_blocks, img_size=img_size,
              device=device)
    if small:
        return TranSeg(feature_size=2, hidden_size=24, mlp_dim=48, num_layers=4, num_heads=2,
                       **kw)
    return TranSeg(**kw)


def default_unetr_model(out_ch=8, trained_grid=None, small=False, img_size=96, device="cuda"):
    """The plain UNETR of ``train transeg --mode-model 0`` (:637-643)."""
    from dose_prediction_tpu_torch.models import UNETR

    kw = dict(out_ch=out_ch, trained_grid=trained_grid, img_size=img_size, device=device)
    if small:
        return UNETR(feature_size=2, hidden_size=24, mlp_dim=48, num_layers=4, num_heads=2,
                     **kw)
    return UNETR(**kw)


def default_hdunet_model(small=False, device="cuda"):
    """The HD-UNet of ``train hdunet`` (:205-209): the reference's growth
    rate 16 and 64 upsampling channels, or 4 and 8 at ``small``."""
    from dose_prediction_tpu_torch.models import HDUNet

    if small:
        return HDUNet(growth_rate=4, upsample_chan=8, device=device)
    return HDUNet(device=device)


def default_dosegan_width(small=False) -> int:
    """ngf = ndf of ``train dosegan``: the reference's 64, or 4 at ``small``."""
    return 4 if small else 64


def default_vitgan_generator(small=False, img_size=128, device="cuda"):
    """ViT-GAN's generator of ``train vitgan`` (:691-699)."""
    from dose_prediction_tpu_torch.models.experiments import vitgan_generator

    return vitgan_generator(small, img_size=img_size, device=device)


def default_exp_generator(small=False, img_size=128, device="cuda", act="mish"):
    """The exp model of ``train exp`` (:701-706)."""
    from dose_prediction_tpu_torch.models.experiments import exp_generator

    return exp_generator(small, act=act, img_size=img_size, device=device)


def default_resnet10(small=False, device="cuda"):
    """The ResNet-10 of ``import-torch --kind resnet10`` (:724-728): MedicalNet's
    widths, or 4-32 at ``small``."""
    from dose_prediction_tpu_torch.models.experiments import resnet10

    return resnet10(widths=(4, 8, 16, 32) if small else (64, 128, 256, 512), device=device)


def small_c3d(device="cuda"):
    from dose_prediction_tpu_torch.models import CascadeC3D

    return CascadeC3D(out_ch=1, list_ch_A=SMALL_LIST_CH, list_ch_B=SMALL_LIST_CH, device=device)


def _run_config_path(ckpt_path) -> Path | None:
    """The run_config.json beside a slot: in its directory, or in the
    checkpoint directory above ``monitored/``."""
    p = Path(ckpt_path)
    cands = [p, p.parent] + ([p.parent.parent] if p.parent.name == "monitored" else [])
    for cand in cands:
        if (cand / "run_config.json").exists():
            return cand / "run_config.json"
    return None


def _check_ckpt_config(ckpt_path, *models) -> None:
    """Eval/serve twin of the train resume guard (:83-127): each model is
    checked against the recorded configuration of its class in the
    checkpoint's run_config.json; a checkpoint without one (an import-torch
    output) is not checked. ``DPT_SKIP_CONFIG_CHECK=1`` overrides."""
    if os.environ.get("DPT_SKIP_CONFIG_CHECK") == "1":
        return
    from dose_prediction_tpu_torch.models.spec import model_spec

    f = _run_config_path(ckpt_path)
    if f is None:
        return
    try:
        stored = json.loads(f.read_text())
    except (OSError, ValueError):
        return
    recorded = {m.get("model"): m.get("config", {}) for m in stored.get("models", [])}
    for model in models:
        name = type(model).__name__
        if name not in recorded:
            continue
        want = {k: v for k, v in recorded[name].items() if k not in _EXEC_ONLY_FIELDS}
        have = {k: v for k, v in model_spec(model).items() if k not in _EXEC_ONLY_FIELDS}
        diffs = sorted(k for k in set(want) | set(have) if want.get(k) != have.get(k))
        if diffs:
            detail = ", ".join(f"{k}: trained {want.get(k)!r} vs now {have.get(k)!r}"
                               for k in diffs)
            raise SystemExit(
                f"checkpoint {ckpt_path} was trained with a different {name} configuration: "
                f"{detail}. The weights would load either way, so continuing would score or "
                "serve the WRONG architecture. Pass the recorded flags, or set "
                "DPT_SKIP_CONFIG_CHECK=1 to override.")


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--data", required=True, help="glob for patient dirs, e.g. 'data/pt_*'")
    p.add_argument("--val-data", default=None)
    p.add_argument("--size", type=int, default=None, help="limit #patients")
    p.add_argument("--epochs", type=int, default=1300)
    p.add_argument("--check-val", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--lr", type=float, default=_DEFAULT_LR)
    p.add_argument("--weight-decay", type=float, default=0.00016303111017674179)
    p.add_argument("--optimizer", choices=["adamw", "adam8bit"], default=None,
                   help="default: adam8bit for pyfer, adamw otherwise")
    p.add_argument("--ckpt-dir", default="checkpoints")
    p.add_argument("--log-dir", default="logs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--mesh", default=None,
                   help=f"a device mesh, e.g. 'data=4': not ported ({_INFRA})")
    p.add_argument("--model-size", choices=["full", "small"], default="full",
                   help="'small' = reduced-width dev model for smoke runs and tests")
    p.add_argument("--feed-dtype", choices=["float32", "bfloat16", "packed"],
                   default="float32",
                   help="bfloat16 = native fused augmentation, half the host-to-card "
                        "bytes; packed = bit-packed masks, unpacked and augmented on "
                        "the card (data/packed.py)")
    p.add_argument("--save-per-epoch", type=int, default=None,
                   help="every N epochs also write a never-rotated 'iter_<step>' slot")
    p.add_argument("--samples-per-epoch", type=int, default=None,
                   help="fix the epoch at N samples, cycling through the shuffled cohort")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="average k micro-batch gradients per update")
    p.add_argument("--remat-blocks", action="store_true",
                   help="per-block recompute in the decoders: less activation memory")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the first epoch here")


def _add_unported(sub, name: str, help_text: str):
    sub.add_parser(name, help=f"{help_text} (not ported: {_UNPORTED_COMMANDS[name]})")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dose_prediction_tpu_torch",
                                 description="Dose prediction on an NVIDIA GPU (PyTorch/CUDA)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where models run; 'cuda' (default) needs a card and never falls "
                         "back to the CPU")
    sub = ap.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train", help="train a model")
    tr.add_argument("model", choices=["pyfer", "c3d", "hdunet", "transeg", "dosegan",
                                      "vitgan", "exp"])
    _add_common(tr)
    tr.add_argument("--pretrained-critic", default=None,
                    help="vitgan: a MedicalNet resnet_10 torch pickle for the critic; its "
                         "leaves stay frozen until the unfreeze epoch")
    tr.add_argument("--unfreeze-epoch", type=int, default=10,
                    help="vitgan: the epoch at which the critic unfreezes and both "
                         "optimizers restart")
    tr.add_argument("--pretrained-c3d", default=None,
                    help="a trained C3D cascade (a slot of this package, or a reference "
                         "torch checkpoint .pkl/.pt/.pth/.ckpt) for net_A surgery")
    tr.add_argument("--no-freeze", action="store_true")
    tr.add_argument("--delta1", type=float, default=10.0)
    tr.add_argument("--delta2", type=float, default=8.0)
    tr.add_argument("--act", choices=["relu", "mish"], default="mish",
                    help="pyfer and exp decoder activation (tuned default mish)")
    tr.add_argument("--mode-model", type=int, choices=[0, 1], default=1,
                    help="seg task: 1 = TranSeg; 0 = plain UNETR")
    tr.add_argument("--block-family", choices=["seg", "old", "ablation"], default="seg",
                    help="TranSeg conv-block flavor ('old' = the reference's mode_model=1 "
                         "checkpoints)")
    tr.add_argument("--k7-mode", choices=["dense", "separable"], default="dense",
                    help="seg decoder k7 flavor ('separable' = 1-D chains)")
    tr.add_argument("--private-data", action="store_true",
                    help="seg task: --data is the private 13-OAR head dataset")
    tr.add_argument("--roi", type=int, default=96,
                    help="seg task: training crop and validation window")
    tr.add_argument("--lr-encoder", type=float, default=None, help="c3d: encoder rate")
    tr.add_argument("--lr-decoder", type=float, default=None, help="c3d: decoder rate")
    tr.add_argument("--scheduler", choices=["multistep", "cosine", "plateau"], default=None,
                    help="c3d rate schedule (horizons in optimizer steps)")
    tr.add_argument("--milestones", type=int, nargs="*", default=[])
    tr.add_argument("--gamma", type=float, default=0.1)
    tr.add_argument("--t-max", type=int, default=None, help="cosine horizon (steps)")
    tr.add_argument("--eta-min", type=float, default=0.0)

    ev = sub.add_parser("eval", help="OpenKBP scoring sweep of a dose checkpoint")
    _add_common(ev)
    ev.add_argument("--model", choices=_DOSE_MODELS, default="pyfer")
    ev.add_argument("--ckpt", required=True, help="a slot file, e.g. <ckpt-dir>/last.pt")
    ev.add_argument("--act", choices=["relu", "mish"], default="mish")
    ev.add_argument("--device-metrics", action="store_true",
                    help="score on the device: only scalars and the IVS curve leave it")
    ev.add_argument("--plots-dir", default=None,
                    help="per-patient DVH figures and slice triptychs (needs matplotlib)")

    se = sub.add_parser("seg-eval", help="OAR segmentation sweep: sliding-window Dice, "
                                         "HD95 and DiceCE val loss")
    _add_common(se)
    se.add_argument("--ckpt", required=True)
    se.add_argument("--mode-model", type=int, choices=[0, 1], default=1)
    se.add_argument("--block-family", choices=["seg", "old", "ablation"], default="seg")
    se.add_argument("--k7-mode", choices=["dense", "separable"], default="dense")
    se.add_argument("--sw-batch", type=int, default=4)
    se.add_argument("--roi", type=int, default=96)
    se.add_argument("--private-data", action="store_true")

    inf = sub.add_parser("infer", help="linked cascade inference on one patient")
    inf.add_argument("--patient", required=True, help="patient directory")
    inf.add_argument("--seg-ckpt", required=True)
    inf.add_argument("--dose-ckpt", required=True)
    inf.add_argument("--out", required=True, help="output dose .nii.gz")
    inf.add_argument("--seg-mode", choices=["sliding", "dense"], default="sliding")
    inf.add_argument("--model-size", choices=["full", "small"], default="full")
    inf.add_argument("--roi", type=int, default=96,
                     help="the ROI the seg checkpoint was trained at")
    inf.add_argument("--mode-model", type=int, choices=[0, 1], default=1,
                     help="the seg checkpoint's network: 1 = TranSeg, 0 = plain UNETR")
    inf.add_argument("--block-family", choices=["seg", "old", "ablation"], default="seg")
    inf.add_argument("--k7-mode", choices=["dense", "separable"], default="dense")
    inf.add_argument("--serve-dtype", choices=["float32", "bfloat16"], default="float32",
                     help="'bfloat16' = bf16 activations (parameters stay float32), "
                          "8 windows a batch")

    pr = sub.add_parser("predict", help="dose predictions for a cohort as NIfTI files")
    _add_common(pr)
    pr.add_argument("--model", choices=_DOSE_MODELS, default="pyfer")
    pr.add_argument("--ckpt", required=True)
    pr.add_argument("--act", choices=["relu", "mish"], default="mish")
    pr.add_argument("--out-dir", required=True,
                    help="one <out-dir>/<patient_id>/dose.nii.gz per patient")

    it = sub.add_parser("import-torch",
                        help="a reference torch checkpoint (NetworkTrainer .pkl, Lightning "
                             ".ckpt or a bare state dict) into a slot file")
    it.add_argument("--kind", required=True,
                    choices=["c3d", "pyfer", "transeg", "unetr", "resnet10", "hdunet",
                             "dosegan-g", "dosegan-d", "vitgan-g", "exp-gen"],
                    help="'vitgan-g' = ViT-GAN's generator, 'exp-gen' = the exp models' "
                         "generator, 'resnet10' = a MedicalNet resnet_10 (the ViT-GAN critic)")
    it.add_argument("--act", choices=["relu", "mish"], default="mish",
                    help="exp-gen: the activation the source was trained with")
    it.add_argument("--src", required=True, help="torch checkpoint path")
    it.add_argument("--dest", required=True, help="output slot file")
    it.add_argument("--model-size", choices=["full", "small"], default="full")
    it.add_argument("--block-family", choices=["seg", "old", "ablation"], default="old",
                    help="the transeg flavor the source was trained with; the reference's "
                         "mode_model=1 trains the OldModels TRANSEG flavor = 'old'")
    it.add_argument("--volume-size", type=int, default=128,
                    help="pyfer, vitgan-g, exp-gen volume (their ViT grid)")
    it.add_argument("--roi", type=int, default=96, help="transeg window")
    it.add_argument("--strict", action="store_true",
                    help="c3d, pyfer, resnet10: fail unless every model entry is covered by "
                         "the source (transeg, unetr, hdunet, dosegan-g/-d, vitgan-g and "
                         "exp-gen always load strictly)")

    op = sub.add_parser("openkbp-prepare",
                        help="the official OpenKBP CSV release into the NIfTI layout "
                             "(host only)")
    op.add_argument("--csv-dir", required=True)
    op.add_argument("--out-dir", required=True)
    op.add_argument("--pattern", default="pt_*")
    op.add_argument("--ct-offset", type=float, default=0.0)
    op.add_argument("--assume-spacing", default=None, metavar="D,H,W")

    sc = sub.add_parser("score", help="directory-based OpenKBP scoring of saved "
                                      "predictions (host only)")
    sc.add_argument("--pred-dir", required=True)
    sc.add_argument("--gt-dir", required=True)

    le = sub.add_parser("linked-eval", help="cohort end-to-end cascade scoring: CT → seg → "
                                            "one-hot OARs → dose, with dose, DVH and IVS "
                                            "scores (train_light_linked_model.py:138-228)")
    _add_common(le)
    le.add_argument("--seg-ckpt", required=True)
    le.add_argument("--dose-ckpt", required=True)
    le.add_argument("--plots-dir", default=None, help="DVH plots and slice triptychs "
                                                      "(needs matplotlib)")
    le.add_argument("--roi", type=int, default=96, help="seg sliding-window ROI")
    le.add_argument("--sw-batch", type=int, default=4)
    le.add_argument("--seg-mode", choices=["sliding", "dense"], default="sliding")
    le.add_argument("--block-family", choices=["seg", "old", "ablation"], default="seg",
                    help="TranSeg conv-block flavor of the seg checkpoint ('old' = what "
                         "import-torch writes for reference mode_model=1 sources)")
    le.add_argument("--k7-mode", choices=["dense", "separable"], default="dense")
    le.add_argument("--no-ivs", action="store_true")
    le.add_argument("--serve-dtype", choices=["float32", "bfloat16"], default="float32",
                    help="'bfloat16' = bf16 activations (parameters stay float32)")
    tu = sub.add_parser("tune", help="ASHA hyperparameter search of DOSE-PYFER (act, "
                                     "multiS_conv, lr, weight decay)")
    _add_common(tu)
    tu.add_argument("--num-samples", type=int, default=10)
    tu.add_argument("--sampler", choices=["random", "tpe", "gp"], default="tpe",
                    help="'tpe' = OptunaSearch analogue, 'gp' = BayesOptSearch analogue "
                         "(GP expected improvement)")
    tu.add_argument("--max-concurrent", type=int, default=1,
                    help="trials at once, round-robin over the visible cards (with --device "
                         "cuda; on one card they share it)")
    tu.add_argument("--grace-period", type=int, default=1,
                    help="ASHA grace period in validation rounds")
    tu.add_argument("--resume", action="store_true",
                    help="continue an interrupted search from <log-dir>/trials.jsonl "
                         "(completed trials seed the sampler and the ASHA rungs; only the "
                         "remaining trials run)")

    kf = sub.add_parser("kfold", help="k-fold cross validation of DOSE-PYFER")
    _add_common(kf)
    kf.add_argument("--folds", type=int, default=6)
    kf.add_argument("--start-fold", type=int, default=0)
    _add_unported(sub, "bench", "the 128³ cascade latency benchmark")

    dr = sub.add_parser("doctor", help="preflight report: versions, the card, native IO, the "
                                       "kernel build, serve capture, and optional --data sanity")
    dr.add_argument("--data", default=None,
                    help="also check a patient-dir glob (e.g. '/data/train-pats/pt_*')")
    dr.add_argument("--probe", action="store_true",
                    help="launch K1 once on the card in a killable subprocess and report the "
                         "round trip (with --probe doctor never touches the card itself)")
    dr.add_argument("--probe-timeout", type=float, default=600.0,
                    help="seconds before the probe's card is declared unresponsive")
    dr.add_argument("--json", action="store_true",
                    help="print the whole report as JSON instead of the [ok]/[warn] lines")
    dr.add_argument("--strict", action="store_true",
                    help="exit 1 when any warning is present (CI gate)")
    return ap


def _load_into(model, state_dict, what: str) -> None:
    """Load a checkpoint's state dict into ``model``, or exit naming what
    differs (the JAX CLI's _graft_variables, :857-881)."""
    mine = model.state_dict()
    missing = sorted(set(mine) - set(state_dict))[:5]
    extra = sorted(set(state_dict) - set(mine))[:5]
    if missing or extra:
        raise SystemExit(f"checkpoint does not match the constructed {what} architecture "
                         f"(check --model/--model-size/--act): missing {missing}, "
                         f"unexpected {extra}")
    bad = [(k, tuple(state_dict[k].shape), tuple(v.shape)) for k, v in mine.items()
           if tuple(state_dict[k].shape) != tuple(v.shape)]
    if bad:
        raise SystemExit(f"checkpoint shapes do not match the constructed {what} "
                         f"architecture (check --model-size): {bad[:5]}")
    model.load_state_dict(state_dict, strict=True)


def _read_slot(path):
    from dose_prediction_tpu_torch.core.checkpoint import (
        restore_checkpoint,
        variables_from_checkpoint,
    )

    return variables_from_checkpoint(restore_checkpoint(path))


def _refuse_unported(args) -> None:
    """Refuse, before any device work, a choice the port does not have."""
    if args.cmd in _UNPORTED_COMMANDS:
        raise refuse(f"the {args.cmd} subcommand", _UNPORTED_COMMANDS[args.cmd])
    if getattr(args, "mesh", None):
        raise refuse("--mesh", _INFRA)


def main(argv=None) -> int:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    _refuse_unported(args)
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")

    if args.cmd == "openkbp-prepare":
        from dose_prediction_tpu_torch.data.openkbp_prepare import prepare_cohort

        spacing = None
        if args.assume_spacing:
            try:
                spacing = tuple(float(s) for s in args.assume_spacing.split(","))
            except ValueError:
                raise SystemExit("--assume-spacing wants three numbers: D,H,W")
            if len(spacing) != 3 or any(not (s > 0) for s in spacing):
                raise SystemExit("--assume-spacing wants three POSITIVE values: D,H,W")
        n = prepare_cohort(args.csv_dir, args.out_dir, pattern=args.pattern,
                           ct_offset=args.ct_offset, default_spacing=spacing)
        print(json.dumps({"patients_converted": n, "out_dir": args.out_dir}))
        return 0

    if args.cmd == "doctor":
        from dose_prediction_tpu_torch.cli import doctor

        return doctor.run(args)

    if args.cmd == "score":
        from dose_prediction_tpu_torch.evaluation.metrics import score_prediction_dirs

        dose_dif, dvh_dif, metric_means = score_prediction_dirs(args.pred_dir, args.gt_dir)
        if math.isnan(dose_dif):
            print("score: no scorable patients: <pred-dir> must hold "
                  "<patient_id>/dose.nii.gz and <gt-dir> (a plain directory, not a glob) "
                  "matching <patient_id>/ folders with dose.nii.gz and "
                  "possible_dose_mask.nii.gz", file=sys.stderr)
            return 1
        print(json.dumps({"dose_score": dose_dif, "dvh_score": dvh_dif,
                          "metrics": metric_means}, indent=2))
        return 0

    import torch

    from dose_prediction_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":    # score, doctor and openkbp-prepare returned above
        from dose_prediction_tpu_torch.core.bootstrap import configure_compile_cache

        configure_compile_cache()
    if getattr(args, "plots_dir", None):
        from dose_prediction_tpu_torch.evaluation.plots import PlotsUnavailable, pyplot

        try:
            pyplot()
        except PlotsUnavailable as e:
            raise SystemExit(str(e))

    from dose_prediction_tpu_torch.data.openkbp import OpenKBPDataset
    from dose_prediction_tpu_torch.train import trainers as T

    small = getattr(args, "model_size", "full") == "small"

    def make_cfg(model_name=None) -> "T.TrainConfig":
        return T.TrainConfig(
            max_epochs=args.epochs, check_val=args.check_val, batch_size=args.batch_size,
            learning_rate=args.lr, weight_decay=args.weight_decay, ckpt_dir=args.ckpt_dir,
            log_dir=args.log_dir, seed=args.seed, max_steps=args.max_steps,
            optimizer=resolve_optimizer(args.optimizer, model_name),
            delta1=getattr(args, "delta1", 10.0), delta2=getattr(args, "delta2", 8.0),
            freeze_net_a=not getattr(args, "no_freeze", False),
            feed_dtype=args.feed_dtype, samples_per_epoch=args.samples_per_epoch,
            save_per_epoch=args.save_per_epoch, grad_accum=args.grad_accum,
            remat_blocks=args.remat_blocks, profile_dir=args.profile_dir,
            lr_encoder=getattr(args, "lr_encoder", None),
            lr_decoder=getattr(args, "lr_decoder", None),
            scheduler=getattr(args, "scheduler", None),
            milestones=tuple(getattr(args, "milestones", []) or []),
            gamma=getattr(args, "gamma", 0.1), t_max=getattr(args, "t_max", None),
            eta_min=getattr(args, "eta_min", 0.0), device=str(device))

    def pyfer_model(shape, seed, act=None, multiS_conv=True, on=None):
        return T.seeded(seed, lambda: default_flagship_model(
            act=act or getattr(args, "act", "mish"),
            remat_blocks=getattr(args, "remat_blocks", False), small=small,
            img_size=tuple(shape), device=on or device, multiS_conv=multiS_conv))

    def transeg_model(seed, out_ch=8, trained_grid=None, roi=None):
        roi = roi or args.roi
        return T.seeded(seed, lambda: default_seg_model(
            out_ch=out_ch, block_family=args.block_family, trained_grid=trained_grid,
            remat_blocks=getattr(args, "remat_blocks", False),
            k7_mode=getattr(args, "k7_mode", "dense"),
            small=small, img_size=(roi,) * 3, device=device))

    def seg_model(seed, out_ch=8, trained_grid=None, roi=None):
        """TranSeg, or with --mode-model 0 the plain UNETR."""
        if getattr(args, "mode_model", 1) == 0:
            return T.seeded(seed, lambda: default_unetr_model(
                out_ch=out_ch, trained_grid=trained_grid, small=small,
                img_size=((roi or args.roi),) * 3, device=device))
        return transeg_model(seed, out_ch, trained_grid, roi)

    def seg_trainer(cfg, num_classes):
        cls = T.UNETRSegTrainer if getattr(args, "mode_model", 1) == 0 else T.TranSegTrainer
        return cls(cfg, model=seg_model(cfg.seed, out_ch=num_classes), crop=(args.roi,) * 3,
                   num_classes=num_classes)

    def build_dose_trainer(model_name: str, cfg, shape):
        """One construction path for train, eval and predict, so that a
        train → eval round trip rebuilds the same architecture."""
        ex = (1, *shape, 9)
        if model_name == "pyfer":
            pre = None
            if getattr(args, "pretrained_c3d", None):
                if args.pretrained_c3d.endswith((".pkl", ".pth", ".ckpt")):
                    from dose_prediction_tpu_torch.core.torch_import import (
                        load_torch_checkpoint,
                    )

                    pre = load_torch_checkpoint(args.pretrained_c3d)
                else:
                    pre = _read_slot(args.pretrained_c3d)
                if not any(k.startswith(("net_A.", "conv_out_A.")) for k in pre):
                    raise SystemExit(f"--pretrained-c3d {args.pretrained_c3d}: no net_A or "
                                     "conv_out_A entry to copy (not a C3D cascade?)")
            return T.PyferTrainer(cfg, model=pyfer_model(shape, cfg.seed),
                                  pretrained_c3d_params=pre, example_shape=ex)
        if model_name == "hdunet":
            model = T.seeded(cfg.seed, lambda: default_hdunet_model(small, device))
            return T.HDUNetTrainer(cfg, model=model, example_shape=ex)
        if model_name == "dosegan":
            # the GAN's rates default to the reference's; an explicit --lr
            # sets them (the parser's default is the pyfer-tuned rate)
            kw = {"gan_lr": args.lr} if args.lr != _DEFAULT_LR else {}
            width = default_dosegan_width(small)
            return T.DoseGANTrainer(cfg, ngf=width, ndf=width, example_shape=ex, **kw)
        if model_name == "vitgan":
            from dose_prediction_tpu_torch.train.gan import VitGANTrainer

            kw = {"g_lr": args.lr, "d_lr": args.lr} if args.lr != _DEFAULT_LR else {}
            gen = T.seeded(cfg.seed, lambda: default_vitgan_generator(small, shape, device))
            return VitGANTrainer(cfg, generator=gen, example_shape=ex,
                                 unfreeze_epoch=getattr(args, "unfreeze_epoch", 10),
                                 pretrained_critic=getattr(args, "pretrained_critic", None), **kw)
        if model_name == "exp":
            model = T.seeded(cfg.seed, lambda: default_exp_generator(
                small, shape, device, act=getattr(args, "act", "mish")))
            return T.ExpModelTrainer(cfg, model, example_shape=ex)
        model = T.seeded(cfg.seed, lambda: small_c3d(device)) if small else None
        return T.CascadeC3DTrainer(cfg, model=model, example_shape=ex)

    if args.cmd == "import-torch":
        from dose_prediction_tpu_torch.core.checkpoint import merge_partial, save_checkpoint
        from dose_prediction_tpu_torch.core.torch_import import (
            LIGHTNING_PREFIXES,
            gan_part,
            load_reference_strict,
            load_torch_checkpoint,
            strip_lightning_prefixes,
            vit_generator_part,
        )

        source = load_torch_checkpoint(args.src)
        if args.kind in ("transeg", "unetr", "hdunet", "dosegan-g", "dosegan-d", "vitgan-g",
                         "exp-gen"):
            prefixes = LIGHTNING_PREFIXES
            if args.kind in ("vitgan-g", "exp-gen"):
                # the generator's entries under its Lightning prefix, without
                # the critic's and the unused head (torch_import.py:284-311)
                source, prefixes = vit_generator_part(source), ()
                volume = (args.volume_size,) * 3
                model = T.seeded(0, lambda: default_vitgan_generator(small, volume, device)
                                 if args.kind == "vitgan-g" else
                                 default_exp_generator(small, volume, device, act=args.act))
            elif args.kind.startswith("dosegan"):
                from dose_prediction_tpu_torch.models import NLayerDiscriminator, UnetGenerator3D

                # a combined GAN checkpoint: this net's netG./netD. entries
                # (torch_import.py:544-656); the nets' own top module is
                # 'model', so no Lightning prefix is stripped
                part = args.kind[-1]
                source, prefixes = gan_part(source, part), ()
                width = default_dosegan_width(small)
                model = T.seeded(0, lambda: UnetGenerator3D(ngf=width, device=device)
                                 if part == "g" else NLayerDiscriminator(ndf=width, device=device))
            elif args.kind == "hdunet":
                model = T.seeded(0, lambda: default_hdunet_model(small, device))
            elif args.kind == "unetr":
                model = T.seeded(0, lambda: default_unetr_model(
                    small=small, img_size=(args.roi,) * 3, device=device))
            else:
                model = transeg_model(0, roi=args.roi)
            try:
                load_reference_strict(model, source, prefixes=prefixes)
            except ValueError as e:
                raise SystemExit(f"[import-torch] {args.kind}: {e}")
            print(f"[import-torch] {args.kind}: loaded all {len(model.state_dict())} entries "
                  "strictly")
            save_checkpoint(args.dest, {k: v.cpu() for k, v in model.state_dict().items()})
            print(f"[import-torch] wrote {args.dest}")
            return 0
        if args.kind == "pyfer":
            model = pyfer_model((args.volume_size,) * 3, 0)
        elif args.kind == "resnet10":
            # a MedicalNet segmentation pretrain holds no fc: strict=False
            # keeps the model's own (train_light_gan.py:136-141)
            model = T.seeded(0, lambda: default_resnet10(small, device))
        else:
            from dose_prediction_tpu_torch.models import CascadeC3D

            model = small_c3d(device) if small else CascadeC3D(device=device)
        # the reference's strict=False surgery (dose_pyfer.py:394-407): an
        # entry the source lacks keeps the model's own initialization
        merged, stats = merge_partial(model.state_dict(), strip_lightning_prefixes(source),
                                      verbose=False)
        print(f"[import-torch] {args.kind}: copied {stats['copied']} / inside "
              f"{stats['inside']}, missing {stats['missing']}, unused {stats['unused']}")
        if args.strict and (stats["missing"] or stats["copied"] < stats["inside"]):
            print(f"[import-torch] --strict: {stats['missing']} entries not covered by the "
                  f"source, {stats['inside'] - stats['copied']} skipped on shape mismatch",
                  file=sys.stderr)
            return 1
        model.load_state_dict(merged, strict=True)
        save_checkpoint(args.dest, {k: v.cpu() for k, v in model.state_dict().items()})
        print(f"[import-torch] wrote {args.dest}")
        return 0

    if args.cmd == "train":
        cfg = make_cfg(args.model)
        if args.model == "transeg":
            if args.private_data:
                from dose_prediction_tpu_torch.data.private_seg import PrivateSegDataset

                train_ds = PrivateSegDataset(args.data, split="train").as_seg()
                val_ds = PrivateSegDataset(args.val_data or args.data, split="val").as_seg()
                num_classes = 14
            else:
                train_ds = OpenKBPDataset(args.data, size=args.size)
                val_ds = (OpenKBPDataset(args.val_data, keep_structures=True)
                          if args.val_data else None)
                num_classes = 8
            seg_trainer(cfg, num_classes).fit(train_ds, val_ds)
            return 0
        train_ds = OpenKBPDataset(args.data, size=args.size)
        val_ds = (OpenKBPDataset(args.val_data, keep_structures=True)
                  if args.val_data else None)
        # the ViT's token grid follows the data, not an assumed 128³
        trainer = build_dose_trainer(args.model, cfg, train_ds.patients[0].ct.shape)
        trainer.fit(train_ds, val_ds)
        return 0

    def restored_dose_trainer(model_name: str, shape):
        """A trainer of ``model_name`` holding the weights of args.ckpt (a
        trainer slot or an import-torch output) and its ``predict_fn(batch)
        -> Gy prediction`` (:883-934)."""
        tr = build_dose_trainer(model_name, make_cfg(model_name), shape)
        if model_name in ("dosegan", "vitgan"):
            from dose_prediction_tpu_torch.core.checkpoint import restore_checkpoint

            _check_ckpt_config(args.ckpt, tr.gen, tr.disc)
            slot = restore_checkpoint(args.ckpt)
            _load_into(tr.gen, _read_slot(args.ckpt), "generator")
            if isinstance(slot.get("d"), dict):          # a trainer slot holds the critic too
                _load_into(tr.disc, slot["d"]["model"], "discriminator")
            if model_name == "vitgan":                    # sliding window ×80 (:925-933)
                return tr, tr.predict_fn()
            return tr, lambda batch: tr.eval_step(batch)["prediction"]
        _check_ckpt_config(args.ckpt, tr.model)
        _load_into(tr.model, _read_slot(args.ckpt), "model")
        if model_name in ("pyfer", "hdunet"):
            return tr, lambda batch: tr.eval_step(batch)["prediction"]
        if model_name == "exp":
            return tr, tr.predict_fn()
        from dose_prediction_tpu_torch.evaluation.metrics import postprocess_prediction

        return tr, lambda batch: postprocess_prediction(tr.predict(batch["input"]),
                                                        batch["gt"][..., 1:2])

    if args.cmd == "tune":
        return _tune(args, make_cfg, pyfer_model, device)

    if args.cmd == "kfold":
        from dose_prediction_tpu_torch.train.kfold import run_kfold

        ds = OpenKBPDataset(args.data, size=args.size, keep_structures=True)

        def make_trainer(fold, ckpt_dir):
            cfg = make_cfg("pyfer")
            cfg = T.TrainConfig(**{**cfg.__dict__, "ckpt_dir": ckpt_dir,
                                   "log_dir": str(Path(args.log_dir) / f"fold_{fold}")})
            return build_dose_trainer("pyfer", cfg, ds.patients[0].ct.shape)

        results = run_kfold(ds, make_trainer, n_folds=args.folds, start_fold=args.start_fold,
                            base_dir=args.ckpt_dir)
        print(json.dumps({f: {"mean_dose_score": r.get("mean_dose_score")}
                          for f, r in results.items()}, indent=2))
        return 0

    if args.cmd == "eval":
        ds = OpenKBPDataset(args.data, size=args.size, keep_structures=True)
        trainer, _ = restored_dose_trainer(args.model, ds.patients[0].ct.shape)
        results = trainer.test(ds, device_metrics=args.device_metrics,
                               plots_dir=args.plots_dir)
        print(json.dumps({k: v for k, v in results.items() if k != "per_patient"}, indent=2))
        return 0

    if args.cmd == "seg-eval":
        if args.private_data:
            from dose_prediction_tpu_torch.data.private_seg import PrivateSegDataset

            ds = PrivateSegDataset(args.data, split="val").as_seg()
            num_classes = 14
        else:
            ds = OpenKBPDataset(args.data, size=args.size, keep_structures=True)
            num_classes = 8
        tr = seg_trainer(make_cfg(), num_classes)
        _check_ckpt_config(args.ckpt, tr.model)
        _load_into(tr.model, _read_slot(args.ckpt), "seg model")
        dice, hd95, val_loss = tr.validate(ds, sw_batch_size=args.sw_batch)
        print(json.dumps({"dice_metric": dice, "hd95_metric": hd95, "val_loss": val_loss},
                         indent=2))
        return 0

    if args.cmd == "predict":
        from dose_prediction_tpu_torch.data.nifti import write_nifti

        ds = OpenKBPDataset(args.data, size=args.size)
        _, predict_fn = restored_dose_trainer(args.model, ds.patients[0].ct.shape)
        out_root = Path(args.out_dir)
        for p in ds.patients:
            batch = {"input": torch.from_numpy(p.model_input[None]).to(device),
                     "gt": torch.from_numpy(p.gt[None]).to(device)}
            pred = predict_fn(batch).cpu().numpy()[0, ..., 0]
            out = out_root / p.patient_id
            out.mkdir(parents=True, exist_ok=True)
            write_nifti(out / "dose.nii.gz", pred, spacing=p.spacing)
            print(f"wrote {out / 'dose.nii.gz'}")
        return 0

    if args.cmd == "infer":
        from dose_prediction_tpu_torch.data.nifti import write_nifti
        from dose_prediction_tpu_torch.data.openkbp import load_patient
        from dose_prediction_tpu_torch.infer.cascade import make_cascade_fn
        p = load_patient(args.patient)
        serve_bf16 = args.serve_dtype == "bfloat16"
        # dense mode: the token grid of the ROI the checkpoint was trained at
        grid = (args.roi // SEG_PATCH,) * 3 if args.seg_mode == "dense" else None
        seg = seg_model(0, trained_grid=grid)
        dose = pyfer_model(p.ct.shape, 0)
        _check_ckpt_config(args.seg_ckpt, seg)
        _check_ckpt_config(args.dose_ckpt, dose)
        _load_into(seg, _read_slot(args.seg_ckpt), "seg model")
        _load_into(dose, _read_slot(args.dose_ckpt), "dose model")
        # bf16 on the card serves through the captured stages, as the JAX
        # CLI serves through its shipped executables
        run = make_cascade_fn(seg, seg.state_dict(), dose, dose.state_dict(),
                              roi_size=(args.roi,) * 3, seg_mode=args.seg_mode,
                              sw_batch_size=8 if serve_bf16 else 4,
                              aot=serve_bf16 and device.type == "cuda",
                              input_dtype=torch.bfloat16 if serve_bf16 else None)

        def volume(a):
            return torch.from_numpy(a[None, ..., None]).to(device)

        out = run(volume(p.ct), volume(p.ptv), volume(p.dose_mask))
        write_nifti(args.out, out.float().cpu().numpy()[0, ..., 0], spacing=p.spacing)
        print(f"wrote {args.out}")
        return 0

    if args.cmd == "linked-eval":
        from dose_prediction_tpu_torch.train.linked import LinkedModel

        ds = OpenKBPDataset(args.data, size=args.size, keep_structures=True)
        # dense mode: the token grid of the ROI the seg checkpoint was trained at
        grid = (args.roi // SEG_PATCH,) * 3 if args.seg_mode == "dense" else None
        seg = transeg_model(0, trained_grid=grid)
        dose = pyfer_model(ds.patients[0].ct.shape, 0)
        _check_ckpt_config(args.seg_ckpt, seg)
        _check_ckpt_config(args.dose_ckpt, dose)
        _load_into(seg, _read_slot(args.seg_ckpt), "seg model")
        _load_into(dose, _read_slot(args.dose_ckpt), "dose model")
        model = LinkedModel(seg, dose, roi_size=(args.roi,) * 3, sw_batch_size=args.sw_batch,
                            seg_mode=args.seg_mode, serve_dtype=args.serve_dtype)
        results = model.evaluate(ds, log_dir=args.log_dir, plots_dir=args.plots_dir,
                                 with_ivs=not args.no_ivs)
        print(json.dumps({k: v for k, v in results.items() if k not in ("per_patient", "ivs")},
                         indent=2))
        return 0

    return 1


def _journaled_trials(journal: Path) -> int:
    """One more than the largest trial id in a search journal (0 without
    one); a truncated line is skipped, as train/tune.py::run_search skips it."""
    ids = []
    for line in journal.read_text().splitlines() if journal.exists() else []:
        try:
            ids.append(int(json.loads(line)["trial_id"]))
        except (ValueError, KeyError, TypeError):
            continue
    return max(ids, default=-1) + 1


def _tune(args, make_cfg, pyfer_model, device) -> int:
    """The ``tune`` subcommand (:1072-1142): DOSE-PYFER trials, each with
    its own ``trial_<n>`` checkpoint and log directories (numbered on from
    the journal's trials on ``--resume``), reporting each
    validation round's -mean_dose_score to ASHA (an early stop ends the
    trial's fit). Trial i runs on card i mod the visible cards' count, or
    on the CPU with ``--device cpu``. The settings every trial shares are
    kept beside the journal, and a ``--resume`` under other settings is
    refused."""
    import itertools
    import threading

    import torch

    from dose_prediction_tpu_torch.data.openkbp import OpenKBPDataset
    from dose_prediction_tpu_torch.train import trainers as T
    from dose_prediction_tpu_torch.train.tune import ASHAScheduler, run_search

    train_ds = OpenKBPDataset(args.data, size=args.size)
    val_ds = OpenKBPDataset(args.val_data, size=args.size) if args.val_data else train_ds
    shape = train_ds.patients[0].ct.shape
    # trial_<n> directories go on from the journaled trials, so that a resumed
    # search never writes over a finished trial's
    trial_counter = itertools.count(_journaled_trials(Path(args.log_dir) / "trials.jsonl")
                                    if args.resume else 0)
    # one trial builds its model at a time: the seeded construction sets
    # torch's global generators
    building = threading.Lock()

    def train_trial(config, report, trial_device):
        tid = next(trial_counter)
        cfg = T.TrainConfig(**{**make_cfg("pyfer").__dict__,
                               "learning_rate": config["lr"],
                               "weight_decay": config["weight_decay"],
                               "max_epochs": args.epochs, "device": str(trial_device),
                               "ckpt_dir": str(Path(args.ckpt_dir) / f"trial_{tid}"),
                               "log_dir": str(Path(args.log_dir) / f"trial_{tid}")})
        with building:
            model = pyfer_model(shape, cfg.seed, act=config["act"],
                                multiS_conv=config["multiS_conv"], on=trial_device)
            trainer = T.PyferTrainer(cfg, model=model, example_shape=(1, *shape, 9))
        rounds = itertools.count(1)

        def on_validation(epoch, metrics):
            return report(next(rounds), -metrics["mean_dose_score"])

        trainer.fit(train_ds, val_ds, resume=False, on_validation=on_validation)
        return -trainer.best_val          # the search minimizes

    # the settings every trial shares (not searched): a resume under others
    # would mix trials trained differently into one sampler and rung history
    shared = {"optimizer": make_cfg("pyfer").optimizer, "model_size": args.model_size,
              "feed_dtype": args.feed_dtype}
    shared_path = Path(args.log_dir) / "tune_config.json"
    if args.resume and shared_path.exists():
        prior = json.loads(shared_path.read_text())
        if prior != shared:
            raise SystemExit(
                f"tune --resume: this search's journaled trials ran with {prior}, the current "
                f"invocation would run {shared}; their scores are not comparable. Relaunch "
                f"with the recorded settings (e.g. --optimizer {prior.get('optimizer')}) or "
                "start a fresh --log-dir.")
    shared_path.parent.mkdir(parents=True, exist_ok=True)
    shared_path.write_text(json.dumps(shared, indent=2, sort_keys=True))
    devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
               if device.type == "cuda" else [device])
    scheduler = ASHAScheduler(max_t=max(1, args.epochs // args.check_val),
                              grace_period=args.grace_period, mode="min")
    res = run_search(train_trial, num_samples=args.num_samples, scheduler=scheduler,
                     sampler=args.sampler, max_concurrent=args.max_concurrent,
                     out_dir=args.log_dir, resume=args.resume, devices=devices)
    print(json.dumps({"best_config": res["best_config"], "best_value": res["best_value"],
                      "num_early_stopped": res["num_early_stopped"]}, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
