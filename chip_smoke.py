#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dose_prediction_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its seconds on a line of its own:

1. device   require CUDA (no fallback) and print the card's name and power
            limit as nvidia-smi reports them;
2. build    build the CUDA kernels (one nvcc process per csrc/*.cu, all
            in parallel, then one link);
3. kernels  hold K1 (attention, at the sliding TranSeg's, DOSE-PYFER's,
            the dense TranSeg's and the TranSeg train step's shapes), K2
            (instance norm, at the eleven shapes a serve request gives it in
            bfloat16, the dense TranSeg's among them, the ten of the TranSeg
            and C3D train steps, and two in float32) and K3
            (same-size 3x3x3 conv, at the eight shapes of the C3D, DOSE-PYFER
            and TranSeg convs it takes in a serve_k3 request and the six of
            the routed train steps) against their plain PyTorch
            versions, in float32 and bfloat16, and time kernel, plain
            version and one PyTorch library call computing the same function
            (a yardstick the port never calls), beside the least time the
            card could take; K1, K2 and bfloat16 K3 also from a replayed
            CUDA graph (device time without the host's launch cost); K1's
            bfloat16 block shape at each shape (and every block shape timed)
            and the HMMA (tensor-core) instructions in its SASS, and K3's
            bfloat16 HMMA and LDSM (ldmatrix) counts; K2's path and chunk
            at each shape (any serve shape on the two-kernel path fails),
            and both paths timed; K2 and K3 also at the shapes the zoo
            phase gives them, in bfloat16 and float32;
4. parity   the full-width 128³ serve cascade (12-layer ViT-768 TranSeg over
            96³ windows, then DOSE-PYFER) in float32 with TF32 off, once
            through the kernels and once with the plain versions swapped in,
            with the K3 routing off and then on;
5. serve    three bfloat16 requests after one warm-up through the same
            entry points, with the kernels' launch counts read around them;
6. profile  one more bfloat16 request under torch.profiler: device time by
            kernel group and the device's idle share;
7. serve_k3 the same three requests with the K3 routing on
            (DPT_PALLAS_CONV=1: same-size 3x3x3 convs with C in {16, 32,
            64} go to K3), K3's calls per request by shape (they must sum
            to its launches), and one more request under the profiler;
8. dense    one warm-up and five bfloat16 requests through make_cascade_fn
            with seg_mode='dense' (bench.py's dense_fastpath_p50_s), K1's
            and K2's launches per request and K2's calls by shape (each must
            be a shape the kernels phase held), one more under the profiler;
9. sweep    ten bfloat16 requests through pipeline_map over make_cascade_fn,
            each consumed by a synchronisation (bench.py's
            sweep_volumes_per_sec), then the same ten under the profiler;
10. routes  three bfloat16 requests with DPT_PALLAS_ATTENTION=0 and three
            with DPT_PALLAS_IN=0, p50 beside serve's: each switch must bring
            its kernel's launches to 0 and leave the other's as in serve;
11. parity_dense  as parity, in float32: stage 1 in dense mode (the same
            weights in a TranSeg with trained_grid (6, 6, 6) over the whole
            volume) and the sliding seg with the gaussian blend (after the
            timed phases, which so see the state the earlier phases leave);
12. train   the full-width DOSE-PYFER train step at 128³, batch 1, bfloat16
            compute, float32 parameters, AdamW, net_A frozen, routing on,
            PyTorch's TF32 defaults (cuDNN float32 convolutions in TF32):
            one warm-up and five timed steps on a fixed batch, each step's
            launches and backward recomputes of K1, K2 and K3, peak memory,
            one step under the profiler (its launches beside the per-leaf
            Adam's of PR 11); then the same with the routing off;
13. train_parity  one float32 step (TF32 off) from identical weights and
            batch through the kernels and through their plain versions: the
            loss and every gradient leaf, each leaf against its own largest
            departure in three noise runs;
14. train_seg  the full-width TranSeg (12-layer ViT-768, 12 heads, 8
            classes) train step on one seeded 96³ crop, bfloat16 compute,
            AdamW, K3 routing on: one warm-up and five timed steps, the
            launches and recomputes per step by kernel, peak memory, one
            step under the profiler;
15. train_c3d  the full-width C3D cascade step at 128³, batch 1, bfloat16,
            split encoder/decoder rates on a cosine schedule, K3 routing on:
            three timed steps after a warm-up, the same readings, each
            update's rates beside the schedule's closed form;
16. train_options  the DOSE-PYFER step of phase 12 plain, then with
            remat, remat_blocks, grad_accum=2 and adam8bit: p50, peak
            memory, optimizer state bytes; the remat steps' first loss
            against the plain step's, grad_accum's parameters unchanged
            after its first call;
17. train_seg_parity  one float32 TranSeg step as phase 13 holds the
            DOSE-PYFER step, with the K3 routing off and on;
18. data    a synthetic OpenKBP cohort of four 128³ patients written to a
            temporary directory by make_synthetic_dataset, whether the
            native library built (and the compiler's output if not), the
            cohort loaded through the native and the numpy reader (equal),
            every patient packed, the native bf16 dose augment and seg
            gather against the numpy chain and the card's unpack against
            the CPU's (bit for bit), the unpack's device ms, the host
            seconds and bytes of one batch of each feed (float32, bfloat16,
            packed);
19. train_feed  the DOSE-PYFER step of phase 12 fed from that cohort
            through device_prefetch(size=2) (pinned memory, a copy stream),
            once per feed: one warm-up and five steps, the step p50, the
            waits for the batch and at a float(loss) after the step (the
            step itself reads nothing on the host), launches per
            step (the packed feed's equal to the bfloat16 feed's), the idle
            share of one profiled step, the first losses; then two TranSeg
            steps on bf16 96³ crops from seg_batches; then one float32 step
            (TF32 off) on each of the float32 and packed feeds' first batch
            from the same weights: the losses within 2e-3, the bar of
            tests/test_packed_feed.py, which holds them in float32 (in bf16
            compute the packed CT's second rounding moves the loss more; the
            gap there is printed);
19a. mesh   PyferTrainer on a mesh (parallel/, torch.distributed) at full
            width on that cohort: (a) NCCL in this process, a world of one,
            {'data': 1, 'model': 1}, adam8bit, three steps of its fit
            (float32 at TF32 defaults; its 1 GB slot of whole leaves
            written, then removed) against the trainer without a mesh,
            eager, bit for bit (or within a second eager run's spread),
            step p50, K1/K2 launches, peak memory; the group is then torn
            down; (b) two worker processes on the one card over gloo on
            CUDA tensors (``chip_smoke.py --mesh-worker args.json``; NCCL
            refuses two ranks on one device), float32 with TF32 off, cuDNN
            at its defaults, AdamW:
            {'data': 2} with a global batch of 2, then {'model': 2} (three
            heads and 1536 of linear1 a rank) with batch 1, two steps each;
            both ranks' whole trainable leaves equal after each mesh (the
            replicas in step); rank 0 then holds the 'data' mesh and rank 1
            the 'model' mesh against the one-process run of the same global
            batch: the parameters and losses after the steps (mesh_hold)
            and the first step's gradients, leaf by leaf (mesh_grad_hold),
            by the noise-run rule, its noise from one-process runs only
            (three with noise on the kernels' outputs as large as the
            mesh's forward gap from the one-process run, at least 1e-6, and
            for batch 2 one with the rows reversed and one with every
            convolution evaluated row by row); each rank's step
            seconds, losses, K1/K2 launches a step and peak memory printed,
            and the bytes and seconds of the 'model' axis's broadcast of
            the replicated gradients (two processes sharing one card: not a
            scaling figure); (c) in the same two workers, TranSegTrainer
            at full width (12-layer ViT-768, 12 heads, feature size 16, 8
            classes; 96³ crops of that cohort, float32, AdamW) on
            {'data': 2} with a global batch of 2, then {'model': 2} (six
            heads a rank, decoder4's convs by output channel) with batch
            1, two steps each, held as (b) holds DOSE-PYFER; after the
            {'data': 2} steps, TranSegTrainer.validate of one 128³ patient
            with its 8 windows split over the ranks (4 a rank, one call):
            both ranks' logits equal, and within max(2 x the one-process
            sweep's own departure at sw batch 4, 1e-4) of one process's
            sliding_window_inference at sw batch 8 from the same weights
            (no padding window, so both sweep the same windows), its
            seconds, Dice, HD95 and K1/K2 launches a rank printed; no
            slot is written; a worker's failure or hang fails the phase,
            and the other is killed;
20. trainer the CLI (python -m dose_prediction_tpu_torch) in this process at
            full width on that cohort, float32 compute at PyTorch's TF32
            defaults, as the CLI trains: train pyfer (adam8bit, the packed
            feed, three patients, validating on the fourth, two epochs; its
            step captured as a CUDA graph at the first step, once):
            step p50 (a synchronisation after each step), the loader waits, validation
            seconds, each checkpoint write's seconds and bytes, K1 and K2
            launches per step (equal to a float32 make_pyfer_train_step's),
            the slots on disk; the same with --epochs 3 (it must resume at
            epoch 2 with the step count carried on); one epoch with
            DPT_PALLAS_CONV=1 (K3 launched every step); eval of the best
            slot with the host and the device metrics (both sweeps timed;
            the scores within the bars of tests/test_losses_metrics.py);
            predict, then score (the dose score within 1e-4 of eval's);
            train transeg (two steps on 96³ crops), then infer in bf16,
            sliding and dense, each NIfTI bit-equal to make_cascade_fn's
            output from the same restored weights; train c3d (cosine, split
            rates) and eval --model c3d; a subprocess train pyfer stopped by
            SIGTERM after its first step, which must exit 0 with a 'last'
            slot that a rerun resumes from; and --help in a subprocess;
21. zoo     the reference's other seg and dose networks at full width,
            weights from seeds on the card: float32 parity (TF32 off,
            kernels against plain versions, K3 routing off and on) of the
            plain UNETR and the 'old'-family TranSeg on a 96³ crop and of
            HD-UNet at 128³; three bf16 requests after a warm-up with the
            'old' TranSeg, then UNETR, as stage 1 over 96³ windows (sw batch
            8) into DOSE-PYFER: p50, K1 and K2 launches per request; bf16
            train steps (a warm-up and five, AdamW, K3 routing on) of
            HD-UNet at 128³ and of UNETR and the 'old' TranSeg on a 96³
            crop: p50, launches and recomputes per step, peak memory; one
            float32 HD-UNet step through the kernels against the plain
            versions, leaf by leaf; then the CLI on the data phase's cohort:
            train hdunet, eval --model hdunet (host and device metrics),
            predict --model hdunet; train transeg --block-family old, then
            import-torch --kind transeg of its state dict under 'model.'
            (forward bit-equal); train transeg --mode-model 0 and seg-eval;
            linked-eval --block-family old with the trainer phase's
            DOSE-PYFER slot, bf16, sliding and dense, each prediction
            bit-equal to make_cascade_fn's and the scores the port's
            metrics on them. Any K2 or K3 launch of the phase at a shape
            the kernels phase did not hold, in that dtype, fails it. The
            float32 HD-UNet step holds each gradient leaf to its own limit,
            max(1e-3, 2 x its largest departure in three plane-scaled noise
            runs) x its max |g| (the rule of
            tests/test_torch_port_zoo_train.py), as the DOSE-PYFER and
            TranSeg steps (phases 13 and 17, three noise runs) hold theirs;
            all three print the worst ratio of a leaf's error to its own
            per-leaf limit;
22. hpo_gan DoseGAN and the search, after zoo, on the data phase's cohort:
            the DoseGAN step at the reference's width (ngf = ndf = 64, 9 ->
            1 channels, 128³, float32 at TF32 defaults): a warm-up and five
            steps on a fixed batch, p50, peak memory, K1/K2/K3 launches per
            step (each must be 0); one float32 step (TF32 off) at ngf = ndf
            = 4 on 32³ on the card against the port on the CPU from the
            same weights (losses within 1e-5, each gradient leaf and
            BatchNorm buffer by its own noise-run limit); the CLI's train
            dosegan (two epochs of three steps, then --epochs 3 resuming at
            epoch 2), eval --model dosegan (host and device metrics) and
            predict, import-torch --kind dosegan-g and dosegan-d of the
            trained nets under netG./netD. (forward bit-equal); tune
            --sampler tpe --num-samples 3 --epochs 2 with --max-concurrent 1
            and then 2 on the one card (wall seconds, best config), tune
            --resume with --num-samples 4 (exactly one more trial), kfold
            --folds 2 --epochs 1 (each fold's score). Any K2 or K3 launch of
            the phase at a shape the kernels phase did not hold fails it;
23. exp_gan the experiments zoo and ViT-GAN, after hpo_gan, on the data
            phase's cohort: one full-width float32 forward (TF32 off) through
            the kernels and through the plain versions of ViT-GAN's and the
            exp model's generators, SharedEncoderModel, ExperimentalCascade
            (C3D widths) and SharedUNetRModel (within DOSE_TOL_OF_SCALE, K1
            and K2 launched where the model has them, K3 not); the ViT-GAN
            step (a narrow generator, hidden size 64 with 2 heads, feature
            size 2; ResNet-10 of widths 4-32; 32³, float32, TF32 off) on the
            card against the CPU with train_d on, off, and
            freeze_d with a mask (g_loss within 1e-5, d_loss and each
            gradient leaf by its own noise-run limit, frozen leaves bit-unchanged with their
            moments moved); the full-width ViT-GAN step (ResNet-10 critic)
            and the full-width exp deep-supervision step, float32 at TF32
            defaults: a warm-up and three steps, p50, peak memory, K1/K2/K3
            launches a step, K2 calls by shape; the CLI: train vitgan with a
            seeded MedicalNet-layout --pretrained-critic and --unfreeze-epoch
            1 over two one-step epochs (both optimizers restarted at epoch
            1), train exp, eval and predict of both, and import-torch
            --kind resnet10, vitgan-g and exp-gen (bit-equal). Any K2 or K3
            launch of the phase (but the narrow step's) at a shape the
            kernels phase did not hold, and any K1 launch at a shape not in
            K1_SHAPES, fails it;
24. captured the captured serve path (infer/aot.py) at full width in
            bfloat16, on the serve phases' seeded weights and volumes:
            make_cascade_fn(aot=True), sliding (96³ windows, sw batch 8):
            the first call's seconds (the capture included), then ten
            requests interleaved with ten eager ones (p50, p90 of each),
            every captured output equal to the eager one bit for bit, the
            peak memory of the first call; one eager and one replayed
            request under the profiler (the K1, K2 and K3 kernels the
            profiler sees in each must equal the launches an eager request
            counts); two requests with different inputs, both outputs
            intact; three requests with the K3 routing on (each stage
            captures again; under the profiler the replay runs K3 as often
            as a serve_k3 request); dense (five requests, the same checks
            and profile); ten requests through
            StreamingCascade.run_stream on the one card, each equal to
            make_cascade_fn's (volumes per second); infer --serve-dtype
            bfloat16 from the trainer phase's slots (it must capture stage1
            and stage2, its NIfTI equal to the captured and the eager
            cascade's); doctor --probe --json --strict in a subprocess (exit
            0, the card named, capability 9.0, the probe's K1 launched);
25. train_captured  whole train steps captured as CUDA graphs
            (infer/aot.py::LazyTrainStage) at full width, weights from the
            seeds of phases 12 and 14: train pyfer's step (float32 at TF32
            defaults, adam8bit, net_A frozen) on a fixed float32 batch and
            on a packed one, the bf16 AdamW step of phase 12 with the K3
            routing on and off, the TranSeg step of phase 14 and
            grad_accum=2. Each runs six calls in two eager runs and through
            the stage, in turns, from the same weights on the same batch:
            the replayed calls' p50 beside eager's, the first call's seconds
            (warm-up and capture), its peak memory and what the graphs keep
            reserved, the losses and parameters after each call (bit for bit
            where the two eager runs agree bit for bit, else within their
            spread by phase 13's rule), one eager and one replayed call under
            the profiler (K1, K2 and K3 there equal to an eager call's
            launches; the idle share); no slot is written;

then a ``kernels`` JSON line, the card's name and power limit, and the
last line ``{"ok": true, "device": {...}}``. Weights and volumes are made
from seeds on the card. Any failed phase exits non-zero without a result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from unittest import mock

import torch

# H100 SXM data-sheet peaks (dense): HBM bytes/s; bfloat16 tensor-core and
# float32 (non-tensor) operations/s.
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SEED = 0
DOSE_TOL_OF_SCALE = 1e-3     # f32 cascade: |dose_kernels - dose_plain| ≤ 1e-3 × 70 Gy
LABEL_AGREEMENT_MIN = 0.999

# TranSeg windows, DOSE-PYFER, the dense TranSeg at 128³ (8³ tokens), the
# TranSeg train step (one 96³ crop); the ViT generators' sliding-window
# evaluation (four 128³ windows a batch, exp_gan); DOSE-PYFER's ViT on a
# 'model' axis of 2 (three heads a rank, mesh) and its one-process run of a
# global batch of 2 (mesh); TranSeg's on a 'model' axis of 2 (six heads a
# rank), its sharded validation (four windows a rank) and its one-process
# run of a global batch of 2 (mesh part (c))
K1_SHAPES = [(8, 12, 216, 64), (1, 6, 512, 128), (1, 12, 512, 64), (1, 12, 216, 64),
             (4, 6, 512, 128), (1, 3, 512, 128), (2, 6, 512, 128),
             (1, 6, 216, 64), (4, 12, 216, 64), (2, 12, 216, 64)]
# every shape a bf16 serve request gives K2: the TranSeg windows' (8 per
# call) decoder levels, then DOSE-PYFER's at 128³ (the dense TranSeg's five
# shapes are among these: the dense phase fails on any other); then the
# TranSeg train step's (one 96³ crop) and the C3D cascade's at 128³ (counted
# on the CPU with meta tensors, tests/test_torch_port_train_shapes.py);
# float32 at the first two
K2_SHAPES = [(8, 16, 96, 96, 96), (8, 32, 48, 48, 48), (8, 64, 24, 24, 24),
             (8, 32, 24, 24, 24), (8, 128, 12, 12, 12), (1, 16, 128, 128, 128),
             (1, 32, 64, 64, 64), (1, 64, 32, 32, 32), (1, 32, 32, 32, 32),
             (1, 128, 16, 16, 16), (1, 256, 8, 8, 8),
             (1, 16, 96, 96, 96), (1, 32, 48, 48, 48), (1, 64, 24, 24, 24),
             (1, 32, 24, 24, 24), (1, 128, 12, 12, 12),
             (1, 32, 128, 128, 128), (1, 64, 64, 64, 64), (1, 128, 32, 32, 32),
             (1, 256, 16, 16, 16), (1, 512, 8, 8, 8),
             # HD-UNet's at 128³ that no earlier path gives it (zoo)
             (1, 16, 64, 64, 64), (1, 16, 32, 32, 32), (1, 16, 16, 16, 16),
             (1, 16, 8, 8, 8), (1, 64, 16, 16, 16), (1, 64, 128, 128, 128)]
K2_SERVE_SHAPES = K2_SHAPES[:11]      # each must take the single-read path
# float32: the first two, then those of the zoo phase's float32 runs (the
# UNETR and 'old' TranSeg on one 96³ crop, HD-UNet at 128³, and seg-eval)
K2_F32_SHAPES = [(1, 16, 128, 128, 128), (8, 16, 96, 96, 96),
                 (1, 16, 96, 96, 96), (1, 32, 48, 48, 48), (1, 32, 24, 24, 24),
                 (1, 64, 24, 24, 24), (1, 128, 12, 12, 12),
                 (1, 16, 64, 64, 64), (1, 16, 32, 32, 32), (1, 16, 16, 16, 16),
                 (1, 16, 8, 8, 8), (1, 32, 128, 128, 128), (1, 64, 16, 16, 16),
                 (1, 64, 32, 32, 32), (1, 64, 64, 64, 64), (1, 64, 128, 128, 128),
                 (1, 128, 32, 32, 32), (1, 256, 16, 16, 16),
                 # the zoo CLI's seg-eval (96³ windows, sw batch 4)
                 (4, 16, 96, 96, 96), (4, 32, 48, 48, 48), (4, 32, 24, 24, 24),
                 (4, 64, 24, 24, 24), (4, 128, 12, 12, 12),
                 # DOSE-PYFER's at 128³ that a float32 search trial or fold
                 # gives it (hpo_gan; tests/test_torch_port_train_shapes.py)
                 (1, 32, 64, 64, 64), (1, 32, 32, 32, 32), (1, 128, 16, 16, 16),
                 (1, 256, 8, 8, 8),
                 # exp_gan: ExperimentalCascade's net_B bottom level, then the ViT
                 # generators' sliding-window evaluation (sw batch 4 over one
                 # 128³ window: the batch repeats it)
                 (1, 512, 8, 8, 8), (4, 16, 128, 128, 128), (4, 32, 64, 64, 64),
                 (4, 32, 32, 32, 32), (4, 64, 32, 32, 32), (4, 128, 16, 16, 16)]
# the zoo phase's K2 shapes that no earlier phase holds (the kernels line
# lists each with its launches in the zoo HD-UNet train steps)
K2_ZOO_SHAPES = K2_SHAPES[21:]
# the float32 K2 shapes only exp_gan gives (the kernels line lists each with
# its launches in that phase)
K2_EXP_GAN_SHAPES = K2_F32_SHAPES[-6:]
# float32, the mesh phase's part (c): TranSeg's one-process run of a global
# batch of 2 (96³ crops) and its one-process sweep at sw batch 8 (the
# part's ranks run shapes held above)
K2_MESH_SHAPES = [(2, 16, 96, 96, 96), (2, 32, 48, 48, 48), (2, 64, 24, 24, 24),
                  (2, 32, 24, 24, 24), (2, 128, 12, 12, 12),
                  (8, 32, 48, 48, 48), (8, 64, 24, 24, 24), (8, 32, 24, 24, 24),
                  (8, 128, 12, 12, 12)]
K2_F32_SHAPES = K2_F32_SHAPES + K2_MESH_SHAPES
# every shape a bf16 serve_k3 request gives K3: C3D / DOSE-PYFER levels 1-3
# at 128³, the TranSeg windows' levels at 96³, then the decoders' two
# narrower convs (appended, so that K3_SHAPES[3] stays the kernels line's);
# then the routed TranSeg train step's and C3D cascade's
K3_SHAPES = [(1, 16, 128, 128, 128), (1, 32, 64, 64, 64), (1, 64, 32, 32, 32),
             (8, 16, 96, 96, 96), (8, 32, 48, 48, 48), (8, 64, 24, 24, 24),
             (8, 32, 24, 24, 24), (1, 32, 32, 32, 32),
             (1, 16, 96, 96, 96), (1, 32, 48, 48, 48), (1, 64, 24, 24, 24),
             (1, 32, 24, 24, 24), (1, 32, 128, 128, 128), (1, 64, 64, 64, 64),
             # HD-UNet's upconv_1 (64 channels at 128³; zoo)
             (1, 64, 128, 128, 128)]
K3_ZOO_SHAPES = K3_SHAPES[14:]
TRAIN_LR, TRAIN_WD = 6.130697604327541e-4, 1.6303111017674179e-4   # train/trainers.py:56-57
TRAIN_STEPS = 5
SEG_STEPS, C3D_STEPS, OPTION_STEPS = 5, 3, 3
# train_c3d: CascadeC3DTrainer's split rates on a cosine schedule
# (train/trainers.py:766-792), a horizon short enough to move in the run
C3D_LR_ENCODER, C3D_LR_DECODER, C3D_T_MAX = 3e-4, 1e-3, 6
# the launches in one profiled train step, routing on, before the
# multi-tensor Adam: the "other" group of PERF.md §5 (PR 11)
PR11_TRAIN_OTHER_LAUNCHES = 5579
TRAIN_PARITY_NOISE = 1e-6
# train_parity: conv biases of the Conv31 blocks feed a norm, so their exact
# gradient is 0 and both sides give rounding noise there
ZERO_GRAD_BIAS = r"conv_block\.cov_\.(conv_[37]\.0\.conv\.[03]|conv\.0)\.bias$"
ACTS = ["identity", "relu", "leakyrelu", "mish", "gelu"]
# data and train_feed: the synthetic cohort, the steps per feed, the packed
# feed's first loss against the float32 feed's (tests/test_packed_feed.py:107-132)
DATA_PATIENTS, DATA_SHAPE, SEG_CROP = 4, (128, 128, 128), (96, 96, 96)
FEED_STEPS, FEED_SEG_STEPS = 5, 2
PACKED_LOSS_TOL = 2e-3
# (shift, flip mask, rot90 k) at which the native gathers are held
AUGMENT_DECISIONS = [(0.0, 0, 0), (0.05, 5, 1), (-0.03, 2, 3), (0.07, 7, 2)]
# trainer: eval's device metrics against its host metrics, the bars of
# tests/test_losses_metrics.py:252-254; score's dose score against eval's
EVAL_DOSE_REL, EVAL_DVH_REL, EVAL_IVS_RTOL, EVAL_IVS_ATOL = 1e-4, 1e-3, 1e-4, 1e-5
SCORE_DOSE_REL = 1e-4
SIGTERM_WAIT_S = 420
# zoo: requests and steps per path; HD-UNet's conv biases that feed an
# InstanceNorm (zero gradient in exact arithmetic)
ZOO_SERVE_REQUESTS, ZOO_TRAIN_STEPS = 3, 5
ZOO_ZERO_GRAD_BIAS = r"single_conv\.0\.bias$|upconv_\d\.conv\.0\.bias$"
# the float32 HD-UNet step: each leaf against its own largest departure in
# this many plane-scaled noise runs
ZOO_NOISE_RUNS = 3
# noise runs of the DOSE-PYFER and TranSeg float32 step parity (phases 13, 17)
STEP_NOISE_RUNS = 3
# hpo_gan: DoseGAN at the reference's width (ngf = ndf = 64) and, for the
# card-against-CPU step, at 4 on 32³; the trainer's rate and L1 weight
# (train/trainers.py DoseGANTrainer); conv biases that feed a train-mode
# BatchNorm (zero gradient in exact arithmetic)
GAN_WIDTH, GAN_STEPS = 64, 5
GAN_PARITY_WIDTH, GAN_PARITY_SIZE, GAN_NOISE_RUNS = 4, 32, 3
GAN_LR, GAN_L1_WEIGHT = 2e-4, 10.0
GAN_ZERO_GRAD_BIAS = (r"^(g\.initial_block\.0|d\.model\.[06]|.*\.(downsample|pooling)\.0"
                      r"|.*\.intermediate\.1)\.bias$")
# the searches: trials and epochs (tune's ASHA sees one round an epoch);
# one epoch keeps the run's slot writes under the card machine's disk-write
# limit (each validated DOSE-PYFER epoch writes two 1 GB slots)
TUNE_SAMPLES, TUNE_EPOCHS = 3, 1
# exp_gan: timed full-width steps; ViT-GAN's rates and δ3 and the exp
# step's GenLoss weights (train/gan.py, train/trainers.py defaults); the
# card-against-CPU step at the small width on 32³
EXP_GAN_STEPS = 3
VITGAN_G_LR, VITGAN_D_LR, VITGAN_DELTA3 = 1e-4, 5e-3, 2.0
EXP_DELTA1, EXP_DELTA2 = 10.0, 8.0
VITGAN_PARITY_SIZE, VITGAN_PARITY_WIDTHS, VITGAN_NOISE_RUNS = 32, (4, 8, 16, 32), 3
VITGAN_PARITY_VIT = dict(hidden_size=64, mlp_dim=128, num_layers=2, num_heads=2, feature_size=2)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def tolerance(ref: torch.Tensor) -> float:
    """float32: 1e-4 absolute (summation order only). bfloat16: two bf16
    ulps at the largest output magnitude (both sides round float32 values
    that differ in the last float32 bits, and the plain attention rounds
    its probabilities to bf16 as the JAX reference does)."""
    if ref.dtype == torch.float32:
        return 1e-4
    return 2.0 ** -6 * max(ref.float().abs().max().item(), 1.0)


def time_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls after a warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` captured ``iters`` times in one CUDA graph
    and replayed: the device's time without the host's launch cost."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, 5) / iters


def bound(nbytes: float, ops: float, dtype: torch.dtype):
    """Least time (ms) for the work and which of bytes or operations sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def plain_kernels(k1, k2, k3=None):
    """Swap the plain versions in where the model calls the kernels."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(k1, "fused_attention", k1.plain_attention))
        stack.enter_context(mock.patch.object(k2, "instance_norm_act",
                                              k2.plain_instance_norm_act))
        if k3 is not None:
            stack.enter_context(mock.patch.object(k3, "conv3d_k3", k3.plain_conv3d_k3))
        yield


@contextlib.contextmanager
def k3_routing(on: bool):
    """DPT_PALLAS_CONV=1 (on) or 0 (off) for the models' convolutions."""
    from dose_prediction_tpu_torch.core.config import FLAGS

    with mock.patch.object(FLAGS, "use_k3_conv3d", "1" if on else "0"):
        yield


def kernel_wrappers():
    from dose_prediction_tpu_torch.kernels import attention as k1
    from dose_prediction_tpu_torch.kernels import conv3d as k3
    from dose_prediction_tpu_torch.kernels import instance_norm as k2

    return {"attention": k1.fused_attention, "instance_norm": k2.instance_norm_act,
            "conv3d_k3": k3.conv3d_k3}


def zero_counts() -> None:
    for f in kernel_wrappers().values():
        f.launches = f.recomputes = 0
    kernel_wrappers()["instance_norm"].two_kernel_launches = 0


def read_counts(field: str = "launches") -> dict:
    return {name: getattr(f, field) for name, f in kernel_wrappers().items()}


def check_kernel(name, kernel, plain, library, args, dtype, nbytes, ops, iters, graphs=False):
    out = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    err = (out.float() - ref.float()).abs().max().item()
    tol = tolerance(ref)
    ok = bool(torch.isfinite(out).all()) and err <= tol
    del out, ref
    row = {"max_abs_err": err, "tol": tol,
           "ms": time_ms(lambda: kernel(*args), iters),
           "plain_ms": time_ms(lambda: plain(*args), max(2, iters // 4)),
           "library_ms": time_ms(lambda: library(*args), iters)}
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, dtype)
    log(f"{name} {str(dtype).replace('torch.', '')}: max_abs_err {err:.3g} (tol {tol:.3g}) "
        f"{'ok' if ok else 'FAIL'}; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    if graphs and ok:
        for key, fn in (("graph_ms", kernel), ("graph_plain_ms", plain),
                        ("graph_library_ms", library)):
            row[key] = graph_ms(lambda: fn(*args), iters)
        log(f"{name} {str(dtype).replace('torch.', '')} from a CUDA graph: kernel "
            f"{row['graph_ms']:.4f} ms, plain {row['graph_plain_ms']:.4f} ms, library "
            f"{row['graph_library_ms']:.4f} ms per call")
    if not ok:
        raise AssertionError(f"{name}: max abs err {err} > {tol} or non-finite output")
    return row


def sass_counts(fragment: str, opcode: str = "HMMA") -> dict:
    """``opcode`` instructions (HMMA: tensor-core mma; LDSM: ldmatrix) in the
    SASS of each kernel of the built library whose name holds ``fragment``,
    from ``cuobjdump -sass``."""
    from dose_prediction_tpu_torch.kernels import cuda_lib

    out = subprocess.run([cuda_lib.cuda_tool("cuobjdump"), "-sass", str(cuda_lib.build())],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {out.stderr.strip()}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if fragment in fn:
                counts[fn] = 0
        elif fn in counts and opcode in line:
            counts[fn] += 1
    return counts


def check_k3_tensor_cores() -> dict:
    """Every bfloat16 K3 instantiation loads its fragments with LDSM
    (ldmatrix) and multiplies with HMMA."""
    counts = {op: sass_counts("conv3d_k3_bf16", op) for op in ("HMMA", "LDSM")}
    for fn in counts["HMMA"]:
        log(f"K3 SASS (cuobjdump -sass) {fn}: HMMA {counts['HMMA'][fn]}, "
            f"LDSM {counts['LDSM'][fn]}")
    if not counts["HMMA"] or min(min(c.values()) for c in counts.values()) == 0:
        raise AssertionError(f"K3 bfloat16 instantiations without HMMA or LDSM: {counts}")
    return counts


def check_k1_tensor_cores(k1) -> None:
    """Every bfloat16 K1 instantiation (head dims × block shapes) runs HMMA;
    the float32 ones run none (full-precision FMAs)."""
    counts = sass_counts("attention_fwd")
    bf16 = {f: c for f, c in counts.items() if "attention_fwd_bf16_kernel" in f}
    f32 = {f: c for f, c in counts.items() if f not in bf16}
    log(f"K1 SASS (cuobjdump -sass): HMMA instructions {sum(bf16.values())} in "
        f"{len(bf16)} bfloat16 instantiations (each {min(bf16.values(), default=0)}-"
        f"{max(bf16.values(), default=0)}), {sum(f32.values())} in {len(f32)} float32 ones")
    if len(bf16) != len(k1.HEAD_DIMS) * len(k1.TILINGS) or min(bf16.values()) == 0:
        raise AssertionError(f"K1 bfloat16 instantiations without HMMA: {bf16}")


def k1_block_shapes(k1, q, k, v, iters: int) -> dict:
    """K1 bfloat16 at every block shape, whatever the chooser picks: each
    held against the plain version and timed from a CUDA graph."""
    ref = k1.plain_attention(q, k, v)
    times = {}
    for tiling in k1.TILINGS:
        with mock.patch.object(k1, "bf16_tiling", lambda *args: tiling):
            err = (k1.fused_attention(q, k, v).float() - ref.float()).abs().max().item()
            if err > tolerance(ref):
                raise AssertionError(f"K1 bf16 block shape {tiling}: err {err} > "
                                     f"{tolerance(ref)}")
            times[tiling] = graph_ms(lambda: k1.fused_attention(q, k, v), iters)
    log(f"K1 attention {tuple(q.shape)} bfloat16 from a CUDA graph by block shape (query-row "
        f"x key-split warps): " + ", ".join(f"{t} {ms:.4f} ms" for t, ms in times.items()))
    return times


def check_k2(k2, F, g, dev, shape, dtype):
    """K2 at one shape: against its plain version, timed eagerly and from a
    CUDA graph beside the plain version and F.instance_norm; the path and
    chunk the wrapper takes (a serve shape must take the single-read
    kernel); then each path forced, graph-timed."""
    c = shape[1]
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 1).to(dtype)
    scale = torch.rand(c, generator=g, device=dev) + 0.5
    bias = torch.randn(c, generator=g, device=dev)
    planes, s = shape[0] * c, math.prod(shape[2:])
    chunk, resident = k2.capacity(dev.index or 0, dtype, True)
    path = k2.plan(s, chunk, resident)
    before = k2.instance_norm_act.two_kernel_launches
    row = check_kernel(
        f"K2 instance_norm {shape}", k2.instance_norm_act, k2.plain_instance_norm_act,
        lambda x, s, b: F.instance_norm(x, weight=s, bias=b, eps=1e-5),
        (x, scale, bias), dtype, nbytes=2 * x.numel() * x.element_size(),
        ops=8 * x.numel(), iters=20 if x.numel() < 2 ** 24 else 10, graphs=True)
    two_kernel = path != k2.SINGLE_READ or k2.instance_norm_act.two_kernel_launches > before
    if two_kernel and shape in K2_SERVE_SHAPES:
        raise AssertionError(f"K2 {shape}: a serve shape took the two-kernel path")
    row.update(path=path, chunk=chunk, chunks_per_plane=-(-s // chunk), resident=resident)
    forced = {}
    for option in (k2.SINGLE_READ, k2.TWO_KERNEL):
        with mock.patch.object(k2, "plan", lambda *args: option):
            forced[option] = graph_ms(lambda: k2.instance_norm_act(x, scale, bias), 10)
    row["forced_graph_ms"] = forced
    log(f"K2 {shape} {str(dtype).replace('torch.', '')}: path {path}, chunk {chunk} "
        f"({row['chunks_per_plane']} per plane, {planes * row['chunks_per_plane']} blocks; "
        f"{resident} resident blocks); from a CUDA graph by path: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in forced.items()))
    return row


def phase_kernels(dev):
    import torch.nn.functional as F

    from dose_prediction_tpu_torch.kernels import attention as k1
    from dose_prediction_tpu_torch.kernels import conv3d as k3
    from dose_prediction_tpu_torch.kernels import instance_norm as k2

    g = torch.Generator(dev).manual_seed(SEED)
    rows = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape in K1_SHAPES:
        n, h, l, dh = shape
        wm, wn = k1.bf16_tiling(n * h, l, sms)
        log(f"K1 bf16 block shape at {shape}: {wm} query-row x {wn} key-split warps, "
            f"{16 * wm} rows per block, {n * h * -(-l // (16 * wm))} blocks on {sms} SMs")
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(3))
            rows[("attention", shape, dtype)] = check_kernel(
                f"K1 attention {shape}", k1.fused_attention, k1.plain_attention,
                F.scaled_dot_product_attention, (q, k, v), dtype,
                nbytes=4 * q.numel() * q.element_size(), ops=4 * n * h * l * l * dh, iters=20,
                graphs=True)
            if dtype == torch.bfloat16:
                rows[("attention", shape, dtype)]["block_shapes_graph_ms"] = k1_block_shapes(
                    k1, q, k, v, iters=20)
    check_k1_tensor_cores(k1)
    for dtype, shapes in ((torch.bfloat16, K2_SHAPES), (torch.float32, K2_F32_SHAPES)):
        for shape in shapes:
            rows[("instance_norm", shape, dtype)] = check_k2(k2, F, g, dev, shape, dtype)
    for shape in K3_SHAPES:
        n, c, d, h, w = shape
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            wt = (torch.rand((c, c, 3, 3, 3), generator=g, device=dev) * 2 - 1) / (27 * c) ** 0.5
            b = torch.randn(c, generator=g, device=dev) * 0.1
            rows[("conv3d_k3", shape, dtype)] = check_kernel(
                f"K3 conv3d_k3 {shape}", k3.conv3d_k3, k3.plain_conv3d_k3,
                lambda x, wt, b: F.conv3d(x, wt.to(x.dtype), b.to(x.dtype), padding=1),
                (x, wt, b), dtype, nbytes=2 * x.numel() * x.element_size(),
                ops=2 * n * d * h * w * 27 * c * c, iters=10, graphs=dtype == torch.bfloat16)
            del x
    rows["k3_sass"] = check_k3_tensor_cores()
    for dtype in (torch.float32, torch.bfloat16):        # every activation K2 fuses
        x = (torch.randn((2, 16, 24, 20, 36), generator=g, device=dev) * 2 + 1).to(dtype)
        for act in ACTS:
            out = k2.instance_norm_act(x, act=act)
            ref = k2.plain_instance_norm_act(x, act=act)
            err = (out.float() - ref.float()).abs().max().item()
            if err > tolerance(ref):
                raise AssertionError(f"K2 act={act} {dtype}: err {err} > {tolerance(ref)}")
        log(f"K2 activations {ACTS} {str(dtype).replace('torch.', '')}: within tolerance")
    return rows


def seeded_models(dev):
    """Full-width TranSeg and DOSE-PYFER, weights drawn on the card from seeds,
    norm affines and BatchNorm statistics off 1/0 so those paths count."""
    from dose_prediction_tpu_torch.models import DosePyfer, TranSeg
    from dose_prediction_tpu_torch.nn.init import init_params

    g = torch.Generator(dev).manual_seed(SEED + 1)
    seg = init_params(TranSeg(out_ch=8, device=dev), g)
    dose = init_params(DosePyfer(device=dev), g)
    return perturb_norms([seg, dose], g)


def perturb_norms(models, g):
    """Draw norm affines and BatchNorm statistics off 1/0 so those paths count."""
    with torch.no_grad():
        for m in (m for model in models for m in model.modules()):
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.uniform_(-0.2, 0.2, generator=g)
                m.running_var.uniform_(0.8, 1.3, generator=g)
            if isinstance(m, (torch.nn.InstanceNorm3d, torch.nn.BatchNorm3d,
                              torch.nn.LayerNorm)) and m.weight is not None:
                m.weight.uniform_(0.7, 1.3, generator=g)
                m.bias.uniform_(-0.2, 0.2, generator=g)
    return models


def seeded_volumes(dev, dtype):
    """A 128³ CT, PTV and possible-dose mask, NDHWC, drawn on the card."""
    g = torch.Generator(dev).manual_seed(SEED + 2)
    shape = (1, 128, 128, 128, 1)
    ct = torch.randn(shape, generator=g, device=dev)
    ptv = (torch.rand(shape, generator=g, device=dev) < 0.05).float()
    mask = (torch.rand(shape, generator=g, device=dev) < 0.6).float()
    return ct.to(dtype), ptv.to(dtype), mask.to(dtype)


def cascade_parity(dev, seg, dose, stage1, stage2, kernels, route_k3):
    """The f32 cascade through the kernels and with their plain versions
    swapped in; with ``route_k3`` the K3 routing is on for both."""
    ct, ptv, mask = seeded_volumes(dev, torch.float32)
    seg_vars, dose_vars = seg.state_dict(), dose.state_dict()
    with k3_routing(route_k3):
        zero_counts()
        struct_k = stage1(seg_vars, ct, ptv)
        dose_k = stage2(dose_vars, struct_k, mask)
        torch.cuda.synchronize()
        launches = read_counts()
        with plain_kernels(*kernels):
            struct_p = stage1(seg_vars, ct, ptv)
            dose_p = stage2(dose_vars, struct_k, mask)      # the same structures as dose_k
        torch.cuda.synchronize()
    agree = torch.all(struct_k[..., 1:8] == struct_p[..., 1:8], dim=-1).float().mean().item()
    diff = (dose_k - dose_p).abs().max().item()
    tol = DOSE_TOL_OF_SCALE * 70.0
    oars = struct_k[..., 1:8]
    labels = torch.unique(torch.where(oars.amax(-1) > 0, oars.argmax(-1) + 1, 0))
    route = "K3 routing on" if route_k3 else "K3 routing off"
    log(f"cascade f32 (TF32 off, {route}): dose max abs diff kernels vs plain {diff:.4g} Gy "
        f"(tol {tol:.3g} Gy), dose max {dose_k.max().item():.4g} Gy; seg labels agree "
        f"{agree * 100:.4f}% (min {LABEL_AGREEMENT_MIN * 100:.1f}%), {labels.numel()} labels "
        f"present; launches {launches}")
    routed = launches["conv3d_k3"] > 0 if route_k3 else launches["conv3d_k3"] == 0
    if not (diff <= tol and agree >= LABEL_AGREEMENT_MIN and routed
            and launches["attention"] > 0 and launches["instance_norm"] > 0
            and bool(torch.isfinite(dose_k).all())):
        raise AssertionError(f"f32 cascade parity failed ({route})")
    return {"dose_max_abs_diff_gy": diff, "label_agreement": agree, "launches": launches}


def dense_seg(dev):
    """The full-width TranSeg that runs the 96³-window seg weights over the
    whole volume (trained_grid (6, 6, 6)), as bench.py:211 builds it."""
    from dose_prediction_tpu_torch.models import TranSeg

    return TranSeg(out_ch=8, trained_grid=(6, 6, 6), device=dev)


def seg_parity(name, seg_fn, kernels):
    """float32 OAR labels from ``seg_fn()`` through the kernels and with the
    plain versions swapped in: they must agree at LABEL_AGREEMENT_MIN of the
    voxels, and the run must launch K1 and K2."""
    zero_counts()
    labels_k = seg_fn()
    torch.cuda.synchronize()
    launches = read_counts()
    with plain_kernels(*kernels):
        labels_p = seg_fn()
    torch.cuda.synchronize()
    agree = (labels_k == labels_p).float().mean().item()
    present = torch.unique(labels_k).numel()
    log(f"{name} f32 (TF32 off): seg labels agree kernels vs plain {agree * 100:.4f}% (min "
        f"{LABEL_AGREEMENT_MIN * 100:.1f}%), {present} labels present; launches {launches}")
    if not (agree >= LABEL_AGREEMENT_MIN and launches["attention"] > 0
            and launches["instance_norm"] > 0 and launches["conv3d_k3"] == 0):
        raise AssertionError(f"{name} parity failed")
    return {"label_agreement": agree, "labels_present": present, "launches": launches}


def phase_parity(dev, seg, dose, stage1, stage2, kernels):
    return {"cudnn": cascade_parity(dev, seg, dose, stage1, stage2, kernels, False),
            "k3": cascade_parity(dev, seg, dose, stage1, stage2, kernels, True)}


def phase_parity_dense(dev, seg, dose, kernels):
    """Stage 1 in dense mode and the sliding seg with the gaussian blend, each
    in float32 through the kernels against the plain versions. (A phase of
    its own after the timed ones, so that those see the state the parent
    commit's phases leave.)"""
    from torch.func import functional_call

    from dose_prediction_tpu_torch.infer.cascade import make_cascade_stages
    from dose_prediction_tpu_torch.infer.sliding_window import sliding_window_inference

    rows = {}
    ct, ptv, _ = seeded_volumes(dev, torch.float32)
    seg_vars = seg.state_dict()
    dense_stage1, _ = make_cascade_stages(dense_seg(dev), dose, seg_mode="dense")

    def dense_labels():
        oars = dense_stage1(seg_vars, ct, ptv)[..., 1:8]
        return torch.where(oars.amax(-1) > 0, oars.argmax(-1) + 1, 0)

    @torch.inference_mode()
    def gaussian_labels():
        logits = sliding_window_inference(
            ct.permute(0, 4, 1, 2, 3), lambda w: functional_call(seg, seg_vars, (w,)),
            roi_size=(96, 96, 96), sw_batch_size=8, overlap=0.25, mode="gaussian",
            out_channels=8)
        return logits.argmax(dim=1)

    rows["dense_stage1"] = seg_parity("dense stage 1", dense_labels, kernels)
    rows["gaussian_seg"] = seg_parity("sliding seg, gaussian blend", gaussian_labels, kernels)
    return rows


def phase_serve(dev, seg, dose, stage1, stage2, route_k3=False):
    ct, ptv, mask = seeded_volumes(dev, torch.bfloat16)
    seg_vars, dose_vars = seg.state_dict(), dose.state_dict()

    def request():
        out = stage2(dose_vars, stage1(seg_vars, ct, ptv), mask)
        torch.cuda.synchronize()
        return out

    from dose_prediction_tpu_torch.kernels import conv3d as k3

    k3_shapes, launch = {}, k3._launch

    def record(x, *args):
        key = tuple(x.shape)
        k3_shapes[key] = k3_shapes.get(key, 0) + 1
        return launch(x, *args)

    with k3_routing(route_k3), mock.patch.object(k3, "_launch", record):
        request()                                       # warm-up
        zero_counts()
        k3_shapes.clear()
        times, out = [], None
        for _ in range(3):
            t0 = time.perf_counter()
            out = request()
            times.append(time.perf_counter() - t0)
        launches = read_counts()
        two_kernel = kernel_wrappers()["instance_norm"].two_kernel_launches
    ok = (out.shape == (1, 128, 128, 128, 1) and bool(torch.isfinite(out).all())
          and bool((out[mask < 1] == 0).all()) and bool((out >= 0).all()))
    p50 = sorted(times)[1]
    name = "serve_k3" if route_k3 else "serve"
    log(f"{name} bf16: request seconds {times}, p50 {p50} s; output shape {tuple(out.shape)}, "
        f"finite, 0 outside the mask, >= 0: {ok}; launches over the 3 requests {launches}, "
        f"K2 calls on the two-kernel path {two_kernel}; "
        f"peak memory {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    if route_k3:
        log(f"{name} K3 calls per request by shape: "
            + ", ".join(f"{s} {n // 3}" for s, n in k3_shapes.items())
            + f"; {sum(k3_shapes.values()) // 3} in all")
    routed = launches["conv3d_k3"] > 0 if route_k3 else launches["conv3d_k3"] == 0
    if not (ok and routed and launches["attention"] > 0 and launches["instance_norm"] > 0
            and two_kernel == 0 and sum(k3_shapes.values()) == launches["conv3d_k3"]):
        raise AssertionError(f"{name} check failed (launches {launches}, K3 calls by shape "
                             f"{k3_shapes})")
    return {"p50_s": p50, "times_s": times, "launches": launches,
            "k3_calls_per_request": {str(s): n // 3 for s, n in k3_shapes.items()}}


# kernel-name fragments by group, first match wins (cuDNN's convolutions are
# implicit GEMMs, so they are matched before the matmul fragments; the
# optimizer's multi_tensor_apply_kernel before K2's apply_kernel)
KERNEL_GROUPS = (("K3 conv3d_k3", ("conv3d_k3",)),
                 ("K1 attention", ("attention_fwd",)),
                 ("multi-tensor optimizer", ("multi_tensor_apply",)),
                 ("K2 instance norm", ("instance_norm_kernel", "stats_kernel",
                                       "apply_kernel")),
                 ("memset (K2's counters among them)", ("memset",)),
                 ("cuDNN layout transform", ("nchwtonhwc", "nhwctonchw")),
                 ("convolution", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "implicit")),
                 ("matmul", ("gemm", "nvjet", "cublas", "cutlass")))


def profiled(fn, label: str, settle: bool = False):
    """Run ``fn`` once under torch.profiler: device time by kernel group and
    the device's idle share of its wall time. ``settle`` runs ``fn`` once
    more first, inside the window, then a marker kernel, and reads only the
    kernels that start after the marker: late in a long process the
    profiler has dropped a few dozen kernels at the start of a window, the
    same ones in an eager and a replayed request (PERF.md §6), and a
    count that is held exactly needs every one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_kernel(evt):
        # user annotations (Optimizer.step#...) span kernels already counted
        return (getattr(evt, "device_type", None) == DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if settle:
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(100_000)       # the marker: ATen's spin_kernel
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        if settle:
            time.sleep(0.05)
    kernels = []
    if settle:
        events = [e for e in prof.events() if device_kernel(e)]
        marks = [e.time_range.start for e in events if "spin_kernel" in e.name]
        if not marks:
            log(f"profile {label}: the marker kernel is not in the profile; not measured")
            return None
        before = sum(e.time_range.start < marks[-1] for e in events)
        log(f"profile {label}: {before} kernels before the marker (the first run of the "
            f"window), counted from the marker on")
        counts = {}
        for e in events:
            if e.time_range.start > marks[-1]:
                tot = counts.setdefault(e.name, [0.0, 0])
                tot[0] += e.time_range.elapsed_us()
                tot[1] += 1
        kernels = [(us, count, name) for name, (us, count) in counts.items() if us > 0]
    else:
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0.0)
            if device_kernel(evt) and us > 0:
                kernels.append((us, evt.count, evt.key))
    busy_us = sum(us for us, _, _ in kernels)
    if busy_us <= 0:
        log(f"profile {label}: the profiler reported no device time; not measured")
        return None
    groups = {}
    for us, count, name in kernels:
        low = name.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")
        tot = groups.setdefault(group, [0.0, 0])
        tot[0] += us
        tot[1] += count
    log(f"profile {label}: wall {wall_us / 1e3:.2f} ms under the profiler, device busy "
        f"{busy_us / 1e3:.2f} ms, idle share {1 - busy_us / wall_us:.3f}")
    for group, (us, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"profile {label} group {group}: {us / 1e3:.3f} ms in {count} launches "
            f"({us / busy_us * 100:.1f}% of device time)")
    for us, count, name in sorted(kernels, reverse=True)[:12]:
        log(f"profile {label} kernel {us / 1e3:.3f} ms x{count}: {name[:110]}")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / wall_us,
            "groups_ms": {g: v[0] / 1e3 for g, v in groups.items()},
            "groups_launches": {g: v[1] for g, v in groups.items()},
            "launches": sum(v[1] for v in groups.values())}


def phase_profile(dev, seg, dose, stage1, stage2, route_k3=False):
    """One more bf16 request under torch.profiler."""
    ct, ptv, mask = seeded_volumes(dev, torch.bfloat16)
    seg_vars, dose_vars = seg.state_dict(), dose.state_dict()
    with k3_routing(route_k3):
        return profiled(lambda: stage2(dose_vars, stage1(seg_vars, ct, ptv), mask),
                        "bf16 request" + (" (K3 routing on)" if route_k3 else ""))


def bf16_requests(run, ct, ptv, mask, n):
    """One warm-up, then ``n`` timed requests ``run(ct, ptv, mask)``, each
    ended by a synchronisation, the counts read around them; checks the last
    output (shape, finite, 0 outside the mask, >= 0)."""
    run(ct, ptv, mask)
    torch.cuda.synchronize()
    zero_counts()
    times, out = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        out = run(ct, ptv, mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_counts()
    ok = (out.shape == ct.shape and bool(torch.isfinite(out).all())
          and bool((out[mask < 1] == 0).all()) and bool((out >= 0).all()))
    return times, launches, ok


def phase_dense(dev, seg, dose):
    """bench.py's dense fast path: five bf16 requests through
    make_cascade_fn(seg_mode='dense'), with K2's calls by shape."""
    from dose_prediction_tpu_torch.infer.cascade import make_cascade_fn
    from dose_prediction_tpu_torch.kernels import instance_norm as k2

    run = make_cascade_fn(dense_seg(dev), seg.state_dict(), dose, dose.state_dict(),
                          seg_mode="dense", dose_scale=70.0)
    ct, ptv, mask = seeded_volumes(dev, torch.bfloat16)
    k2_shapes, direct = {}, k2._direct

    def record(x, *args, **kwargs):
        k2_shapes[tuple(x.shape)] = k2_shapes.get(tuple(x.shape), 0) + 1
        return direct(x, *args, **kwargs)

    n = 5
    with mock.patch.object(k2, "_direct", record):
        times, launches, ok = bf16_requests(run, ct, ptv, mask, n)
    prof = profiled(lambda: run(ct, ptv, mask), "bf16 dense request")
    per_request = {k: v / n for k, v in launches.items()}
    p50 = sorted(times)[n // 2]
    log(f"dense bf16: request seconds {times}, dense_fastpath_p50_s {p50}; output checks {ok}; "
        f"launches per request {per_request}; K2 calls per request by shape (warm-up "
        f"included, / {n + 1}): " + ", ".join(f"{s} {c / (n + 1):g}" for s, c in k2_shapes.items()))
    unheld = [s for s in k2_shapes if s not in K2_SHAPES]
    if not (ok and per_request["attention"] > 0 and per_request["instance_norm"] > 0
            and per_request["conv3d_k3"] == 0 and not unheld):
        raise AssertionError(f"dense check failed (K2 shapes the kernels phase did not hold: "
                             f"{unheld})")
    return {"dense_fastpath_p50_s": p50, "times_s": times, "launches_per_request": per_request,
            "k2_calls_by_shape": {str(s): c / (n + 1) for s, c in k2_shapes.items()},
            "profile": prof}


def phase_sweep(dev, seg, dose):
    """bench.py's serve sweep: ten bf16 requests through pipeline_map over
    make_cascade_fn, request i+1 queued before request i is synchronised.
    Each request records an event after its launches and consume waits on
    that event: torch.cuda.synchronize() would wait for request i+1 too."""
    from dose_prediction_tpu_torch.infer.cascade import make_cascade_fn
    from dose_prediction_tpu_torch.infer.pipeline import pipeline_map

    run = make_cascade_fn(seg, seg.state_dict(), dose, dose.state_dict(), roi_size=(96, 96, 96),
                          sw_batch_size=8, overlap=0.25, dose_scale=70.0)
    ct, ptv, mask = seeded_volumes(dev, torch.bfloat16)
    run(ct, ptv, mask)
    torch.cuda.synchronize()

    def produce(_):
        out = run(ct, ptv, mask)
        done = torch.cuda.Event()
        done.record()
        return out, done

    def consume(produced):
        out, done = produced
        done.synchronize()
        return out

    def sweep():
        return list(pipeline_map(produce, consume, range(n)))

    n = 10
    zero_counts()
    t0 = time.perf_counter()
    outs = sweep()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    prof = profiled(sweep, f"bf16 sweep of {n} requests")
    vps = n / seconds
    ok = len(outs) == n and all(bool(torch.isfinite(o).all()) for o in outs)
    log(f"sweep bf16: {n} requests in {seconds} s, sweep_volumes_per_sec {vps}; outputs finite "
        f"{ok}; launches {launches}")
    if not (ok and launches["attention"] > 0 and launches["instance_norm"] > 0):
        raise AssertionError("sweep check failed")
    return {"sweep_volumes_per_sec": vps, "seconds": seconds, "requests": n, "profile": prof}


def phase_routes(dev, seg, dose, stage1, stage2, serve):
    """Three bf16 sliding requests with each kernel switched off by its flag:
    its launches must fall to 0 and the other kernel's stay as in serve."""
    from dose_prediction_tpu_torch.core.config import FLAGS

    ct, ptv, mask = seeded_volumes(dev, torch.bfloat16)
    seg_vars, dose_vars = seg.state_dict(), dose.state_dict()
    rows = {}
    for switch, attr, value, kernel in (
            ("DPT_PALLAS_ATTENTION=0", "use_k1_attention", False, "attention"),
            ("DPT_PALLAS_IN=0", "use_k2_instance_norm", "0", "instance_norm")):
        with mock.patch.object(FLAGS, attr, value):
            times, launches, ok = bf16_requests(
                lambda c, p, m: stage2(dose_vars, stage1(seg_vars, c, p), m), ct, ptv, mask, 3)
        p50 = sorted(times)[1]
        want = {**serve["launches"], kernel: 0}
        log(f"routes {switch}: request seconds {times}, p50 {p50} s (serve p50 "
            f"{serve['p50_s']} s); output checks {ok}; launches over the 3 requests {launches} "
            f"(serve {serve['launches']})")
        if not (ok and launches == want):
            raise AssertionError(f"routes {switch}: launches {launches}, want {want}")
        rows[switch] = {"p50_s": p50, "times_s": times, "launches": launches}
    return rows


def seeded_pyfer(dev, **kwargs):
    """A full-width DOSE-PYFER drawn from one seed: two calls give identical
    weights (``remat_blocks`` changes no parameter)."""
    from dose_prediction_tpu_torch.models import DosePyfer
    from dose_prediction_tpu_torch.nn.init import init_params

    g = torch.Generator(dev).manual_seed(SEED + 3)
    return perturb_norms([init_params(DosePyfer(device=dev, **kwargs), g)], g)[0]


def seeded_batch(dev, dtype):
    """A fixed 128³ training batch, NDHWC: input (PTV, 7 one-hot OARs, CT) in
    ``dtype``, gt (dose ÷ 70, possible-dose mask) in float32."""
    g = torch.Generator(dev).manual_seed(SEED + 4)
    shape = (1, 128, 128, 128)
    ptv = (torch.rand(shape, generator=g, device=dev) < 0.05).float()
    labels = torch.randint(0, 8, shape, generator=g, device=dev)
    oars = torch.nn.functional.one_hot(labels, 8)[..., 1:].float()
    ct = torch.randn(shape, generator=g, device=dev)
    mask = (torch.rand(shape, generator=g, device=dev) < 0.6).float()
    dose = torch.rand(shape, generator=g, device=dev) * mask
    return {"input": torch.cat([ptv[..., None], oars, ct[..., None]], dim=-1).to(dtype),
            "gt": torch.stack([dose, mask], dim=-1)}


def make_trainer(dev, *, remat=False, remat_blocks=False, kind="adamw", grad_accum=1,
                 packed=False, dtype=None):
    from dose_prediction_tpu_torch.train import state as S
    from dose_prediction_tpu_torch.train import steps

    model = seeded_pyfer(dev, remat_blocks=remat_blocks)
    opt = S.make_optimizer(model, learning_rate=TRAIN_LR, weight_decay=TRAIN_WD,
                           freeze_labels=S.cascade_freeze_labels(model), kind=kind,
                           grad_accum=grad_accum)
    step = steps.make_pyfer_train_step(model, opt, delta1=10.0, delta2=8.0, freeze=True,
                                       remat=remat, packed=packed, dtype=dtype)
    return model, step, S.TrainState(model, opt)


def timed_steps(dev, step, state, batch, n):
    """One warm-up step, then ``n`` timed steps with the counts read around
    each; returns the state, the warm-up loss and one row per step."""
    state, loss0 = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rows = []
    for _ in range(n):
        zero_counts()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        rows.append({"s": time.perf_counter() - t0, "loss": float(loss),
                     "launches": read_counts(), "recomputes": read_counts("recomputes")})
    return state, float(loss0), rows


@contextlib.contextmanager
def torch_default_tf32():
    """PyTorch's defaults, which a training user runs with: TF32 for cuDNN's
    float32 convolutions (here the backward recomputes of K3's plain
    version), not for float32 matmuls."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def phase_train(dev):
    """Full-width DOSE-PYFER steps at 128³, bf16 compute, routing on, then
    the same with the routing off, at PyTorch's TF32 defaults."""
    with torch_default_tf32():
        return train_steps_both_routes(dev)


def train_steps_both_routes(dev):
    batch = seeded_batch(dev, torch.bfloat16)
    model, step, state = make_trainer(dev)
    with k3_routing(True):
        state, loss0, rows = timed_steps(dev, step, state, batch, TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated(dev)
        prof = profiled(lambda: step(state, batch), "bf16 train step (K3 routing on)")
    times = [r["s"] for r in rows]
    losses = [loss0] + [r["loss"] for r in rows]
    p50 = sorted(times)[len(times) // 2]
    for i, r in enumerate(rows):
        log(f"train bf16 step {i + 1}: {r['s']} s, loss {r['loss']}, forward launches "
            f"{r['launches']}, backward recomputes {r['recomputes']}")
    falls = losses[-1] < losses[0]
    log(f"train bf16 (K3 routing on): step seconds {times}, p50 {p50} s; losses (warm-up "
        f"first) {losses}, {'falling' if falls else 'NOT falling'}; peak memory "
        f"{peak / 2 ** 30:.2f} GiB")
    ok = all(math.isfinite(x) for x in losses) and all(
        min(r["launches"].values()) > 0 and min(r["recomputes"].values()) > 0 for r in rows)
    with k3_routing(False):
        state, _, rows_off = timed_steps(dev, step, state, batch, TRAIN_STEPS)
        prof_off = profiled(lambda: step(state, batch), "bf16 train step (K3 routing off)")
    times_off = [r["s"] for r in rows_off]
    p50_off = sorted(times_off)[len(times_off) // 2]
    log(f"train bf16 (K3 routing off, cuDNN): step seconds {times_off}, p50 {p50_off} s; "
        f"K3 launches {[r['launches']['conv3d_k3'] for r in rows_off]}")
    for label, pr in (("routing on", prof), ("routing off", prof_off)):
        if pr is not None:
            log(f"train bf16 ({label}) under the profiler, multi-tensor Adam: "
                f"{pr['launches']} kernel launches in the step, "
                f"{pr['groups_launches'].get('other', 0)} in the 'other' group and "
                f"{pr['groups_launches'].get('multi-tensor optimizer', 0)} multi-tensor "
                f"(PR 11, per-leaf Adam, routing on: {PR11_TRAIN_OTHER_LAUNCHES} in 'other', "
                f"the optimizer's among them); idle share {pr['idle_share']:.3f}")
    ok = ok and all(r["launches"]["conv3d_k3"] == 0 and math.isfinite(r["loss"])
                    for r in rows_off)
    if not ok:
        raise AssertionError("train check failed: a loss is not finite or a kernel of the "
                             "path was not launched / recomputed in a step")
    del model, step, state
    return {"p50_s": p50, "times_s": times, "losses": losses, "peak_gib": peak / 2 ** 30,
            "launches_per_step": rows[-1]["launches"],
            "recomputes_per_step": rows[-1]["recomputes"], "profile": prof,
            "p50_s_routing_off": p50_off, "times_s_routing_off": times_off,
            "profile_routing_off": prof_off}


@contextlib.contextmanager
def noisy_plain_kernels(k1, k2, k3, rel: float, seed: int, dev, plane_scaled: bool = False):
    """The plain versions with each output multiplied by 1 + rel·u, u uniform
    in [-1, 1] (the noise is kept out of the gradient): a float32 run that
    differs from the plain one by rounding-sized noise only. With
    ``plane_scaled`` K2's output instead gets rel · u times its plane's
    largest |value|: the size of the rounding in the norm's subtraction,
    which moves values near 0 across it ahead of a ReLU (HD-UNet; the
    docstring of tests/test_torch_port_zoo_train.py)."""
    g = torch.Generator(dev).manual_seed(seed)

    def noisy(plain, scaled=False):
        def fn(*args, **kwargs):
            out = plain(*args, **kwargs)
            u = torch.rand(out.shape, generator=g, device=out.device) * 2 - 1
            size = out.detach().abs().amax(dim=(2, 3, 4), keepdim=True) if scaled else out
            return out + (size * (rel * u)).detach()
        return fn

    with mock.patch.object(k1, "fused_attention", noisy(k1.plain_attention)), \
            mock.patch.object(k2, "instance_norm_act", noisy(k2.plain_instance_norm_act,
                                                             plane_scaled)), \
            mock.patch.object(k3, "conv3d_k3", noisy(k3.plain_conv3d_k3)):
        yield


def parity_runs(make, batch, kernels, route_k3, dev, plane_scaled=False, noise_runs=1):
    """One float32 step of ``make()`` (a fresh model, step and state, the same
    weights each call) on ``batch``: through the kernels, through their
    plain versions, and through the plain versions with TRAIN_PARITY_NOISE
    relative noise on their outputs (``plane_scaled``: noisy_plain_kernels),
    ``noise_runs`` times with seeds SEED, SEED + 1, ... Each run's loss,
    gradients and kernel launches."""
    k1, k2, k3 = kernels
    runs = {}
    noisy = [(f"noise{i}", noisy_plain_kernels(k1, k2, k3, TRAIN_PARITY_NOISE, SEED + i, dev,
                                               plane_scaled)) for i in range(noise_runs)]
    for name, ctx in [("kernels", contextlib.nullcontext()),
                      ("plain", plain_kernels(*kernels))] + noisy:
        model, step, state = make()
        with k3_routing(route_k3), ctx:
            zero_counts()
            _, loss = step(state, batch)
            torch.cuda.synchronize()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        runs[name] = (float(loss), grads, read_counts())
        del model, step, state
        free_memory()
    return runs


def check_step_parity(label, runs, route_k3, zero_grad=ZERO_GRAD_BIAS, per_leaf=False):
    """The kernels run against the plain run (parity_runs). The loss must
    agree to a relative 1e-5. A gradient leaf must agree to a max abs of
    1e-3 × its max |g|, or, where the step itself amplifies rounding noise
    past that, to 2 × the noise runs' departure from the plain run (the
    model's normalisations turn 1e-6 forward differences into percent-level
    differences of some leaves, kernels or not), with a floor of 2e-6 × the
    model's largest |g|. That departure is the worst leaf's (a limit shared
    by every leaf), or with ``per_leaf`` each leaf's own largest over the
    noise runs, as tests/test_torch_port_zoo_train.py holds HD-UNet's step
    on the CPU; the worst ratio of a leaf's error to its per-leaf limit is
    printed either way. Conv biases that feed a norm have a zero gradient in
    exact arithmetic and must be below 1e-5 × the largest on both sides
    (tests/test_torch_port_train.py states the first and last limits on the
    CPU). The kernel run must launch K1 (where the model has attention),
    K2, and K3 exactly where ``route_k3``."""
    import re

    (loss_k, grads_k, launches_k), (loss_p, grads_p, _) = runs["kernels"], runs["plain"]
    noisy = [grads for name, (_, grads, _) in runs.items() if name.startswith("noise")]
    g_max = max(g.abs().max().item() for g in grads_p.values())
    zero = re.compile(zero_grad)
    leaves = [n for n in grads_p if not zero.search(n)]
    zeros = [n for n in grads_p if zero.search(n)]
    scale = {n: grads_p[n].abs().max().item() for n in leaves}

    def rel_err(grads, n):
        return (grads[n] - grads_p[n]).abs().max().item() / max(scale[n], 1e-30)

    noise = {n: max(rel_err(grads, n) for grads in noisy) for n in leaves}
    worst_k = max(leaves, key=lambda n: rel_err(grads_k, n))
    worst_n = max(leaves, key=noise.get)
    noise_level = noise[worst_n]

    def limit(n, departure):
        return max(max(1e-3, 2 * departure) * scale[n], 2e-6 * g_max)

    own = {n: rel_err(grads_k, n) * scale[n] / limit(n, noise[n]) for n in leaves}
    held = own if per_leaf else {n: rel_err(grads_k, n) * scale[n] / limit(n, noise_level)
                                 for n in leaves}
    worst_own = max(leaves, key=own.get)
    failed = [n for n in leaves if held[n] > 1.0]
    over_1e3 = sum(rel_err(grads_k, n) > 1e-3 for n in leaves)
    failed += [n for n in zeros if max(grads_k[n].abs().max().item(),
                                       grads_p[n].abs().max().item()) > 1e-5 * g_max]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    route = "K3 routing on" if route_k3 else "K3 routing off"
    rule = ("each leaf max(1e-3, 2 x its own noise departure)" if per_leaf
            else f"max(1e-3, {2 * noise_level:.3g}) for every leaf")
    log(f"{label} f32 (TF32 off, {route}): loss kernels {loss_k} plain {loss_p}, "
        f"relative diff {rel:.3g} (limit 1e-5); {len(grads_p)} gradient leaves, largest |g| "
        f"{g_max:.4g}; worst leaf err / its max|g|: kernels vs plain "
        f"{rel_err(grads_k, worst_k):.3g} ({worst_k}), {len(noisy)} noise run(s) vs plain "
        f"{noise_level:.3g} ({worst_n}); {over_1e3} of {len(leaves)} leaves over 1e-3, limit "
        f"{rule}; worst leaf err / its per-leaf limit {own[worst_own]:.3g} ({worst_own}); "
        f"{len(zeros)} zero-gradient biases; leaves over their limit: {failed[:5]}; "
        f"kernel-run launches {launches_k}")
    routed = launches_k["conv3d_k3"] > 0 if route_k3 else launches_k["conv3d_k3"] == 0
    if (set(grads_k) != set(grads_p) or rel > 1e-5 or failed or not routed
            or launches_k["instance_norm"] == 0):
        raise AssertionError(f"{label} parity failed ({route})")
    return {"loss_rel_diff": rel, "worst_leaf_rel_err": rel_err(grads_k, worst_k),
            "noise_worst_leaf_rel_err": noise_level, "leaves_over_1e-3": over_1e3,
            "worst_per_leaf_ratio": own[worst_own], "worst_per_leaf_leaf": worst_own,
            "per_leaf": per_leaf, "leaves": len(grads_p), "launches": launches_k}


def phase_train_parity(dev, kernels):
    """One float32 DOSE-PYFER step (TF32 off, routing on) from identical
    weights and batch, by check_step_parity's rule."""
    runs = parity_runs(lambda: make_trainer(dev), seeded_batch(dev, torch.float32), kernels,
                       True, dev, noise_runs=STEP_NOISE_RUNS)
    row = check_step_parity("train_parity", runs, True, per_leaf=True)
    if row["launches"]["attention"] == 0:
        raise AssertionError("train_parity: K1 was not launched")
    return row


def seeded_seg_batch(dev, dtype):
    """One 96³ crop: a CT in ``dtype`` and uint8 labels of the 8 classes,
    NDHWC as the TranSeg step takes them."""
    g = torch.Generator(dev).manual_seed(SEED + 5)
    ct = torch.randn((1, 96, 96, 96, 1), generator=g, device=dev)
    labels = torch.randint(0, 8, (1, 96, 96, 96), generator=g, device=dev).to(torch.uint8)
    return {"ct": ct.to(dtype), "labels": labels}


def seeded_seg_model(dev):
    """The full-width TranSeg as the serve path builds it (12-layer ViT-768,
    12 heads, feature size 16, 8 classes, seg family), weights from one
    seed, norm affines and BatchNorm statistics off 1/0."""
    from dose_prediction_tpu_torch.models import TranSeg
    from dose_prediction_tpu_torch.nn.init import init_params

    g = torch.Generator(dev).manual_seed(SEED + 6)
    return perturb_norms([init_params(TranSeg(out_ch=8, device=dev), g)], g)[0]


def make_seg_trainer(dev):
    """seeded_seg_model with AdamW at TRAIN_LR / TRAIN_WD (TranSegTrainer,
    train/trainers.py:1025-1026)."""
    from dose_prediction_tpu_torch.train import state as S
    from dose_prediction_tpu_torch.train import steps

    model = seeded_seg_model(dev)
    opt = S.make_optimizer(model, learning_rate=TRAIN_LR, weight_decay=TRAIN_WD)
    return model, steps.make_transeg_train_step(model, opt), S.TrainState(model, opt)


def make_c3d_trainer(dev):
    """The full-width C3D cascade (list_ch (-1, 32, 64, 128, 256, 512) for
    both U-Nets, 9 input channels) with the split encoder/decoder rates on
    a cosine schedule, as CascadeC3DTrainer builds them."""
    from dose_prediction_tpu_torch.models import CascadeC3D
    from dose_prediction_tpu_torch.nn.init import init_params
    from dose_prediction_tpu_torch.train import state as S
    from dose_prediction_tpu_torch.train import steps

    g = torch.Generator(dev).manual_seed(SEED + 7)
    model = perturb_norms([init_params(CascadeC3D(device=dev), g)], g)[0]
    opt = S.make_split_lr_optimizer(
        model, lr_encoder=S.cosine_schedule(C3D_LR_ENCODER, C3D_T_MAX),
        lr_decoder=S.cosine_schedule(C3D_LR_DECODER, C3D_T_MAX), weight_decay=TRAIN_WD)
    return model, steps.make_cascade_c3d_train_step(model, opt), S.TrainState(model, opt)


def train_readings(name, dev, step, state, batch, n, label):
    """One warm-up and ``n`` timed steps (timed_steps), the peak memory, one
    more step under the profiler; logs the steps and returns the readings."""
    state, loss0, rows = timed_steps(dev, step, state, batch, n)
    peak = torch.cuda.max_memory_allocated(dev)
    prof = profiled(lambda: step(state, batch), label)
    times = [r["s"] for r in rows]
    losses = [loss0] + [r["loss"] for r in rows]
    p50 = sorted(times)[len(times) // 2]
    log(f"{name}: step seconds {times}, p50 {p50} s; losses (warm-up first) {losses}; "
        f"launches per step {rows[-1]['launches']}, backward recomputes per step "
        f"{rows[-1]['recomputes']}; peak memory {peak / 2 ** 30:.2f} GiB")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: a loss is not finite")
    return {"p50_s": p50, "times_s": times, "losses": losses, "peak_gib": peak / 2 ** 30,
            "launches_per_step": rows[-1]["launches"],
            "recomputes_per_step": rows[-1]["recomputes"], "profile": prof}


def phase_train_seg(dev):
    """The full-width TranSeg step on one 96³ crop, bf16 compute, float32
    parameters, K3 routing on, PyTorch's TF32 defaults: every kernel of the
    path must launch and be recomputed in every step."""
    _, step, state = make_seg_trainer(dev)
    batch = seeded_seg_batch(dev, torch.bfloat16)
    with torch_default_tf32(), k3_routing(True):
        row = train_readings("train_seg bf16 (K3 routing on)", dev, step, state, batch,
                             SEG_STEPS, "bf16 TranSeg train step (K3 routing on)")
    if min(row["launches_per_step"].values()) == 0 or min(row["recomputes_per_step"].values()) == 0:
        raise AssertionError(f"train_seg: a kernel of the path was not launched / recomputed "
                             f"({row['launches_per_step']}, {row['recomputes_per_step']})")
    return row


def phase_train_c3d(dev):
    """The full-width C3D cascade step at 128³, batch 1, bf16, K3 routing on,
    split rates on a cosine schedule: each update's rate beside the
    schedule's closed form (torch CosineAnnealingLR)."""
    _, step, state = make_c3d_trainer(dev)
    batch = seeded_batch(dev, torch.bfloat16)
    opt = state.optimizer
    applied = []

    def step_and_rate(state, batch):
        state, loss = step(state, batch)
        applied.append((opt.count, [g["last_lr"] for g in opt.param_groups]))
        return state, loss

    with torch_default_tf32(), k3_routing(True):
        row = train_readings("train_c3d bf16 (K3 routing on)", dev, step_and_rate, state,
                             batch, C3D_STEPS, "bf16 C3D train step (K3 routing on)")
    worst = 0.0
    for count, rates in applied:
        t = min(count - 1, C3D_T_MAX)
        want = [0.5 * base * (1 + math.cos(math.pi * t / C3D_T_MAX))
                for base in (C3D_LR_ENCODER, C3D_LR_DECODER)]
        worst = max(worst, *(abs(r - w) / w for r, w in zip(rates, want)))
        log(f"train_c3d update {count}: rates applied (encoder, decoder) {rates}, "
            f"cosine schedule at count {count - 1} {want}")
    launches = row["launches_per_step"]
    if (launches["attention"] != 0 or launches["instance_norm"] == 0
            or launches["conv3d_k3"] == 0 or worst > 1e-6):
        raise AssertionError(f"train_c3d check failed (launches {launches}, worst rate "
                             f"relative error {worst})")
    row["rates"] = applied
    return row


def free_memory() -> None:
    """Collect the reference cycles a dropped trainer leaves (its step
    closes over the model and the optimizer), then return the cached
    blocks: the next run's peak memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def optimizer_state_bytes(opt) -> int:
    """Bytes of the optimizer's state: Adam's moments (and grad_accum's
    buffers) per leaf, or adam8bit's block state."""
    from dose_prediction_tpu_torch.train.adam8bit import Adam8bit, state_nbytes

    extra = sum(t.numel() * t.element_size() for st in opt.state.values()
                for t in st.values() if torch.is_tensor(t))
    return extra + (state_nbytes(opt) if isinstance(opt, Adam8bit) else 0)


def phase_train_options(dev):
    """Full-width DOSE-PYFER steps at 128³ as the train phase builds them,
    the plain step first, then one option at a time: remat, remat_blocks,
    grad_accum=2, adam8bit. The remat runs' first loss must equal the plain
    step's on the same weights and batch (train_parity's relative 1e-5);
    grad_accum=2 must leave every parameter unchanged after its first
    call."""
    batch = seeded_batch(dev, torch.bfloat16)
    rows = {}
    plain_loss = plain_bytes = None
    with torch_default_tf32(), k3_routing(True):
        for name, kwargs in (("plain", {}), ("remat", dict(remat=True)),
                             ("remat_blocks", dict(remat_blocks=True)),
                             ("grad_accum=2", dict(grad_accum=2)),
                             ("adam8bit", dict(kind="adam8bit"))):
            model, step, state = make_trainer(dev, **kwargs)
            unchanged = None
            if name == "grad_accum=2":        # the first call accumulates only
                before = [p.detach().clone() for p in model.parameters() if p.requires_grad]
                state, _ = step(state, batch)
                unchanged = state.optimizer.count == 0 and all(
                    torch.equal(p, b) for p, b in
                    zip((p for p in model.parameters() if p.requires_grad), before))
                del before
            state, loss0, timed = timed_steps(dev, step, state, batch, OPTION_STEPS)
            peak = torch.cuda.max_memory_allocated(dev)
            times = [r["s"] for r in timed]
            row = {"p50_s": sorted(times)[len(times) // 2], "times_s": times,
                   "losses": [loss0] + [r["loss"] for r in timed], "peak_gib": peak / 2 ** 30,
                   "optimizer_state_bytes": optimizer_state_bytes(state.optimizer),
                   "launches_per_step": timed[-1]["launches"]}
            ok = all(math.isfinite(x) for x in row["losses"])
            if name == "plain":
                plain_loss, plain_bytes = loss0, row["optimizer_state_bytes"]
            if name.startswith("remat"):
                row["first_loss_rel_diff"] = abs(loss0 - plain_loss) / abs(plain_loss)
                ok = ok and row["first_loss_rel_diff"] <= 1e-5
            if unchanged is not None:
                row["unchanged_after_first_call"] = unchanged
                ok = ok and unchanged
            log(f"train_options {name}: step seconds {times}, p50 {row['p50_s']} s; losses "
                f"(warm-up first) {row['losses']}; peak memory {row['peak_gib']:.2f} GiB; "
                f"optimizer state {row['optimizer_state_bytes'] / 2 ** 30:.3f} GiB (AdamW "
                f"{plain_bytes / 2 ** 30:.3f} GiB); launches per step {row['launches_per_step']}"
                + (f"; first loss vs the plain step's {plain_loss}: relative diff "
                   f"{row['first_loss_rel_diff']:.3g} (limit 1e-5)"
                   if "first_loss_rel_diff" in row else "")
                + (f"; parameters unchanged after the first call: {unchanged}"
                   if unchanged is not None else ""))
            rows[name] = row
            del model, step, state
            free_memory()
            if not ok:
                raise AssertionError(f"train_options {name} check failed")
    return rows


def phase_train_seg_parity(dev, kernels):
    """One float32 full-width TranSeg step (TF32 off) through the kernels
    against the plain versions, by check_step_parity's rule, with the K3
    routing off and then on."""
    batch = seeded_seg_batch(dev, torch.float32)
    rows = {}
    for route_k3 in (False, True):
        runs = parity_runs(lambda: make_seg_trainer(dev), batch, kernels, route_k3, dev,
                           noise_runs=STEP_NOISE_RUNS)
        rows["k3" if route_k3 else "cudnn"] = check_step_parity("train_seg_parity", runs,
                                                                route_k3, per_leaf=True)
        if runs["kernels"][2]["attention"] == 0:
            raise AssertionError("train_seg_parity: K1 was not launched")
        del runs
        free_memory()
    return rows


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Two tensors of one dtype and shape, equal bit for bit (on the host)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(a.dtype)
    if view is not None:
        a, b = a.view(view), b.view(view)
    return torch.equal(a.cpu(), b.cpu())


def patients_equal(a, b) -> bool:
    """Two loaded patients with the same arrays, bit for bit."""
    def same(x, y):
        return x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()

    return (a.patient_id == b.patient_id and tuple(a.spacing) == tuple(b.spacing)
            and all(same(getattr(a, f), getattr(b, f))
                    for f in ("ct", "ptv", "oars", "dose", "real_dose", "dose_mask"))
            and sorted(a.structures) == sorted(b.structures)
            and all(same(a.structures[k], b.structures[k]) for k in b.structures))


def feed_builders(ds):
    """The three feeds of the DOSE-PYFER step, each an endless epoch from a
    seed: float32 (the numpy chain), bfloat16 (the native gather) and
    packed."""
    from dose_prediction_tpu_torch.data import packed as PK
    from dose_prediction_tpu_torch.data import pipeline as PL

    n = 64
    return {"float32": lambda seed: PL.dose_batches(ds, seed=seed, num_samples_per_epoch=n),
            "bfloat16": lambda seed: PL.dose_batches(ds, seed=seed, native_bf16=True,
                                                     num_samples_per_epoch=n),
            "packed": lambda seed: PK.packed_dose_batches(ds, seed=seed,
                                                          num_samples_per_epoch=n)}


def check_native_augment(ds) -> int:
    """The native bf16 dose augment and seg gather against the numpy chain
    cast to bf16, bit for bit, at every decision of AUGMENT_DECISIONS on two
    patients (two seg crops each); returns the number of checks."""
    import numpy as np

    from dose_prediction_tpu_torch.data import native as N
    from dose_prediction_tpu_torch.data import transforms as T

    def bf16(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)

    checks = 0
    for p in ds.patients[:2]:
        inp, gt = p.model_input, p.gt
        for d in AUGMENT_DECISIONS:
            out = N.augment_dose_bf16(inp, gt, decisions=d)
            ref_inp, ref_gt = T.apply_dose_augment(inp, gt, *d)
            if out is None or not (same_bits(out[0], bf16(ref_inp))
                                   and same_bits(out[1], bf16(ref_gt))):
                raise AssertionError(f"data: native dose augment differs at {d}")
            checks += 1
        labels = np.ascontiguousarray(p.oars_label_encoded, np.uint8)
        ct = np.ascontiguousarray(p.ct, np.float32)
        for start in T.seg_crop_starts(ct.shape, labels, np.random.default_rng(SEED),
                                       crop=SEG_CROP, num_samples=2):
            sl = tuple(slice(a, a + c) for a, c in zip(start, SEG_CROP))
            for d in AUGMENT_DECISIONS:
                out = N.augment_seg_bf16(ct, labels, start, SEG_CROP, d)
                ref_ct, ref_lab = T.apply_seg_augment(ct[sl], labels[sl], *d)
                if out is None or not (same_bits(out[0], bf16(ref_ct))
                                       and np.array_equal(out[1], ref_lab)):
                    raise AssertionError(f"data: native seg gather differs at {start}, {d}")
                checks += 1
    return checks


def phase_data(dev, root):
    """A synthetic 128³ OpenKBP cohort through the port's data path: written,
    loaded through the native and the numpy reader (equal), packed; the
    native gathers and the card's unpack held against their plain versions
    bit for bit; the host seconds and bytes of one batch of each feed."""
    from dose_prediction_tpu_torch.data import native as N
    from dose_prediction_tpu_torch.data import packed as PK
    from dose_prediction_tpu_torch.data.openkbp import OpenKBPDataset
    from dose_prediction_tpu_torch.data.synthetic import make_synthetic_dataset

    t0 = time.perf_counter()
    pattern = make_synthetic_dataset(root, n_patients=DATA_PATIENTS, shape=DATA_SHAPE, seed=SEED)
    row = {"write_s": time.perf_counter() - t0, "native_built": N.native_available()}
    if row["native_built"]:
        log(f"data: native library built and loaded ({N.library_path().name})")
    else:
        log("data: the native library did not build, so the numpy path was used; "
            f"the compiler said:\n{N.native_build_error()}")
    t0 = time.perf_counter()
    ds = OpenKBPDataset(pattern, keep_structures=True)
    row["load_native_s"] = time.perf_counter() - t0
    with mock.patch.object(N, "get_lib", lambda: None):
        t0 = time.perf_counter()
        ds_numpy = OpenKBPDataset(pattern, keep_structures=True)
        row["load_numpy_s"] = time.perf_counter() - t0
    if not all(map(patients_equal, ds.patients, ds_numpy.patients)):
        raise AssertionError("data: the native reader's cohort differs from the numpy reader's")
    del ds_numpy
    t0 = time.perf_counter()
    packs = [PK.pack_patient(p) for p in ds.patients]
    row["pack_s"] = time.perf_counter() - t0
    if any(pk is None for pk in packs):
        raise AssertionError("data: a synthetic patient declined packing")
    row["native_checks"] = check_native_augment(ds) if row["native_built"] else 0
    # the card's unpack against the CPU's: four samples, every rot90 k, each flip axis
    batch = {k: torch.stack([pk[k] for pk in packs]) for k in PK.PACKED_KEYS}
    batch["flip"] = torch.tensor([1, 2, 4, 7], dtype=torch.int32)
    batch["rot_k"] = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    batch["shift"] = torch.tensor([0.05, -0.02, 0.0, 0.1], dtype=torch.float32)
    on_card = {k: v.to(dev) for k, v in batch.items()}
    cpu, card = PK.unpack_dose_batch(batch), PK.unpack_dose_batch(on_card)
    torch.cuda.synchronize()
    if not all(same_bits(card[k], cpu[k]) for k in cpu):
        raise AssertionError("data: the unpack on the card differs from the CPU's")
    one = {k: v[:1] for k, v in on_card.items()}
    row["unpack_ms"] = time_ms(lambda: PK.unpack_dose_batch(one), 20)
    del cpu, card, on_card, one
    row["feeds"] = {}
    for name, make in feed_builders(ds).items():
        it, times = make(SEED + 1), []
        for _ in range(3):
            t0 = time.perf_counter()
            b = next(it)
            times.append(time.perf_counter() - t0)
        row["feeds"][name] = {"host_s": sorted(times)[1], "times_s": times,
                              "nbytes": PK.packed_batch_nbytes(b)}
    log(f"data: {DATA_PATIENTS} patients at {DATA_SHAPE} written in {row['write_s']:.2f} s, "
        f"loaded in {row['load_native_s']:.3f} s (native reader) and "
        f"{row['load_numpy_s']:.3f} s (numpy reader), equal; packed in {row['pack_s']:.3f} s; "
        f"{row['native_checks']} native augment checks bit-equal; unpack on the card bit-equal "
        f"to the CPU's, {row['unpack_ms']:.4f} ms at batch 1; one batch on the host: "
        + ", ".join(f"{k} {v['host_s']:.4f} s (of {[round(t, 4) for t in v['times_s']]}), "
                    f"{v['nbytes']} bytes" for k, v in row["feeds"].items()))
    row["dataset"], row["pattern"] = ds, pattern
    return row


def fed_steps(label, step, state, feed, n):
    """One warm-up and ``n`` timed steps, each on the next batch of
    ``feed``: per step its seconds, the wait for the batch, the host's time
    to launch the step (it reads nothing on the host), the wait at the
    float(loss) after it and the launches; then one more step, its batch's
    wait included, under the profiler."""
    state, loss0 = step(state, next(feed))
    torch.cuda.synchronize()
    rows = []
    for _ in range(n):
        zero_counts()
        t0 = time.perf_counter()
        batch = next(feed)
        t1 = time.perf_counter()
        state, loss = step(state, batch)
        t2 = time.perf_counter()
        value = float(loss)                  # waits for the step
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        rows.append({"s": time.perf_counter() - t0, "batch_wait_s": t1 - t0,
                     "enqueue_s": t2 - t1, "loss_sync_s": t3 - t2, "loss": value,
                     "launches": read_counts()})
    prof = profiled(lambda: step(state, next(feed)), f"bf16 train step on the {label} feed")
    p50 = sorted(r["s"] for r in rows)[len(rows) // 2]
    return {"p50_s": p50, "first_loss": float(loss0), "steps": rows,
            "launches_per_step": rows[-1]["launches"],
            "idle_share": None if prof is None else prof["idle_share"], "profile": prof}


def first_losses_float32(dev, ds) -> dict:
    """The first loss of one float32 step (TF32 off, cuDNN convolutions) on
    the float32 and on the packed feed's first batch, from the same seeded
    weights: the configuration in which tests/test_packed_feed.py holds the
    two feeds to PACKED_LOSS_TOL."""
    losses = {}
    for name in ("float32", "packed"):
        model, step, state = make_trainer(dev, packed=name == "packed")
        batch = {k: v.to(dev) for k, v in next(feed_builders(ds)[name](SEED)).items()}
        losses[name] = float(step(state, batch)[1])
        del model, step, state, batch
        free_memory()
    return losses


def phase_train_feed(dev, data):
    """The full-width DOSE-PYFER step of phase 12 (bf16 compute, float32
    parameters, AdamW, net_A frozen, K3 routing on) fed from the data
    phase's cohort through device_prefetch(size=2), once per feed; then two
    TranSeg steps on bf16 96³ crops from seg_batches; then the packed feed's
    first loss against the float32 feed's in float32 compute."""
    from dose_prediction_tpu_torch.data import pipeline as PL

    ds, smi = data["dataset"], nvidia_smi()
    rows = {}
    with torch_default_tf32(), k3_routing(True):
        for name, make in feed_builders(ds).items():
            model, step, state = make_trainer(dev, packed=name == "packed", dtype=torch.bfloat16)
            feed = PL.device_prefetch(make(SEED), size=2, device=dev)
            try:
                row = fed_steps(name, step, state, feed, FEED_STEPS)
            finally:
                feed.close()
            row.update(data["feeds"][name])
            rows[name] = row
            log(f"train_feed {name}: step p50 {row['p50_s']} s (steps "
                f"{[r['s'] for r in row['steps']]}); waits for the batch "
                f"{[r['batch_wait_s'] for r in row['steps']]} s; host to the loss read "
                f"{[r['enqueue_s'] for r in row['steps']]} s; wait at float(loss) "
                f"{[r['loss_sync_s'] for r in row['steps']]} s; launches per step "
                f"{row['launches_per_step']}; idle share {row['idle_share']}; first loss "
                f"{row['first_loss']}; host {row['host_s']} s and {row['nbytes']} bytes a "
                f"batch; on {smi}")
            del model, step, state, feed
            free_memory()
        _, step, state = make_seg_trainer(dev)
        feed = PL.device_prefetch(PL.seg_batches(ds, crop=SEG_CROP, batch_size=1, seed=SEED,
                                                 feed_dtype="bfloat16"), size=2, device=dev)
        seg = []
        try:
            for _ in range(FEED_SEG_STEPS):
                zero_counts()
                t0 = time.perf_counter()
                batch = next(feed)
                if batch["ct"].dtype != torch.bfloat16 or batch["ct"].shape != (1, *SEG_CROP, 1):
                    raise AssertionError(f"train_feed: seg batch {batch['ct'].dtype} "
                                         f"{tuple(batch['ct'].shape)}")
                state, loss = step(state, batch)
                torch.cuda.synchronize()
                seg.append({"s": time.perf_counter() - t0, "loss": float(loss),
                            "launches": read_counts()})
        finally:
            feed.close()
        log(f"train_feed TranSeg on bf16 96³ crops: {seg}; on {smi}")
        rows["transeg"] = seg
        del step, state, feed
    # in bf16 compute the packed CT is rounded to bf16 twice (on the host,
    # then after the shift), the float32 feed's once: a reading, not held
    gap_bf16 = abs(rows["packed"]["first_loss"] - rows["float32"]["first_loss"])
    rows["first_loss_float32"] = first_losses_float32(dev, ds)
    f32 = rows["first_loss_float32"]
    diff = abs(f32["packed"] - f32["float32"])
    log(f"train_feed: first loss, bf16 compute: packed {rows['packed']['first_loss']}, "
        f"float32 feed {rows['float32']['first_loss']}, bfloat16 feed "
        f"{rows['bfloat16']['first_loss']}: packed - float32 {gap_bf16:.3g}; float32 compute "
        f"(TF32 off): packed {f32['packed']}, float32 feed {f32['float32']}: |diff| "
        f"{diff:.3g} (limit {PACKED_LOSS_TOL})")
    launches = {k: [r["launches"] for r in rows[k]["steps"]]
                for k in ("float32", "bfloat16", "packed")}
    ok = (diff <= PACKED_LOSS_TOL and launches["packed"] == launches["bfloat16"]
          and all(min(x.values()) > 0 for v in launches.values() for x in v)
          and all(math.isfinite(r["loss"]) for k in launches for r in rows[k]["steps"])
          and all(math.isfinite(r["loss"]) and r["launches"]["attention"] > 0 for r in seg))
    if not ok:
        raise AssertionError(f"train_feed check failed (packed loss diff {diff}, launches "
                             f"{launches})")
    return rows


@contextlib.contextmanager
def trainer_probes():
    """Readings taken while the CLI runs in this process: each EpochTimer
    tick-tock by bucket, each checkpoint write (slot, seconds, bytes), each
    train step's kernel launches and seconds (a synchronisation after it:
    the step reads nothing on the host), the train stages the DOSE-PYFER and
    TranSeg trainers wrap their steps in (infer/aot.py), and each
    evaluate_dose_model sweep's seconds."""
    from dose_prediction_tpu_torch.core import checkpoint as C
    from dose_prediction_tpu_torch.infer import aot
    from dose_prediction_tpu_torch.train import steps as STEP
    from dose_prediction_tpu_torch.train import trainers as T
    from dose_prediction_tpu_torch.utils.logging import EpochTimer

    rec = {"ticks": [], "writes": [], "steps": [], "step_times": [], "sweeps": [],
           "stages": []}

    class Timer(EpochTimer):
        def tock(self, bucket):
            t0 = self._t0
            super().tock(bucket)
            rec["ticks"].append((bucket, time.perf_counter() - (t0 or time.perf_counter())))

    save = C.save_checkpoint

    def timed_save(path, tree):
        t0 = time.perf_counter()
        nbytes = save(path, tree)
        rec["writes"].append((Path(path).name, time.perf_counter() - t0, nbytes))
        return nbytes

    def counted_step(step):
        def run(*args):
            before, t0 = read_counts(), time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            rec["step_times"].append(time.perf_counter() - t0)
            rec["steps"].append({k: v - before[k] for k, v in read_counts().items()})
            return out
        return run

    def counted(make):
        return lambda *args, **kwargs: counted_step(make(*args, **kwargs))

    wrap = aot.maybe_wrap_train_step

    # outside the stage: a replay calls no Python
    def counted_wrap(kind, model, step, mesh=None):
        stage = wrap(kind, model, step, mesh=mesh)
        if isinstance(stage, aot.LazyTrainStage):
            rec["stages"].append(stage)
        return counted_step(stage)

    sweep = T.evaluate_dose_model

    def timed_sweep(*args, **kwargs):
        t0 = time.perf_counter()
        out = sweep(*args, **kwargs)
        torch.cuda.synchronize()
        rec["sweeps"].append(time.perf_counter() - t0)
        return out

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(T, "EpochTimer", Timer))
        stack.enter_context(mock.patch.object(C, "save_checkpoint", timed_save))
        stack.enter_context(mock.patch.object(T, "evaluate_dose_model", timed_sweep))
        stack.enter_context(mock.patch.object(aot, "maybe_wrap_train_step", counted_wrap))
        for name in ("make_cascade_c3d_train_step", "make_simple_dose_train_step",
                     "make_dosegan_train_steps"):
            stack.enter_context(mock.patch.object(STEP, name, counted(getattr(STEP, name))))
        yield rec


def stage_readings(rec) -> list:
    """(name, used_aot, captures) of each train stage a CLI run made."""
    return [(st.name, st.used_aot, st.captures) for st in rec["stages"]]


def cli(*argv):
    """``python -m dose_prediction_tpu_torch *argv`` in this process: the
    return code, the JSON object it printed last (if any) and its output."""
    import io

    from dose_prediction_tpu_torch.cli.main import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main([str(a) for a in argv])
    text = out.getvalue()
    start = text.rfind("\n{\n")
    start = 0 if text.startswith("{") else (start + 1 if start >= 0 else -1)
    return rc, (json.loads(text[start:]) if start >= 0 else None), text


def p50(values):
    return sorted(values)[len(values) // 2] if values else None


def train_cli(rec_label, *argv):
    """One CLI train run under the probes; fails unless it returned 0."""
    with trainer_probes() as rec:
        t0 = time.perf_counter()
        rc, _, text = cli("train", *argv)
        rec["s"] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"trainer: {rec_label} returned {rc}:\n{text[-3000:]}")
    rec["text"] = text
    rec["step_s"] = [dt for b, dt in rec["ticks"] if b == "train"]
    rec["loader_s"] = [dt for b, dt in rec["ticks"] if b == "loader"]
    rec["val_s"] = [dt for b, dt in rec["ticks"] if b == "val"]
    free_memory()
    return rec


def reference_step_launches(dev, ds) -> dict:
    """Launches of one float32 make_pyfer_train_step step on the packed feed
    (the configuration train pyfer runs), outside the CLI."""
    from dose_prediction_tpu_torch.data import packed as PK

    model, step, state = make_trainer(dev, packed=True, kind="adam8bit")
    batch = {k: v.to(dev) for k, v in next(PK.packed_dose_batches(ds, seed=SEED)).items()}
    zero_counts()
    step(state, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    del model, step, state, batch
    free_memory()
    return counts


def graceful_stop(dev, train_glob, work: Path) -> dict:
    """A subprocess ``train pyfer`` with one step an epoch gets SIGTERM once
    its first epoch's 'last' slot exists: it must exit 0 with a 'last' slot,
    and a rerun must resume from it. Every process started is ended."""
    from dose_prediction_tpu_torch.core.checkpoint import restore_checkpoint

    repo = Path(__file__).resolve().parent
    ck = work / "sigterm"
    argv = [sys.executable, "-m", "dose_prediction_tpu_torch", "train", "pyfer", "--data",
            train_glob, "--epochs", "100000", "--check-val", "100000", "--samples-per-epoch",
            "1", "--feed-dtype", "packed", "--ckpt-dir", str(ck), "--log-dir",
            str(work / "sigterm_log")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        while (time.perf_counter() - t0 < SIGTERM_WAIT_S and proc.poll() is None
               and not (ck / "last.pt").exists()):
            time.sleep(0.2)
        if not (ck / "last.pt").exists():
            raise AssertionError("trainer: no 'last' slot before SIGTERM")
        t_signal = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=SIGTERM_WAIT_S)
        stop_s = time.perf_counter() - t_signal
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    stopped = restore_checkpoint(ck / "last.pt")
    row = {"rc": proc.returncode, "notice": "SIGTERM received" in out,
           "stopped_step": stopped["step"], "stopped_epoch": stopped["epoch"],
           "stop_s": stop_s, "first_run_s": time.perf_counter() - t0}
    del stopped
    rerun = subprocess.run(argv[:argv.index("100000")] + [str(row["stopped_epoch"] + 2)]
                           + argv[argv.index("100000") + 1:], cwd=repo, capture_output=True,
                           text=True, timeout=SIGTERM_WAIT_S)
    resumed = restore_checkpoint(ck / "last.pt")
    row.update(rerun_rc=rerun.returncode,
               resumed=f"resumed from epoch {row['stopped_epoch']}" in rerun.stdout,
               rerun_step=resumed["step"])
    if not (row["rc"] == 0 and row["notice"] and row["rerun_rc"] == 0 and row["resumed"]
            and row["rerun_step"] == row["stopped_step"] + 1):
        raise AssertionError(f"trainer: graceful stop failed: {row}\n{out[-2000:]}\n"
                             f"{rerun.stdout[-1000:]}{rerun.stderr[-2000:]}")
    return row


def same_nifti_as_cascade(dev, out: Path, patient: Path, seg_ck: Path, dose_ck: Path,
                          seg_mode: str, bf16: bool, **options) -> bool:
    """The NIfTI infer wrote against make_cascade_fn's output (with
    ``options``, aot or fuse) from the same restored weights, bit for bit."""
    from dose_prediction_tpu_torch.cli.main import default_flagship_model, default_seg_model
    from dose_prediction_tpu_torch.core.checkpoint import restore_checkpoint
    from dose_prediction_tpu_torch.data.nifti import read_nifti
    from dose_prediction_tpu_torch.data.openkbp import load_patient
    from dose_prediction_tpu_torch.infer.cascade import make_cascade_fn

    p = load_patient(str(patient))
    roi = SEG_CROP[0]
    seg = default_seg_model(img_size=SEG_CROP, device=dev,
                            trained_grid=(roi // 16,) * 3 if seg_mode == "dense" else None)
    dose = default_flagship_model(img_size=p.ct.shape, device=dev)
    seg.load_state_dict(restore_checkpoint(seg_ck)["model"])
    dose.load_state_dict(restore_checkpoint(dose_ck)["model"])
    run = make_cascade_fn(seg, seg.state_dict(), dose, dose.state_dict(), roi_size=SEG_CROP,
                          seg_mode=seg_mode, sw_batch_size=8 if bf16 else 4,
                          input_dtype=torch.bfloat16 if bf16 else None, **options)

    def vol(a):
        return torch.from_numpy(a[None, ..., None]).to(dev)

    want = run(vol(p.ct), vol(p.ptv), vol(p.dose_mask)).float().cpu().numpy()[0, ..., 0]
    got = read_nifti(out).data
    del seg, dose, run
    free_memory()
    return bool(got.shape == want.shape and (got == want).all())


def phase_trainer(dev, data, root):
    """The CLI at full width on the data phase's cohort: train pyfer (three
    patients, the fourth for validation), its resume, a K3-routed epoch,
    eval (host and device metrics), predict and score, train transeg and
    infer from the two checkpoints, train and eval c3d, and a graceful
    SIGTERM stop; PyTorch's TF32 defaults, float32 compute as the CLI
    trains."""
    from dose_prediction_tpu_torch.core.checkpoint import CheckpointManager, restore_checkpoint

    cohort, work = Path(root), Path(root) / "trainer"
    every, train_glob, val_glob = str(cohort / "pt_*"), str(cohort / "pt_[012]"), \
        str(cohort / "pt_3")
    smi, row = nvidia_smi(), {}
    with torch_default_tf32():
        ck = work / "pyfer"
        pyfer = ["pyfer", "--data", train_glob, "--val-data", val_glob, "--check-val", "1",
                 "--feed-dtype", "packed", "--ckpt-dir", ck, "--log-dir", work / "pyfer_log"]
        rec = train_cli("train pyfer", *pyfer, "--epochs", "2")
        last = restore_checkpoint(ck / "last.pt")
        slots = sorted(p.name for p in ck.iterdir()) + sorted(
            f"monitored/{p.name}" for p in (ck / "monitored").glob("*.pt"))
        row["pyfer"] = {
            "s": rec["s"], "steps": len(rec["steps"]), "step_s": rec["step_s"],
            "step_p50_s": p50(rec["step_s"]), "loader_s": rec["loader_s"],
            "val_s": rec["val_s"], "writes": rec["writes"], "launches": rec["steps"],
            "slots": slots, "last_step": last["step"], "last_epoch": last["epoch"],
            "stages": stage_readings(rec)}
        del last
        reference = reference_step_launches(dev, data["dataset"])
        row["pyfer"]["reference_launches"] = reference
        log(f"trainer: train pyfer (adam8bit, packed feed, float32 compute, 2 epochs of 3 steps) "
            f"in {rec['s']:.1f} s: step p50 {row['pyfer']['step_p50_s']} s (steps "
            f"{rec['step_s']}); loader waits {rec['loader_s']} s; validation {rec['val_s']} s; "
            f"checkpoint writes (slot, s, bytes) {rec['writes']}; launches per step "
            f"{rec['steps']} (a float32 make_pyfer_train_step: {reference}); slots {slots}; "
            f"last slot at step {row['pyfer']['last_step']}, epoch "
            f"{row['pyfer']['last_epoch']}; train stages (name, used_aot, captures) "
            f"{row['pyfer']['stages']}; on {smi}")
        ok = (len(rec["steps"]) == 6 and row["pyfer"]["last_step"] == 6
              and row["pyfer"]["stages"] == [("train:pyfer", True, 1)]
              and {"last.pt", "run_config.json"} <= set(slots)
              and any(s.startswith("monitored/") for s in slots)
              and all(st[k] == reference[k] for st in rec["steps"]
                      for k in ("attention", "instance_norm"))
              and min(reference["attention"], reference["instance_norm"]) > 0)
        if not ok:
            raise AssertionError(f"trainer: train pyfer check failed: {row['pyfer']}")

        rec = train_cli("resume", *pyfer, "--epochs", "3")
        last = restore_checkpoint(ck / "last.pt")
        row["resume"] = {"s": rec["s"], "resumed": "resumed from epoch 1" in rec["text"],
                         "steps": len(rec["steps"]), "last_step": last["step"],
                         "last_epoch": last["epoch"], "writes": rec["writes"],
                         "stages": stage_readings(rec)}
        del last
        log(f"trainer: the same with --epochs 3: {row['resume']}")
        if not (row["resume"]["resumed"] and row["resume"]["last_step"] == 9
                and row["resume"]["stages"] == [("train:pyfer", True, 1)]
                and row["resume"]["last_epoch"] == 2 and row["resume"]["steps"] == 3):
            raise AssertionError(f"trainer: resume check failed: {row['resume']}")

        with k3_routing(True):
            rec = train_cli("K3 epoch", "pyfer", "--data", train_glob, "--epochs", "1",
                            "--feed-dtype", "packed", "--ckpt-dir", work / "pyfer_k3",
                            "--log-dir", work / "pyfer_k3_log")
        row["k3"] = {"s": rec["s"], "launches": rec["steps"], "step_p50_s": p50(rec["step_s"]),
                     "stages": stage_readings(rec)}
        log(f"trainer: one epoch with DPT_PALLAS_CONV=1: launches per step {rec['steps']}, "
            f"step p50 {row['k3']['step_p50_s']} s; train stages {row['k3']['stages']}; on {smi}")
        if not (rec["steps"] and all(st["conv3d_k3"] > 0 for st in rec["steps"])
                and row["k3"]["stages"] == [("train:pyfer", True, 1)]):
            raise AssertionError(f"trainer: K3 was not launched in the routed epoch: {row['k3']}")

        best = CheckpointManager(ck, monitor="mean_dose_score", mode="max")
        best = best.step_path(best.best_step())
        evals = {}
        for label, extra in (("host", ()), ("device", ("--device-metrics",))):
            with trainer_probes() as rec:
                rc, res, text = cli("eval", "--data", every, "--ckpt", best,
                                    "--ckpt-dir", work / "eval_ck", "--log-dir",
                                    work / "eval_log", *extra)
            if rc != 0 or res is None:
                raise AssertionError(f"trainer: eval ({label}) returned {rc}:\n{text[-3000:]}")
            evals[label] = {**res, "sweep_s": rec["sweeps"][0]}
            free_memory()
        host, device = evals["host"], evals["device"]
        ivs_h = [float("nan") if v is None else v for v in host["ivs"]]
        defined = [i for i, v in enumerate(ivs_h) if math.isfinite(v)]
        ivs_ok = all(abs(device["ivs"][i] - ivs_h[i]) <= EVAL_IVS_ATOL + EVAL_IVS_RTOL
                     * abs(ivs_h[i]) for i in defined) and \
            all(device["ivs"][i] == 0 for i in range(len(ivs_h)) if i not in defined)
        dose_rel = abs(device["mean_dose_score"] - host["mean_dose_score"]) / \
            abs(host["mean_dose_score"])
        dvh_rel = abs(device["mean_dvh_score"] - host["mean_dvh_score"]) / \
            abs(host["mean_dvh_score"])
        row["eval"] = {"best": str(best.relative_to(work)), "host": host, "device": device,
                       "dose_rel": dose_rel, "dvh_rel": dvh_rel, "ivs_ok": ivs_ok}
        log(f"trainer: eval of {row['eval']['best']} on 4 patients: host sweep "
            f"{host['sweep_s']} s, device sweep {device['sweep_s']} s; mean_dose_score host "
            f"{host['mean_dose_score']}, device {device['mean_dose_score']} (rel {dose_rel:.3g}, "
            f"limit {EVAL_DOSE_REL}); mean_dvh_score host {host['mean_dvh_score']}, device "
            f"{device['mean_dvh_score']} (rel {dvh_rel:.3g}, limit {EVAL_DVH_REL}); IVS "
            f"{'within' if ivs_ok else 'OUTSIDE'} rtol {EVAL_IVS_RTOL} atol {EVAL_IVS_ATOL} on "
            f"{len(defined)} defined levels; on {smi}")
        if not (dose_rel <= EVAL_DOSE_REL and dvh_rel <= EVAL_DVH_REL and ivs_ok):
            raise AssertionError(f"trainer: eval host against device failed: {row['eval']}")

        t0 = time.perf_counter()
        rc, _, text = cli("predict", "--data", every, "--ckpt", best, "--out-dir",
                          work / "pred", "--ckpt-dir", work / "eval_ck", "--log-dir",
                          work / "eval_log")
        predict_s = time.perf_counter() - t0
        free_memory()
        rc2, scored, text2 = cli("score", "--pred-dir", work / "pred", "--gt-dir", cohort)
        if rc or rc2 or scored is None:
            raise AssertionError(f"trainer: predict/score failed:\n{text[-2000:]}{text2[-2000:]}")
        score_rel = abs(scored["dose_score"] - host["mean_dose_score"]) / \
            abs(host["mean_dose_score"])
        row["score"] = {"predict_s": predict_s, "dose_score": scored["dose_score"],
                        "dvh_score": scored["dvh_score"], "rel": score_rel}
        log(f"trainer: predict in {predict_s:.1f} s, then score: dose_score "
            f"{scored['dose_score']} against eval's {host['mean_dose_score']} (rel "
            f"{score_rel:.3g}, limit {SCORE_DOSE_REL}), dvh_score {scored['dvh_score']}")
        if score_rel > SCORE_DOSE_REL:
            raise AssertionError(f"trainer: score's dose score differs: {row['score']}")

        seg_ck = work / "transeg"
        rec = train_cli("train transeg", "transeg", "--data", every, "--epochs", "1",
                        "--max-steps", "2", "--ckpt-dir", seg_ck, "--log-dir",
                        work / "transeg_log")
        row["transeg"] = {"s": rec["s"], "step_s": rec["step_times"], "launches": rec["steps"],
                          "writes": rec["writes"], "stages": stage_readings(rec)}
        log(f"trainer: train transeg (two steps on 96³ crops): steps {rec['step_times']} s, "
            f"launches {rec['steps']}, train stages {row['transeg']['stages']}")
        if not (len(rec["steps"]) == 2 and all(st["attention"] > 0 for st in rec["steps"])
                and row["transeg"]["stages"] == [("train:transeg", True, 1)]):
            raise AssertionError(f"trainer: train transeg check failed: {row['transeg']}")
        infer = {}
        for mode, dtype in (("sliding", "bfloat16"), ("dense", "bfloat16")):
            out = work / f"infer_{mode}.nii.gz"
            t0 = time.perf_counter()
            rc, _, text = cli("infer", "--patient", cohort / "pt_3", "--seg-ckpt",
                              seg_ck / "last.pt", "--dose-ckpt", ck / "last.pt", "--out", out,
                              "--seg-mode", mode, "--serve-dtype", dtype)
            seconds = time.perf_counter() - t0
            free_memory()
            if rc != 0:
                raise AssertionError(f"trainer: infer {mode} returned {rc}:\n{text[-2000:]}")
            infer[mode] = {"s": seconds, "equal": same_nifti_as_cascade(
                dev, out, cohort / "pt_3", seg_ck / "last.pt", ck / "last.pt", mode,
                dtype == "bfloat16")}
        row["infer"] = infer
        log(f"trainer: train transeg (2 steps on 96³ crops) in {rec['s']:.1f} s: steps "
            f"{rec['step_times']} s, launches {rec['steps']}; infer (bf16) {infer}; on {smi}")
        if not all(v["equal"] for v in infer.values()):
            raise AssertionError(f"trainer: infer's NIfTI differs from make_cascade_fn's: {infer}")

        c3d_ck = work / "c3d"
        rec = train_cli("train c3d", "c3d", "--data", train_glob, "--val-data", val_glob,
                        "--epochs", "1", "--check-val", "1", "--scheduler", "cosine",
                        "--lr-encoder", C3D_LR_ENCODER, "--lr-decoder", C3D_LR_DECODER,
                        "--t-max", C3D_T_MAX, "--ckpt-dir", c3d_ck, "--log-dir",
                        work / "c3d_log")
        rc, res, text = cli("eval", "--model", "c3d", "--data", val_glob, "--ckpt",
                            c3d_ck / "last.pt", "--ckpt-dir", work / "eval_ck", "--log-dir",
                            work / "eval_log")
        free_memory()
        row["c3d"] = {"s": rec["s"], "step_s": rec["step_times"], "launches": rec["steps"],
                      "eval": res}
        log(f"trainer: train c3d (cosine, split rates, 3 steps) in {rec['s']:.1f} s: steps "
            f"{rec['step_times']} s, launches {rec['steps']}; eval --model c3d: {res and {k: res[k] for k in ('mean_dose_score', 'mean_dvh_score')}}")
        if rc != 0 or res is None or not math.isfinite(res["mean_dose_score"]) \
                or len(rec["steps"]) != 3:
            raise AssertionError(f"trainer: c3d failed:\n{text[-2000:]}")

        row["sigterm"] = graceful_stop(dev, train_glob, work)
        log(f"trainer: graceful stop: {row['sigterm']}")
    t0 = time.perf_counter()
    helped = subprocess.run([sys.executable, "-m", "dose_prediction_tpu_torch", "--help"],
                            cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                            timeout=SIGTERM_WAIT_S)
    row["help"] = {"rc": helped.returncode, "s": time.perf_counter() - t0}
    log(f"trainer: python -m dose_prediction_tpu_torch --help: {row['help']}")
    if helped.returncode != 0 or "--device" not in helped.stdout:
        raise AssertionError(f"trainer: --help failed:\n{helped.stderr[-2000:]}")
    return row


@contextlib.contextmanager
def launched_shapes():
    """Every K2 and K3 launch while the context is open, counted by
    (kernel, shape, dtype)."""
    import collections

    from dose_prediction_tpu_torch.kernels import conv3d as k3
    from dose_prediction_tpu_torch.kernels import instance_norm as k2

    seen = collections.Counter()
    direct, launch = k2._direct, k3._launch

    def record_k2(x, *args, **kwargs):
        seen[("instance_norm", tuple(x.shape), x.dtype)] += 1
        return direct(x, *args, **kwargs)

    def record_k3(x, *args):
        seen[("conv3d_k3", tuple(x.shape), x.dtype)] += 1
        return launch(x, *args)

    with mock.patch.object(k2, "_direct", record_k2), mock.patch.object(k3, "_launch", record_k3):
        yield seen


def shape_counts(seen) -> dict:
    """launched_shapes()'s counts keyed 'kernel (shape) dtype', as the
    kernels line reads them."""
    return {f"{k} {s} {str(d).replace('torch.', '')}": n for (k, s, d), n in seen.items()}


def unheld_shapes(seen) -> list:
    """The (kernel, shape, dtype) of ``seen`` that the kernels phase did not
    hold in that dtype."""
    held = {("instance_norm", torch.bfloat16): K2_SHAPES,
            ("instance_norm", torch.float32): K2_F32_SHAPES,
            ("conv3d_k3", torch.bfloat16): K3_SHAPES, ("conv3d_k3", torch.float32): K3_SHAPES}
    return sorted((k, s, str(d)) for k, s, d in seen if s not in held[(k, d)])


def zoo_model(name, dev, seed):
    """The full-width 'unetr' or 'old'-family TranSeg (8 classes, 96³
    windows) or 'hdunet' (9 channels, growth 16, 64 upsampling channels),
    weights drawn on the card from ``seed``, norms off 1/0: two calls give
    identical weights."""
    from dose_prediction_tpu_torch.models import UNETR, HDUNet, TranSeg
    from dose_prediction_tpu_torch.nn.init import init_params

    make = {"unetr": lambda: UNETR(out_ch=8, device=dev),
            "old": lambda: TranSeg(out_ch=8, block_family="old", device=dev),
            "hdunet": lambda: HDUNet(device=dev)}[name]
    g = torch.Generator(dev).manual_seed(seed)
    return perturb_norms([init_params(make(), g)], g)[0]


@torch.inference_mode()
def zoo_forward_parity(label, model, x, kernels, route_k3, seg):
    """One float32 forward (TF32 off) through the kernels and with the plain
    versions swapped in: seg logits by their argmax labels (at least
    LABEL_AGREEMENT_MIN of the voxels agree), a dose within
    DOSE_TOL_OF_SCALE of the plain run's largest value; K1 (where the model
    has attention) and K2 launched, K3 exactly where routed."""
    model.eval()
    with k3_routing(route_k3):
        zero_counts()
        out_k = model(x)
        torch.cuda.synchronize()
        launches = read_counts()
        with plain_kernels(*kernels):
            out_p = model(x)
        torch.cuda.synchronize()
    if seg:
        value = (out_k.argmax(1) == out_p.argmax(1)).float().mean().item()
        ok, what = value >= LABEL_AGREEMENT_MIN, "labels agree"
    else:
        value = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
        ok, what = value <= DOSE_TOL_OF_SCALE, "max |kernels - plain| / max |plain|"
    route = "K3 routing on" if route_k3 else "K3 routing off"
    log(f"zoo parity {label} f32 (TF32 off, {route}): {what} {value:.6g}; launches {launches}")
    routed = launches["conv3d_k3"] > 0 if route_k3 else launches["conv3d_k3"] == 0
    if not (ok and routed and launches["instance_norm"] > 0 and bool(torch.isfinite(out_k).all())
            and (launches["attention"] > 0 or not seg)):
        raise AssertionError(f"zoo parity {label} failed ({route})")
    return {what: value, "launches": launches}


def zoo_steps(dev, label, model, make_step, batch):
    """One warm-up and ZOO_TRAIN_STEPS timed bf16 steps of ``model`` (AdamW
    at TRAIN_LR / TRAIN_WD, K3 routing on, PyTorch's TF32 defaults): p50,
    launches and recomputes per step, peak memory. Every kernel the model
    has must launch and be recomputed in every step."""
    from dose_prediction_tpu_torch.train import state as S

    opt = S.make_optimizer(model, learning_rate=TRAIN_LR, weight_decay=TRAIN_WD)
    step, state = make_step(model, opt), S.TrainState(model, opt)
    with torch_default_tf32(), k3_routing(True):
        _, loss0, rows = timed_steps(dev, step, state, batch, ZOO_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    times = [r["s"] for r in rows]
    losses = [loss0] + [r["loss"] for r in rows]
    row = {"p50_s": p50(times), "times_s": times, "losses": losses, "peak_gib": peak / 2 ** 30,
           "launches_per_step": rows[-1]["launches"],
           "recomputes_per_step": rows[-1]["recomputes"]}
    log(f"zoo train {label} bf16 (K3 routing on): step seconds {times}, p50 {row['p50_s']} s; "
        f"losses (warm-up first) {losses}; launches per step {row['launches_per_step']}, "
        f"backward recomputes per step {row['recomputes_per_step']}; peak memory "
        f"{row['peak_gib']:.2f} GiB")
    has_attention = label != "hdunet"
    for r in rows:
        for field in ("launches", "recomputes"):
            if min(v for k, v in r[field].items() if has_attention or k != "attention") == 0:
                raise AssertionError(f"zoo train {label}: a kernel was not {field[:-1]}ed "
                                     f"in a step ({r[field]})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"zoo train {label}: a loss is not finite")
    return row


def zoo_cascade_predictions(dev, seg, dose_ck: Path, patients, seg_mode: str) -> list:
    """make_cascade_fn's bf16 predictions (sw batch 8) for each patient from
    ``seg`` (weights loaded) and the DOSE-PYFER of ``dose_ck``."""
    from dose_prediction_tpu_torch.cli.main import default_flagship_model
    from dose_prediction_tpu_torch.core.checkpoint import restore_checkpoint
    from dose_prediction_tpu_torch.infer.cascade import make_cascade_fn

    dose = default_flagship_model(img_size=patients[0].ct.shape, device=dev)
    dose.load_state_dict(restore_checkpoint(dose_ck)["model"])
    run = make_cascade_fn(seg, seg.state_dict(), dose, dose.state_dict(), roi_size=SEG_CROP,
                          sw_batch_size=8, seg_mode=seg_mode, input_dtype=torch.bfloat16)

    def vol(a):
        return torch.from_numpy(a[None, ..., None]).to(dev)

    out = [run(vol(p.ct), vol(p.ptv), vol(p.dose_mask)).cpu() for p in patients]
    del dose, run
    free_memory()
    return out


def zoo_cli(dev, data, root) -> dict:
    """The CLI in this process on the data phase's cohort: train hdunet,
    eval --model hdunet (host and device metrics) and predict; train
    transeg --block-family old, then import-torch of its state dict under a
    'model.' prefix; train transeg --mode-model 0 and seg-eval; linked-eval
    --block-family old (bf16, sliding and dense) with that seg slot and the
    trainer phase's DOSE-PYFER slot, against make_cascade_fn."""
    import numpy as np

    from dose_prediction_tpu_torch.cli.main import default_seg_model
    from dose_prediction_tpu_torch.core.checkpoint import restore_checkpoint
    from dose_prediction_tpu_torch.evaluation import metrics as M
    from dose_prediction_tpu_torch.train import linked as LK

    cohort, work = Path(root), Path(root) / "zoo"
    every, train_glob, val_glob = str(cohort / "pt_*"), str(cohort / "pt_[012]"), \
        str(cohort / "pt_3")
    dose_ck = cohort / "trainer" / "pyfer" / "last.pt"
    row = {}
    with torch_default_tf32():
        hd = work / "hdunet"
        rec = train_cli("train hdunet", "hdunet", "--data", train_glob, "--val-data", val_glob,
                        "--epochs", "2", "--check-val", "1", "--ckpt-dir", hd, "--log-dir",
                        work / "hd_log")
        last = restore_checkpoint(hd / "last.pt")
        row["hdunet"] = {"s": rec["s"], "steps": len(rec["steps"]), "step_s": rec["step_times"],
                         "step_p50_s": p50(rec["step_times"]), "launches": rec["steps"],
                         "writes": rec["writes"], "last_step": last["step"]}
        del last
        evals = {}
        for label, extra in (("host", ()), ("device", ("--device-metrics",))):
            with trainer_probes() as probe:
                rc, res, text = cli("eval", "--model", "hdunet", "--data", every, "--ckpt",
                                    hd / "last.pt", "--ckpt-dir", work / "eval_ck", "--log-dir",
                                    work / "eval_log", *extra)
            if rc != 0 or res is None:
                raise AssertionError(f"zoo: eval --model hdunet ({label}) returned {rc}:\n"
                                     f"{text[-3000:]}")
            evals[label] = {**res, "sweep_s": probe["sweeps"][0]}
            free_memory()
        host, device = evals["host"], evals["device"]
        dose_rel = abs(device["mean_dose_score"] - host["mean_dose_score"]) / \
            abs(host["mean_dose_score"])
        dvh_rel = abs(device["mean_dvh_score"] - host["mean_dvh_score"]) / \
            abs(host["mean_dvh_score"])
        rc, _, text = cli("predict", "--model", "hdunet", "--data", every, "--ckpt",
                          hd / "last.pt", "--out-dir", work / "hd_pred", "--ckpt-dir",
                          work / "eval_ck", "--log-dir", work / "eval_log")
        predicted = sorted(p.name for p in (work / "hd_pred").glob("pt_*/dose.nii.gz")) \
            if rc == 0 else []
        free_memory()
        row["hdunet"].update(eval_host=host, eval_device=device, dose_rel=dose_rel,
                             dvh_rel=dvh_rel, predict_rc=rc, predicted=len(predicted))
        log(f"zoo: train hdunet (float32, 2 epochs of 3 steps) in {rec['s']:.1f} s: steps "
            f"{rec['step_times']} s, p50 {row['hdunet']['step_p50_s']} s, launches per step "
            f"{rec['steps']}, checkpoint writes {rec['writes']}; eval host sweep "
            f"{host['sweep_s']} s, device sweep {device['sweep_s']} s, mean_dose_score host "
            f"{host['mean_dose_score']} device {device['mean_dose_score']} (rel {dose_rel:.3g}), "
            f"mean_dvh_score rel {dvh_rel:.3g}; predict wrote {len(predicted)} NIfTIs")
        if not (len(rec["steps"]) == 6 and row["hdunet"]["last_step"] == 6
                and all(st["instance_norm"] > 0 for st in rec["steps"])
                and dose_rel <= EVAL_DOSE_REL and dvh_rel <= EVAL_DVH_REL
                and rc == 0 and len(predicted) == DATA_PATIENTS):
            raise AssertionError(f"zoo: hdunet CLI check failed: {row['hdunet']}\n{text[-2000:]}")

        old = work / "old"
        rec = train_cli("train transeg old", "transeg", "--block-family", "old", "--data",
                        every, "--epochs", "1", "--max-steps", "2", "--ckpt-dir", old,
                        "--log-dir", work / "old_log")
        model = default_seg_model(block_family="old", img_size=SEG_CROP, device=dev)
        model.load_state_dict(restore_checkpoint(old / "last.pt")["model"])
        torch.save({"state_dict": {f"model.{k}": v for k, v in model.state_dict().items()}},
                   work / "old_reference.ckpt")
        rc, _, text = cli("import-torch", "--kind", "transeg", "--src",
                          work / "old_reference.ckpt", "--dest", work / "old_imported.pt")
        if rc != 0:
            raise AssertionError(f"zoo: import-torch --kind transeg returned {rc}:\n"
                                 f"{text[-2000:]}")
        imported = default_seg_model(block_family="old", img_size=SEG_CROP, device=dev)
        imported.load_state_dict(restore_checkpoint(work / "old_imported.pt"))
        x = seeded_seg_batch(dev, torch.float32)["ct"].permute(0, 4, 1, 2, 3).contiguous()
        with torch.inference_mode():
            same = same_bits(imported.eval()(x), model.eval()(x))
        del model, imported, x
        free_memory()
        row["old"] = {"s": rec["s"], "step_s": rec["step_times"], "launches": rec["steps"],
                      "import_bit_equal": same}
        log(f"zoo: train transeg --block-family old (2 steps on 96³ crops) in {rec['s']:.1f} s: "
            f"steps {rec['step_times']} s, launches {rec['steps']}; import-torch --kind transeg "
            f"of its state dict under 'model.': forward bit-equal {same}")
        if not (len(rec["steps"]) == 2 and same
                and all(st["attention"] > 0 and st["instance_norm"] > 0 for st in rec["steps"])):
            raise AssertionError(f"zoo: transeg old CLI check failed: {row['old']}")

        un = work / "unetr"
        rec = train_cli("train transeg unetr", "transeg", "--mode-model", "0", "--data", every,
                        "--epochs", "1", "--max-steps", "2", "--ckpt-dir", un, "--log-dir",
                        work / "unetr_log")
        t0 = time.perf_counter()
        rc, res, text = cli("seg-eval", "--mode-model", "0", "--data", every, "--ckpt",
                            un / "last.pt", "--ckpt-dir", work / "eval_ck", "--log-dir",
                            work / "eval_log")
        seg_eval_s = time.perf_counter() - t0
        free_memory()
        row["unetr"] = {"s": rec["s"], "step_s": rec["step_times"], "launches": rec["steps"],
                        "seg_eval": res, "seg_eval_s": seg_eval_s}
        log(f"zoo: train transeg --mode-model 0 (2 steps) in {rec['s']:.1f} s: steps "
            f"{rec['step_times']} s, launches {rec['steps']}; seg-eval --mode-model 0 in "
            f"{seg_eval_s:.1f} s: {res}")
        if rc != 0 or res is None or not math.isfinite(res["val_loss"]) or \
                len(rec["steps"]) != 2:
            raise AssertionError(f"zoo: unetr CLI check failed:\n{text[-2000:]}")

        linked = {}
        patients = data["dataset"].patients
        for mode in ("sliding", "dense"):
            runs = []
            make = LK.make_cascade_fn

            def recording(*args, **kwargs):
                run = make(*args, **kwargs)

                def recorded(*volumes):
                    out = run(*volumes)
                    runs.append(out)
                    return out
                return recorded

            t0 = time.perf_counter()
            with mock.patch.object(LK, "make_cascade_fn", recording):
                rc, res, text = cli("linked-eval", "--block-family", "old", "--data", every,
                                    "--seg-ckpt", old / "last.pt", "--dose-ckpt", dose_ck,
                                    "--seg-mode", mode, "--serve-dtype", "bfloat16",
                                    "--sw-batch", "8", "--ckpt-dir", work / "eval_ck",
                                    "--log-dir", work / "linked_log")
            seconds = time.perf_counter() - t0
            if rc != 0 or res is None:
                raise AssertionError(f"zoo: linked-eval {mode} returned {rc}:\n{text[-3000:]}")
            got = [r.cpu() for r in runs]
            del runs
            free_memory()
            seg = default_seg_model(block_family="old", img_size=SEG_CROP, device=dev,
                                    trained_grid=(SEG_CROP[0] // 16,) * 3
                                    if mode == "dense" else None)
            seg.load_state_dict(restore_checkpoint(old / "last.pt")["model"])
            want = zoo_cascade_predictions(dev, seg, dose_ck, patients, mode)
            del seg
            equal = len(got) == len(want) and all(same_bits(a, b) for a, b in zip(got, want))
            preds = [w.float().numpy()[0, ..., 0] for w in want]
            scores = [M.dose_score(q, p.real_dose, p.dose_mask) for q, p in zip(preds, patients)]
            dvhs = [M.dvh_score_for_patient(q, p.real_dose, p.structures, p.spacing)["dvh_dif"]
                    for q, p in zip(preds, patients)]
            dvhs = [d for d in dvhs if math.isfinite(d)]
            score_equal = (res["mean_dose_score"] == float(np.mean(scores))
                           and res["mean_dvh_score"] == float(np.mean(dvhs)))
            linked[mode] = {"s": seconds, "bit_equal": equal, "scores_equal": score_equal,
                            **res}
            log(f"zoo: linked-eval --block-family old bf16 {mode} in {seconds:.1f} s: {res}; "
                f"predictions bit-equal to make_cascade_fn's {equal}; scores equal to the "
                f"port's metrics on them {score_equal}")
            if not (equal and score_equal):
                raise AssertionError(f"zoo: linked-eval {mode} check failed: {linked[mode]}")
        row["linked"] = linked
    return row


def zoo_step_parity(dev, kernels):
    """One float32 HD-UNet step (K3 routing on) through the kernels against
    the plain versions, each gradient leaf held to its own limit from
    ZOO_NOISE_RUNS plane-scaled noise runs (check_step_parity)."""
    from dose_prediction_tpu_torch.train import state as S
    from dose_prediction_tpu_torch.train import steps

    def make_hdunet():
        model = zoo_model("hdunet", dev, SEED + 10)
        opt = S.make_optimizer(model, learning_rate=TRAIN_LR, weight_decay=TRAIN_WD)
        return model, steps.make_simple_dose_train_step(model, opt), S.TrainState(model, opt)

    runs = parity_runs(make_hdunet, seeded_batch(dev, torch.float32), kernels, True, dev,
                       plane_scaled=True, noise_runs=ZOO_NOISE_RUNS)
    row = check_step_parity("zoo hdunet step", runs, True, zero_grad=ZOO_ZERO_GRAD_BIAS,
                            per_leaf=True)
    del runs
    free_memory()
    return row


def phase_zoo(dev, data, root, kernels):
    """The reference's other seg and dose networks at full width: float32
    parity of UNETR, 'old' TranSeg and HD-UNet (kernels against plain, K3
    routing off and on); bf16 serve with the 'old' TranSeg, then UNETR, as
    stage 1; bf16 train steps of HD-UNet, UNETR and the 'old' TranSeg; a
    float32 HD-UNet step through the kernels against the plain versions;
    the CLI (zoo_cli). K2 and K3 launches at a shape the kernels phase did
    not hold, in that dtype, fail the phase."""
    from dose_prediction_tpu_torch.infer.cascade import make_cascade_fn
    from dose_prediction_tpu_torch.train import steps

    smi, row = nvidia_smi(), {}
    with launched_shapes() as seen:
        models = {name: zoo_model(name, dev, SEED + 8) for name in ("unetr", "old", "hdunet")}
        crop = seeded_seg_batch(dev, torch.float32)["ct"].permute(0, 4, 1, 2, 3).contiguous()
        volume = seeded_batch(dev, torch.float32)["input"].permute(0, 4, 1, 2, 3).contiguous()
        row["parity"] = {}
        for route in (False, True):
            for name, x in (("unetr", crop), ("old", crop), ("hdunet", volume)):
                row["parity"][f"{name} k3={route}"] = zoo_forward_parity(
                    name, models[name], x, kernels, route, seg=name != "hdunet")
        del crop, volume
        free_memory()

        dose = seeded_pyfer(dev)
        ct, ptv, mask = seeded_volumes(dev, torch.bfloat16)
        row["serve"] = {}
        for name in ("old", "unetr"):
            seg = models[name]
            run = make_cascade_fn(seg, seg.state_dict(), dose, dose.state_dict(),
                                  roi_size=SEG_CROP, sw_batch_size=8, overlap=0.25,
                                  dose_scale=70.0)
            times, launches, ok = bf16_requests(run, ct, ptv, mask, ZOO_SERVE_REQUESTS)
            per = {k: v / ZOO_SERVE_REQUESTS for k, v in launches.items()}
            row["serve"][name] = {"p50_s": p50(times), "times_s": times,
                                  "launches_per_request": per}
            log(f"zoo serve bf16, {name} as stage 1 (96³ windows, sw batch 8) into DOSE-PYFER: "
                f"request seconds {times}, p50 {p50(times)} s; output checks {ok}; K1 and K2 "
                f"launches per request {per['attention']}, {per['instance_norm']}; on {smi}")
            if not (ok and per["attention"] > 0 and per["instance_norm"] > 0):
                raise AssertionError(f"zoo serve {name} check failed ({launches})")
        del dose, ct, ptv, mask, run, seg, models
        free_memory()

        row["train"] = {}
        for name, make_step, batch in (
                ("hdunet", steps.make_simple_dose_train_step, seeded_batch),
                ("unetr", steps.make_transeg_train_step, seeded_seg_batch),
                ("old", steps.make_transeg_train_step, seeded_seg_batch)):
            free_memory()
            torch.cuda.reset_peak_memory_stats(dev)
            model = zoo_model(name, dev, SEED + 9)
            with launched_shapes() as steps_seen:   # this model's steps alone, from zero
                row["train"][name] = zoo_steps(dev, name, model, make_step,
                                               batch(dev, torch.bfloat16))
            row["train"][name]["shapes"] = shape_counts(steps_seen)
            del model
        # the kernels line reads the new bf16 shapes' launches from these steps
        missing = [(k, s) for k, shapes in (("instance_norm", K2_ZOO_SHAPES),
                                            ("conv3d_k3", K3_ZOO_SHAPES)) for s in shapes
                   if f"{k} {s} bfloat16" not in row["train"]["hdunet"]["shapes"]]
        if missing:
            raise AssertionError(f"zoo train hdunet: not launched at {missing}")
        free_memory()

        row["train_parity"] = zoo_step_parity(dev, kernels)
        row["cli"] = zoo_cli(dev, data, root)
    row["shapes"] = shape_counts(seen)
    unheld = unheld_shapes(seen)
    log(f"zoo: K2 and K3 launches by shape and dtype {row['shapes']}; not held by the kernels "
        f"phase: {unheld}")
    if unheld:
        raise AssertionError(f"zoo: K2/K3 shapes the kernels phase did not hold: {unheld}")
    return row


def gan_nets(dev, width, seed=SEED + 11):
    """DoseGAN's generator (9 channels in) and unconditional critic at
    ``width``, drawn from ``seed`` (the critic from seed + 1)."""
    from dose_prediction_tpu_torch.models import NLayerDiscriminator, UnetGenerator3D
    from dose_prediction_tpu_torch.train.trainers import seeded

    return (seeded(seed, lambda: UnetGenerator3D(ngf=width, device=dev)),
            seeded(seed + 1, lambda: NLayerDiscriminator(ndf=width, device=dev)))


def gan_step(g, d):
    """make_dosegan_train_steps over both nets (Adam at GAN_LR, b1 0.5) and
    their states."""
    from dose_prediction_tpu_torch.train import state as S
    from dose_prediction_tpu_torch.train import steps

    g_opt = S.make_optimizer(g, learning_rate=GAN_LR, b1=0.5)
    d_opt = S.make_optimizer(d, learning_rate=GAN_LR, b1=0.5)
    return (steps.make_dosegan_train_steps(g, d, g_opt, d_opt, l1_weight=GAN_L1_WEIGHT),
            S.TrainState(g, g_opt), S.TrainState(d, d_opt))


def gan_steps(dev):
    """One warm-up and GAN_STEPS timed DoseGAN steps at the reference's
    width on the fixed 128³ batch, float32 at PyTorch's TF32 defaults (as
    the trainer computes): p50, peak memory, losses and K1/K2/K3 launches
    per step, which must all be 0 (its norms are BatchNorms)."""
    g, d = gan_nets(dev, GAN_WIDTH)
    step, gs, ds = gan_step(g, d)
    batch = seeded_batch(dev, torch.float32)
    rows = []
    with torch_default_tf32():
        gs, ds, info = step(gs, ds, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(GAN_STEPS):
            zero_counts()
            t0 = time.perf_counter()
            gs, ds, info = step(gs, ds, batch)
            torch.cuda.synchronize()
            rows.append({"s": time.perf_counter() - t0, "g_loss": float(info["g_loss"]),
                         "d_loss": float(info["d_loss"]), "launches": read_counts()})
    times = [r["s"] for r in rows]
    row = {"p50_s": p50(times), "times_s": times,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "g_losses": [r["g_loss"] for r in rows], "d_losses": [r["d_loss"] for r in rows],
           "launches_per_step": [r["launches"] for r in rows],
           "params": {k: sum(p.numel() for p in m.parameters()) for k, m in (("g", g), ("d", d))}}
    log(f"hpo_gan: DoseGAN step (ngf = ndf = {GAN_WIDTH}, 9 -> 1 channels, 128³, float32 at "
        f"TF32 defaults): step seconds {times}, p50 {row['p50_s']} s; peak memory "
        f"{row['peak_gib']:.2f} GiB; g_loss {row['g_losses']}, d_loss {row['d_losses']}; K1/K2/K3 "
        f"launches per step {row['launches_per_step']}; parameters {row['params']}")
    if any(any(r["launches"].values()) for r in rows):
        raise AssertionError("hpo_gan: the DoseGAN step launched K1, K2 or K3")
    if not all(math.isfinite(x) for x in row["g_losses"] + row["d_losses"]):
        raise AssertionError("hpo_gan: a DoseGAN loss is not finite")
    del g, d, step, gs, ds, batch
    free_memory()
    return row


@contextlib.contextmanager
def channel_scaled_bn_noise(seed, dev, amplitude=TRAIN_PARITY_NOISE):
    """Each BatchNorm3d output plus amplitude · u · its channel's largest
    |value| (u seeded uniform in [-1, 1], kept out of the gradient): the
    noise run of tests/test_torch_port_dosegan.py."""
    from dose_prediction_tpu_torch.nn.layers import BatchNorm3d

    g = torch.Generator(dev).manual_seed(seed)
    forward = BatchNorm3d.forward

    def noisy(self, inp):
        out = forward(self, inp)
        u = torch.rand(out.shape, generator=g, device=out.device) * 2 - 1
        scale = out.detach().abs().amax(dim=(0, 2, 3, 4), keepdim=True)
        return out + (scale * (amplitude * u)).detach()

    with mock.patch.object(BatchNorm3d, "forward", noisy):
        yield


def gan_parity(dev):
    """One float32 DoseGAN step (TF32 off) at GAN_PARITY_WIDTH on a seeded
    GAN_PARITY_SIZE³ batch, on the card and in the port on the CPU from the
    same weights (the tests hold the CPU path to the JAX package): both
    losses within rel 1e-5; each gradient leaf within max(1e-3, 2 × its own
    largest departure in GAN_NOISE_RUNS channel-scaled noise runs on the
    card) × its max |g| (a floor of 2e-6 × the net's largest |g|), the
    zero-gradient biases below 1e-4 of it; each BatchNorm buffer within
    max(1e-5 of its scale, 2 × its noise departure), a running mean's scale
    being max(|mean|, √var)."""
    import re

    cpu = torch.device("cpu")
    g0, d0 = gan_nets(cpu, GAN_PARITY_WIDTH)
    gen = torch.Generator().manual_seed(SEED + 12)
    shape = (1, GAN_PARITY_SIZE, GAN_PARITY_SIZE, GAN_PARITY_SIZE)
    mask = (torch.rand((*shape, 1), generator=gen) < 0.7).float()
    batch = {"input": torch.randn((*shape, 9), generator=gen),
             "gt": torch.cat([torch.rand((*shape, 1), generator=gen) * mask, mask], dim=-1)}

    def run(device, noise=contextlib.nullcontext()):
        g, d = gan_nets(device, GAN_PARITY_WIDTH)
        g.load_state_dict(g0.state_dict())
        d.load_state_dict(d0.state_dict())
        step, gs, ds = gan_step(g, d)
        with noise:
            gs, ds, info = step(gs, ds, {k: v.to(device) for k, v in batch.items()})
        nets = (("g", g), ("d", d))
        grads = {f"{t}.{n}": p.grad.detach().cpu() for t, m in nets
                 for n, p in m.named_parameters()}
        bufs = {f"{t}.{n}": b.detach().cpu() for t, m in nets for n, b in m.named_buffers()}
        return float(info["g_loss"]), float(info["d_loss"]), grads, bufs

    card, host = run(dev), run(cpu)
    noisy = [run(dev, channel_scaled_bn_noise(SEED + i, dev)) for i in range(GAN_NOISE_RUNS)]
    losses = {k: abs(card[i] - host[i]) / abs(host[i]) for i, k in enumerate(("g_loss", "d_loss"))}
    zero = re.compile(GAN_ZERO_GRAD_BIAS)
    worst, failed, zeros = {}, [], 0
    for net in ("g", "d"):
        names = [n for n in host[2] if n.startswith(f"{net}.")]
        g_max = max(host[2][n].abs().max().item() for n in names)
        for n in names:
            err = (card[2][n] - host[2][n]).abs().max().item()
            if zero.search(n):
                zeros += 1
                if max(card[2][n].abs().max().item(), host[2][n].abs().max().item()) > \
                        1e-4 * g_max:
                    failed.append(n)
                continue
            scale = host[2][n].abs().max().item()
            departure = max((r[2][n] - card[2][n]).abs().max().item() for r in noisy) / scale
            worst[n] = err / max(max(1e-3, 2 * departure) * scale, 2e-6 * g_max)
    buf_worst = {}
    for n, want in host[3].items():
        if n.endswith("num_batches_tracked"):
            if not torch.equal(card[3][n], want):
                failed.append(n)
            continue
        if n.endswith("running_mean"):
            var = host[3][n.replace("running_mean", "running_var")].clamp_min(0).sqrt()
            scale = torch.maximum(want.abs(), var).max().item()
        else:
            scale = want.abs().max().item()
        err = (card[3][n] - want).abs().max().item()
        departure = max((r[3][n] - card[3][n]).abs().max().item() for r in noisy)
        buf_worst[n] = err / max(1e-5 * scale, 2 * departure)
    failed += [n for n, r in {**worst, **buf_worst}.items() if r > 1.0]
    wg, wb = max(worst, key=worst.get), max(buf_worst, key=buf_worst.get)
    row = {"loss_rel_diff": losses, "worst_grad_ratio": worst[wg], "worst_grad_leaf": wg,
           "worst_buffer_ratio": buf_worst[wb], "worst_buffer": wb, "leaves": len(worst),
           "zero_grad_biases": zeros, "failed": failed[:5]}
    log(f"hpo_gan: DoseGAN f32 step (TF32 off, ngf = ndf = {GAN_PARITY_WIDTH}, "
        f"{GAN_PARITY_SIZE}³) card against CPU: g_loss {card[0]} / {host[0]}, d_loss {card[1]} / "
        f"{host[1]}, relative diffs {losses} (limit 1e-5); worst gradient leaf err / its "
        f"per-leaf limit {worst[wg]:.3g} ({wg}) over {len(worst)} leaves and {zeros} "
        f"zero-gradient biases; worst BatchNorm buffer err / its limit {buf_worst[wb]:.3g} "
        f"({wb}); over their limits: {failed[:5]}")
    if failed or max(losses.values()) > 1e-5:
        raise AssertionError(f"hpo_gan: DoseGAN step parity failed: {row}")
    return row


def gan_cli(dev, data, root) -> dict:
    """The CLI's DoseGAN at the reference's width on the data phase's
    cohort: train dosegan (two epochs of three steps, validating on the
    fourth patient), then --epochs 3 (it must resume at epoch 2); eval
    --model dosegan with host and device metrics (within the bars of
    tests/test_losses_metrics.py); predict; import-torch --kind dosegan-g
    and dosegan-d of the trained nets under netG./netD. (each imported
    forward bit-equal to the trained one)."""
    from dose_prediction_tpu_torch.core.checkpoint import restore_checkpoint

    cohort, work = Path(root), Path(root) / "gan"
    every, train_glob, val_glob = str(cohort / "pt_*"), str(cohort / "pt_[012]"), \
        str(cohort / "pt_3")
    ck, row = work / "ck", {}
    with torch_default_tf32():
        for epochs in (2, 3):
            rec = train_cli(f"train dosegan --epochs {epochs}", "dosegan", "--data", train_glob,
                            "--val-data", val_glob, "--epochs", epochs, "--check-val", "1",
                            "--ckpt-dir", ck, "--log-dir", work / "log")
            row[f"train_{epochs}"] = {"s": rec["s"], "step_s": rec["step_times"],
                                      "step_p50_s": p50(rec["step_times"]),
                                      "launches": rec["steps"], "writes": rec["writes"],
                                      "resumed": "resumed from epoch 1" in rec["text"]}
            log(f"hpo_gan: train dosegan --epochs {epochs} (float32) in {rec['s']:.1f} s: steps "
                f"{rec['step_times']} s, p50 {p50(rec['step_times'])} s, K1/K2/K3 launches per "
                f"step {rec['steps']}, checkpoint writes {rec['writes']}")
        last = restore_checkpoint(ck / "last.pt")
        first, resumed = row["train_2"], row["train_3"]
        if not (len(first["launches"]) == 6 and len(resumed["launches"]) == 3
                and resumed["resumed"] and last["epoch"] == 2 and last["g"]["step"] == 9
                and last["d"]["step"] == 9
                and not any(any(c.values()) for c in first["launches"] + resumed["launches"])):
            raise AssertionError(f"hpo_gan: train dosegan check failed: {row}")
        evals = {}
        for label, extra in (("host", ()), ("device", ("--device-metrics",))):
            with trainer_probes() as probe:
                rc, res, text = cli("eval", "--model", "dosegan", "--data", every, "--ckpt",
                                    ck / "last.pt", "--ckpt-dir", work / "eval_ck",
                                    "--log-dir", work / "eval_log", *extra)
            if rc != 0 or res is None:
                raise AssertionError(f"hpo_gan: eval --model dosegan ({label}) returned {rc}:\n"
                                     f"{text[-3000:]}")
            evals[label] = {**res, "sweep_s": probe["sweeps"][0]}
            free_memory()
        host, device = evals["host"], evals["device"]
        dose_rel = abs(device["mean_dose_score"] - host["mean_dose_score"]) / \
            abs(host["mean_dose_score"])
        dvh_rel = abs(device["mean_dvh_score"] - host["mean_dvh_score"]) / \
            abs(host["mean_dvh_score"])
        rc, _, text = cli("predict", "--model", "dosegan", "--data", every, "--ckpt",
                          ck / "last.pt", "--out-dir", work / "pred", "--ckpt-dir",
                          work / "eval_ck", "--log-dir", work / "eval_log")
        predicted = len(list((work / "pred").glob("pt_*/dose.nii.gz"))) if rc == 0 else 0
        free_memory()
        row.update(eval_host=host, eval_device=device, dose_rel=dose_rel, dvh_rel=dvh_rel,
                   predicted=predicted)
        log(f"hpo_gan: eval --model dosegan: host sweep {host['sweep_s']} s, device sweep "
            f"{device['sweep_s']} s, mean_dose_score host {host['mean_dose_score']} device "
            f"{device['mean_dose_score']} (rel {dose_rel:.3g}), mean_dvh_score rel "
            f"{dvh_rel:.3g}; predict --model dosegan wrote {predicted} NIfTIs")
        if not (dose_rel <= EVAL_DOSE_REL and dvh_rel <= EVAL_DVH_REL
                and predicted == DATA_PATIENTS):
            raise AssertionError(f"hpo_gan: dosegan eval/predict check failed:\n{text[-2000:]}")

        torch.save({"state_dict": {**{f"netG.{k}": v for k, v in last["g"]["model"].items()},
                                   **{f"netD.{k}": v for k, v in last["d"]["model"].items()}}},
                   work / "gan_reference.ckpt")
        batch = seeded_batch(dev, torch.float32)
        inputs = {"g": batch["input"].permute(0, 4, 1, 2, 3).contiguous(),
                  "d": batch["gt"][..., :1].permute(0, 4, 1, 2, 3).contiguous()}
        row["import"] = {}
        for part in ("g", "d"):
            dest = work / f"dosegan-{part}.pt"
            rc, _, text = cli("import-torch", "--kind", f"dosegan-{part}", "--src",
                              work / "gan_reference.ckpt", "--dest", dest)
            if rc != 0:
                raise AssertionError(f"hpo_gan: import-torch --kind dosegan-{part} returned "
                                     f"{rc}:\n{text[-2000:]}")
            trained, imported = (gan_nets(dev, GAN_WIDTH)[part == "d"] for _ in range(2))
            trained.load_state_dict(last[part]["model"])
            imported.load_state_dict(restore_checkpoint(dest))
            with torch.inference_mode():
                same = same_bits(imported.eval()(inputs[part]), trained.eval()(inputs[part]))
            row["import"][part] = same
            del trained, imported
            free_memory()
        log(f"hpo_gan: import-torch --kind dosegan-g / dosegan-d of the trained nets under "
            f"netG./netD.: forward bit-equal {row['import']}")
        if not all(row["import"].values()):
            raise AssertionError(f"hpo_gan: an imported DoseGAN net's forward differs")
        del last, batch, inputs
        free_memory()
    return row


def journal(log_dir: Path) -> list:
    path = log_dir / "trials.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []


def search_cli(root) -> dict:
    """The CLI's tune (TPE, TUNE_SAMPLES trials of TUNE_EPOCHS epochs on
    three patients, validating on the fourth) with --max-concurrent 1 and
    then 2 on the one card (each run's wall seconds and best config), tune
    --resume with one more sample (exactly one more trial), and kfold
    --folds 2 --epochs 1 over the four patients (each fold's score)."""
    cohort, work = Path(root), Path(root) / "hpo"
    every, train_glob, val_glob = str(cohort / "pt_*"), str(cohort / "pt_[012]"), \
        str(cohort / "pt_3")
    common = ("--data", train_glob, "--val-data", val_glob, "--epochs", TUNE_EPOCHS,
              "--check-val", "1", "--sampler", "tpe")
    row = {}
    with torch_default_tf32():
        for concurrent, samples, resume in ((1, TUNE_SAMPLES, ()), (2, TUNE_SAMPLES, ()),
                                            (1, TUNE_SAMPLES + 1, ("--resume",))):
            label = f"max_concurrent_{concurrent}" + ("_resume" if resume else "")
            log_dir = work / f"log{concurrent}"
            before = len(journal(log_dir))
            t0 = time.perf_counter()
            rc, res, text = cli("tune", *common, "--num-samples", samples, "--max-concurrent",
                                concurrent, "--ckpt-dir", work / f"ck{concurrent}",
                                "--log-dir", log_dir, *resume)
            seconds = time.perf_counter() - t0
            trials = journal(log_dir)
            free_memory()
            if rc != 0 or res is None:
                raise AssertionError(f"hpo_gan: tune ({label}) returned {rc}:\n{text[-3000:]}")
            row[label] = {"s": seconds, "trials_run": len(trials) - before, **res,
                          "trial_ids": [t["trial_id"] for t in trials],
                          "values": [t["last_value"] for t in trials]}
            log(f"hpo_gan: tune --sampler tpe --num-samples {samples} --epochs {TUNE_EPOCHS} "
                f"--max-concurrent {concurrent} {' '.join(resume)} in {seconds:.1f} s: "
                f"{len(trials) - before} trials run, best config {res['best_config']}, best "
                f"value {res['best_value']}, early-stopped {res['num_early_stopped']}; trial "
                f"values {row[label]['values']}")
            if len(trials) - before != (1 if resume else TUNE_SAMPLES) or \
                    not math.isfinite(res["best_value"]):
                raise AssertionError(f"hpo_gan: tune ({label}) check failed: {row[label]}")
        t0 = time.perf_counter()
        rc, res, text = cli("kfold", "--data", every, "--folds", "2", "--epochs", "1",
                            "--check-val", "1", "--ckpt-dir", work / "kfold",
                            "--log-dir", work / "kfold_log")
        row["kfold"] = {"s": time.perf_counter() - t0, "folds": res}
        free_memory()
        log(f"hpo_gan: kfold --folds 2 --epochs 1 in {row['kfold']['s']:.1f} s: {res}")
        if rc != 0 or res is None or sorted(res) != ["0", "1"] or \
                not all(math.isfinite(f["mean_dose_score"]) for f in res.values()):
            raise AssertionError(f"hpo_gan: kfold check failed:\n{text[-3000:]}")
    return row


def phase_hpo_gan(dev, data, root):
    """DoseGAN's step at full width (gan_steps) and on the card against the
    CPU (gan_parity), the CLI's DoseGAN (gan_cli), and the search and the
    folds (search_cli). Any K2 or K3 launch of the phase at a shape the
    kernels phase did not hold, in that dtype, fails it."""
    row = {}
    with launched_shapes() as seen:
        torch.cuda.reset_peak_memory_stats(dev)
        row["step"] = gan_steps(dev)
        row["parity"] = gan_parity(dev)
        free_memory()
        row["cli"] = gan_cli(dev, data, root)
        row["search"] = search_cli(root)
    row["shapes"] = shape_counts(seen)
    unheld = unheld_shapes(seen)
    log(f"hpo_gan: K2 and K3 launches by shape and dtype {row['shapes']}; not held by the "
        f"kernels phase: {unheld}")
    if unheld:
        raise AssertionError(f"hpo_gan: K2/K3 shapes the kernels phase did not hold: {unheld}")
    return row


@contextlib.contextmanager
def k1_launched_shapes():
    """Every K1 launch while the context is open, counted by (shape, dtype)."""
    import collections

    from dose_prediction_tpu_torch.kernels import attention as k1

    seen = collections.Counter()
    direct = k1._direct

    def record(q, *args):
        seen[(tuple(q.shape), q.dtype)] += 1
        return direct(q, *args)

    with mock.patch.object(k1, "_direct", record):
        yield seen


def exp_zoo_model(name, dev, seed):
    """A full-width model of the experiments zoo, weights drawn on the card
    from ``seed``, norms off 1/0."""
    from dose_prediction_tpu_torch.models import experiments as E
    from dose_prediction_tpu_torch.nn.init import init_params

    make = {"vitgan": lambda: E.vitgan_generator(device=dev),
            "exp": lambda: E.exp_generator(device=dev),
            "shared_encoder": lambda: E.SharedEncoderModel(device=dev),
            "experimental_cascade": lambda: E.ExperimentalCascade(device=dev),
            "shared_unetr": lambda: E.SharedUNetRModel(device=dev),
            "resnet10": lambda: E.resnet10(device=dev)}[name]
    g = torch.Generator(dev).manual_seed(seed)
    return perturb_norms([init_params(make(), g)], g)[0]


def flat_outputs(out):
    return [out] if torch.is_tensor(out) else [t for o in out for t in flat_outputs(o)]


@torch.inference_mode()
def exp_forward_parity(dev, kernels) -> dict:
    """One float32 forward (TF32 off, K3 routing off) of each full-width zoo
    model through the kernels and with the plain versions swapped in: every
    output within DOSE_TOL_OF_SCALE of the plain run's largest |value|; K1
    launched where the model has a ViT, K2 launched, K3 not."""
    x = seeded_batch(dev, torch.float32)["input"].permute(0, 4, 1, 2, 3).contiguous()
    rows = {}
    for name in ("vitgan", "exp", "shared_encoder", "experimental_cascade", "shared_unetr"):
        model = exp_zoo_model(name, dev, SEED + 13).eval()
        with k3_routing(False):
            zero_counts()
            out_k = flat_outputs(model(x))
            torch.cuda.synchronize()
            launches = read_counts()
            with plain_kernels(*kernels):
                out_p = flat_outputs(model(x))
            torch.cuda.synchronize()
        value = max(((k - p).abs().max() / p.abs().max()).item() for k, p in zip(out_k, out_p))
        finite = all(bool(torch.isfinite(k).all()) for k in out_k)
        vit = name != "experimental_cascade"
        rows[name] = {"max |kernels - plain| / max |plain|": value, "launches": launches,
                      "outputs": len(out_k)}
        log(f"exp_gan parity {name} f32 (TF32 off): max |kernels - plain| / max |plain| over "
            f"{len(out_k)} outputs {value:.6g}; launches {launches}")
        if not (finite and value <= DOSE_TOL_OF_SCALE and launches["instance_norm"] > 0
                and (launches["attention"] > 0) == vit and launches["conv3d_k3"] == 0):
            raise AssertionError(f"exp_gan parity {name} failed: {rows[name]}")
        del model, out_k, out_p
        free_memory()
    return rows


@contextlib.contextmanager
def scaled_norm_noise(seed, dev, amplitude=TRAIN_PARITY_NOISE):
    """Each InstanceNorm and Linear output × (1 + amplitude·u) and each
    BatchNorm output plus amplitude·u × its channel's largest |value| (u
    seeded uniform in [-1, 1], kept out of the gradient): the noise run of
    tests/test_torch_port_vitgan.py."""
    from dose_prediction_tpu_torch.nn.layers import InstanceNorm3d, Linear

    g = torch.Generator(dev).manual_seed(seed)

    def noisy(forward):
        def run(self, inp):
            out = forward(self, inp)
            u = torch.rand(out.shape, generator=g, device=out.device) * 2 - 1
            return out + (out * (amplitude * u)).detach()
        return run

    with mock.patch.object(InstanceNorm3d, "forward", noisy(InstanceNorm3d.forward)), \
            mock.patch.object(Linear, "forward", noisy(Linear.forward)), \
            channel_scaled_bn_noise(seed + 100, dev, amplitude):
        yield


def vitgan_parity(dev) -> dict:
    """One float32 ViT-GAN step (TF32 off) of a narrow generator
    (VITGAN_PARITY_VIT: head dim 32, the least K1 takes) and a ResNet-10 of
    VITGAN_PARITY_WIDTHS on a seeded VITGAN_PARITY_SIZE³ batch,
    on the card and on the CPU from the same weights, in each mode: train_d,
    no train_d, freeze_d with the mask of every critic leaf but fc, and the
    critic half (train_d with the generator's learning rate 0, so that the
    critic's loss sees the same generator weights on both sides). g_loss
    within rel 1e-5; d_loss within rel 1e-5 in the critic half and, where it
    follows the generator's update, within max(1e-5, 2 × its departure in
    the noise runs); each gradient leaf within max(1e-3, 2 × its largest
    departure in VITGAN_NOISE_RUNS noise runs on the card, the critic
    half's its own) × its max |g| (a floor of 2e-6 × the net's largest
    |g|); without train_d the critic unchanged and d_loss 0; with freeze_d
    the masked leaves bit-unchanged and their first moments nonzero; in the
    critic half the generator bit-unchanged."""
    from dose_prediction_tpu_torch.models import experiments as E
    from dose_prediction_tpu_torch.train import gan
    from dose_prediction_tpu_torch.train import state as S
    from dose_prediction_tpu_torch.train.trainers import seeded

    cpu, size = torch.device("cpu"), VITGAN_PARITY_SIZE

    def generator(device):          # K1 takes head dims 32, 64 and 128
        return E.VitGenerator(img_size=size, mode_multi_dec=True, act="mish",
                              multiS_conv=False, device=device, **VITGAN_PARITY_VIT)

    g0 = seeded(SEED + 14, lambda: generator(cpu))
    d0 = seeded(SEED + 15, lambda: E.resnet10(widths=VITGAN_PARITY_WIDTHS, device=cpu))
    mask = {n: not n.startswith("fc.") for n, _ in d0.named_parameters()}
    gen = torch.Generator().manual_seed(SEED + 16)
    shape = (1, size, size, size)
    dmask = (torch.rand((*shape, 1), generator=gen) < 0.7).float()
    batch = {"input": torch.randn((*shape, 9), generator=gen),
             "gt": torch.cat([torch.rand((*shape, 1), generator=gen) * dmask, dmask], dim=-1)}
    modes = {"train_d": dict(train_d=True), "no_train_d": dict(train_d=False),
             "freeze_d": dict(train_d=True, freeze_d=True), "critic_half": dict(train_d=True)}

    def run(device, mode, noise=contextlib.nullcontext()):
        g = generator(device)
        d = E.resnet10(widths=VITGAN_PARITY_WIDTHS, device=device)
        g.load_state_dict(g0.state_dict())
        d.load_state_dict(d0.state_dict())
        g_opt = S.make_optimizer(g, learning_rate=0.0 if mode == "critic_half" else VITGAN_G_LR)
        d_opt = S.make_optimizer(d, learning_rate=VITGAN_D_LR)
        step = gan.make_vitgan_train_step(g, d, g_opt, d_opt, delta3=VITGAN_DELTA3,
                                          delta1=EXP_DELTA1, delta2=EXP_DELTA2,
                                          d_freeze_mask=mask)
        with noise:
            gs, ds, info = step(S.TrainState(g, g_opt), S.TrainState(d, d_opt),
                                {k: v.to(device) for k, v in batch.items()}, **modes[mode])
        nets = (("g", g), ("d", d))
        return {"losses": (float(info["g_loss"]), float(info["d_loss"])),
                "steps": (gs.step, ds.step),
                "grads": {f"{t}.{n}": p.grad.detach().cpu() for t, m in nets
                          for n, p in m.named_parameters() if p.grad is not None},
                "d": {n: p.detach().cpu() for n, p in d.named_parameters()},
                "g": {n: p.detach().cpu() for n, p in g.named_parameters()},
                "mu": {n: d_opt.state[p]["mu"].cpu() for n, p in d.named_parameters()
                       if p in d_opt.state}}

    noise_runs = {m: [run(dev, m, scaled_norm_noise(SEED + i, dev))
                      for i in range(VITGAN_NOISE_RUNS)] for m in ("train_d", "critic_half")}
    rows, failed = {}, []
    for mode in modes:
        card, host = run(dev, mode), run(cpu, mode)
        runs = noise_runs["critic_half" if mode == "critic_half" else "train_d"]
        noisy = [r["grads"] for r in runs]
        rel = [abs(c - h) / abs(h) if h else abs(c) for c, h in zip(card["losses"],
                                                                     host["losses"])]
        # d_loss follows the generator's update of the same step: Adam's first
        # update turns rounding-sized gradients into ±lr, so it is held by
        # the noise runs' own departure
        # (the critic half holds it at 1e-5 without that update)
        d_noise = max(abs(r["losses"][1] - card["losses"][1]) for r in runs)
        d_limit = 0.0 if not host["losses"][1] else 1e-5 if mode == "critic_half" else \
            max(1e-5, 2 * d_noise / abs(host["losses"][1]))
        worst = {}
        for net in ("g", "d"):
            names = [n for n in host["grads"] if n.startswith(f"{net}.")]
            if not names:
                continue
            g_max = max(host["grads"][n].abs().max().item() for n in names)
            for n in names:
                scale = host["grads"][n].abs().max().item()
                departure = max((r[n] - card["grads"][n]).abs().max().item() for r in noisy)
                err = (card["grads"][n] - host["grads"][n]).abs().max().item()
                worst[n] = err / max(max(1e-3, 2 * departure / max(scale, 1e-30)) * scale,
                                     2e-6 * g_max)
        ok = rel[0] <= 1e-5 and rel[1] <= max(d_limit, 1e-5) and \
            all(v <= 1.0 for v in worst.values()) and card["steps"] == host["steps"]
        if mode == "no_train_d":
            ok = ok and card["losses"][1] == 0.0 and card["steps"] == (1, 0) and \
                all(torch.equal(card["d"][n], p.detach()) for n, p in d0.named_parameters())
        if mode == "freeze_d":
            held = all(torch.equal(card["d"][n], p.detach()) == mask[n]
                       for n, p in d0.named_parameters())
            moved = all(card["mu"][n].abs().max().item() > 0 for n in mask if mask[n])
            ok = ok and held and moved
        if mode == "critic_half":
            ok = ok and host["losses"][1] > 0 and \
                all(torch.equal(card["g"][n], p.detach()) for n, p in g0.named_parameters())
        wl = max(worst, key=worst.get)
        rows[mode] = {"loss_rel_diff": rel, "d_loss_limit": d_limit,
                      "worst_grad_ratio": worst[wl],
                      "worst_grad_leaf": wl, "leaves": len(worst), "steps": card["steps"]}
        log(f"exp_gan: ViT-GAN f32 step ({mode}, TF32 off, generator {VITGAN_PARITY_VIT}, "
            f"ResNet-10 "
            f"{VITGAN_PARITY_WIDTHS}, {size}³) card against CPU: g_loss {card['losses'][0]} / "
            f"{host['losses'][0]}, d_loss {card['losses'][1]} / {host['losses'][1]}, "
            f"relative diffs {rel} (limits 1e-5, d_loss {d_limit:.3g}: 1e-5 in the critic "
            f"half, else twice its noise runs' departure, floor 1e-5); worst gradient leaf "
            f"err / its per-leaf limit "
            f"{worst[wl]:.3g} ({wl}) over {len(worst)} leaves; steps {card['steps']}")
        if not ok:
            failed.append(mode)
    if failed:
        raise AssertionError(f"exp_gan: ViT-GAN step parity failed in {failed}: {rows}")
    return rows


def exp_gan_steps(dev) -> dict:
    """One warm-up and EXP_GAN_STEPS timed full-width steps, float32 at
    PyTorch's TF32 defaults (as the trainers compute): ViT-GAN's (its
    generator and a ResNet-10 critic, Adam at the trainer's rates, critic
    trained) and the exp model's deep-supervision step (AdamW at TRAIN_LR /
    TRAIN_WD). p50, peak memory, K1/K2/K3 launches a step (K1 and K2 in
    every step, K3 in none), K2 calls by shape."""
    from dose_prediction_tpu_torch.train import gan
    from dose_prediction_tpu_torch.train import state as S
    from dose_prediction_tpu_torch.train import steps as STEP

    batch = seeded_batch(dev, torch.float32)
    rows = {}
    for name in ("vitgan", "exp"):
        free_memory()
        torch.cuda.reset_peak_memory_stats(dev)
        g = exp_zoo_model(name, dev, SEED + 17)
        if name == "vitgan":
            d = exp_zoo_model("resnet10", dev, SEED + 18)
            g_opt = S.make_optimizer(g, learning_rate=VITGAN_G_LR)
            d_opt = S.make_optimizer(d, learning_rate=VITGAN_D_LR)
            inner = gan.make_vitgan_train_step(g, d, g_opt, d_opt, delta3=VITGAN_DELTA3,
                                               delta1=EXP_DELTA1, delta2=EXP_DELTA2)
            states = [S.TrainState(g, g_opt), S.TrainState(d, d_opt)]

            def step(_, b):
                states[0], states[1], info = inner(states[0], states[1], b)
                return None, info["g_loss"]
        else:
            opt = S.make_optimizer(g, learning_rate=TRAIN_LR, weight_decay=TRAIN_WD)
            train = STEP.make_deep_supervision_train_step(g, opt, delta1=EXP_DELTA1,
                                                          delta2=EXP_DELTA2)
            states = [S.TrainState(g, opt)]

            def step(_, b):
                states[0], loss = train(states[0], b)
                return None, loss
        with torch_default_tf32(), k3_routing(False), launched_shapes() as seen:
            _, loss0, steps = timed_steps(dev, step, None, batch, EXP_GAN_STEPS)
        times = [r["s"] for r in steps]
        row = {"p50_s": p50(times), "times_s": times,
               "losses": [loss0] + [r["loss"] for r in steps],
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               "launches_per_step": steps[-1]["launches"],
               "recomputes_per_step": steps[-1]["recomputes"],
               "shapes": {k: v // (EXP_GAN_STEPS + 1) for k, v in shape_counts(seen).items()}}
        rows[name] = row
        log(f"exp_gan: {name} step (full width, 128³, float32 at TF32 defaults): step seconds "
            f"{times}, p50 {row['p50_s']} s; peak memory {row['peak_gib']:.2f} GiB; losses "
            f"(warm-up first) {row['losses']}; launches per step {row['launches_per_step']}, "
            f"recomputes per step {row['recomputes_per_step']}; K2 calls a step by shape "
            f"{row['shapes']}")
        if not (all(math.isfinite(v) for v in row["losses"])
                and all(r["launches"]["attention"] > 0 and r["launches"]["instance_norm"] > 0
                        and r["launches"]["conv3d_k3"] == 0 for r in steps)):
            raise AssertionError(f"exp_gan: the {name} step check failed: {row}")
        del g, states, step, steps
    free_memory()
    return rows


def write_medicalnet(path: Path, dev) -> dict:
    """A MedicalNet-layout resnet_10 pickle: a seeded full-width ResNet-10's
    entries without fc, under DataParallel's 'module.' prefix. Returns its
    state dict."""
    d = exp_zoo_model("resnet10", dev, SEED + 19)
    sd = {k: v.cpu() for k, v in d.state_dict().items() if not k.startswith("fc.")}
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    return sd


def exp_gan_cli(dev, data, root) -> dict:
    """The CLI's ViT-GAN and exp model at full width on the data phase's
    cohort (three patients, validating on the fourth; float32 at TF32
    defaults): train vitgan --pretrained-critic (a seeded MedicalNet-layout
    pickle) --unfreeze-epoch 1 over two one-step epochs, validating after
    the second (both optimizers restarted at epoch 1: one update counted
    in the slot), train exp (one epoch of two steps, validated), eval and predict --model vitgan and exp, import-torch --kind
    resnet10 (of the pickle), vitgan-g (the trained generator under
    'generator.' beside critic entries) and exp-gen (under 'model_.' beside
    the reference's unused 'out' head): each slot bit-equal to its source."""
    from dose_prediction_tpu_torch.core.checkpoint import restore_checkpoint

    cohort, work = Path(root), Path(root) / "exp_gan"
    work.mkdir(parents=True, exist_ok=True)
    every, train_glob, val_glob = str(cohort / "pt_*"), str(cohort / "pt_[012]"), \
        str(cohort / "pt_3")
    pickle = work / "resnet_10.pth"
    critic = write_medicalnet(pickle, dev)
    row = {}
    with torch_default_tf32():
        # slots of about 1.3 GB each: validation at the last epoch only, so
        # that the run's disk writes stay within the card machine's 45 GiB
        runs = {"vitgan": ("--pretrained-critic", pickle, "--unfreeze-epoch", "1",
                           "--samples-per-epoch", "1", "--epochs", "2", "--check-val", "2"),
                "exp": ("--samples-per-epoch", "2", "--epochs", "1", "--check-val", "1")}
        for name, extra in runs.items():
            rec = train_cli(f"train {name}", name, "--data", train_glob, "--val-data", val_glob,
                            "--ckpt-dir", work / name, "--log-dir", work / f"{name}_log", *extra)
            row[f"train_{name}"] = {"s": rec["s"], "writes": rec["writes"],
                                    "sweeps_s": rec["sweeps"]}
            log(f"exp_gan: train {name} (float32) in {rec['s']:.1f} s; checkpoint writes "
                f"{rec['writes']}")
        slot = restore_checkpoint(work / "vitgan" / "last.pt")
        restarted = "critic unfrozen, optimizers restarted" in \
            (work / "vitgan_log" / "log.txt").read_text()
        counts = (slot["g"]["optimizer"]["count"], slot["d"]["optimizer"]["count"])
        row["vitgan_restart"] = {"logged": restarted, "optimizer_counts": counts,
                                 "steps": (slot["g"]["step"], slot["d"]["step"])}
        log(f"exp_gan: train vitgan: optimizers restarted at epoch 1 {restarted}, update counts "
            f"(g, d) in the last slot {counts}, steps {row['vitgan_restart']['steps']}")
        if not (restarted and counts == (1, 1) and slot["epoch"] == 1
                and (slot["g"]["step"], slot["d"]["step"]) == (2, 2)):
            raise AssertionError(f"exp_gan: the unfreeze restart check failed: {row}")
        for name in runs:
            with trainer_probes() as probe:
                rc, res, text = cli("eval", "--model", name, "--data", every, "--ckpt",
                                    work / name / "last.pt", "--ckpt-dir", work / "eval_ck",
                                    "--log-dir", work / "eval_log")
            if rc != 0 or res is None or not math.isfinite(res["mean_dose_score"]):
                raise AssertionError(f"exp_gan: eval --model {name} returned {rc}:\n"
                                     f"{text[-3000:]}")
            out = work / f"{name}_pred"
            rc, _, text = cli("predict", "--model", name, "--data", every, "--ckpt",
                              work / name / "last.pt", "--out-dir", out, "--ckpt-dir",
                              work / "eval_ck", "--log-dir", work / "eval_log")
            predicted = len(list(out.glob("pt_*/dose.nii.gz"))) if rc == 0 else 0
            row[f"eval_{name}"] = {**res, "sweep_s": probe["sweeps"][0], "predicted": predicted}
            log(f"exp_gan: eval --model {name}: sweep {probe['sweeps'][0]:.2f} s, "
                f"mean_dose_score {res['mean_dose_score']}, mean_dvh_score "
                f"{res['mean_dvh_score']}; predict wrote {predicted} NIfTIs")
            if predicted != DATA_PATIENTS:
                raise AssertionError(f"exp_gan: predict --model {name} failed:\n{text[-2000:]}")
            free_memory()
        generator = restore_checkpoint(work / "vitgan" / "last.pt")["g"]["model"]
        exp_model = restore_checkpoint(work / "exp" / "last.pt")["model"]
        sources = {
            "resnet10": (pickle, critic),
            "vitgan-g": ({**{f"generator.{k}": v for k, v in generator.items()},
                          **{f"discriminator.{k}": v for k, v in critic.items()}}, generator),
            "exp-gen": ({**{f"model_.{k}": v for k, v in exp_model.items()},
                         "model_.out.0.weight": torch.zeros(1, 16, 1, 1, 1),
                         "model_.out.0.bias": torch.zeros(1)}, exp_model)}
        row["import"] = {}
        for kind, (src, want) in sources.items():
            if not isinstance(src, Path):
                path = work / f"{kind}.ckpt"
                torch.save({"state_dict": src}, path)
                src = path
            dest = work / f"{kind}.pt"
            rc, _, text = cli("import-torch", "--kind", kind, "--src", src, "--dest", dest)
            got = restore_checkpoint(dest) if rc == 0 else {}
            same = rc == 0 and all(torch.equal(got[k].cpu(), v.cpu()) for k, v in want.items())
            row["import"][kind] = same
            if not same:
                raise AssertionError(f"exp_gan: import-torch --kind {kind} returned {rc} or "
                                     f"differs from its source:\n{text[-2000:]}")
        log(f"exp_gan: import-torch --kind resnet10 / vitgan-g / exp-gen: bit-equal "
            f"{row['import']}")
        free_memory()
    return row


def phase_exp_gan(dev, data, root, kernels):
    """The experiments zoo and ViT-GAN: the narrow ViT-GAN step on the card
    against the CPU (vitgan_parity, whose kernel launches its CPU run holds),
    then forwards against the plain versions (exp_forward_parity), the
    full-width steps (exp_gan_steps) and the CLI (exp_gan_cli), where K2 and
    K3 launches at a shape the kernels phase did not hold, in that dtype,
    and K1 launches at a shape outside K1_SHAPES fail the phase."""
    # the narrow step's kernel shapes are held by its CPU run itself
    row = {"step_parity": vitgan_parity(dev)}
    free_memory()
    with launched_shapes() as seen, k1_launched_shapes() as k1_seen:
        row["parity"] = exp_forward_parity(dev, kernels)
        row["steps"] = exp_gan_steps(dev)
        with launched_shapes() as cli_seen:
            row["cli"] = exp_gan_cli(dev, data, root)
        row["cli_shapes"] = shape_counts(cli_seen)
    row["shapes"] = shape_counts(seen)
    row["k1_shapes"] = {f"attention {s} {str(d).replace('torch.', '')}": n
                        for (s, d), n in k1_seen.items()}
    unheld = unheld_shapes(seen) + sorted(("attention", s, str(d)) for s, d in k1_seen
                                          if s not in K1_SHAPES)
    log(f"exp_gan: K2 and K3 launches by shape and dtype {row['shapes']}; K1 launches "
        f"{row['k1_shapes']}; not held by the kernels phase: {unheld}")
    if unheld:
        raise AssertionError(f"exp_gan: shapes the kernels phase did not hold: {unheld}")
    return row


def written_gib() -> float:
    """GiB this process has written so far (``wchar`` of /proc/self/io:
    files, pipes and terminals alike), or NaN where that is not readable."""
    try:
        for line in Path("/proc/self/io").read_text().splitlines():
            if line.startswith("wchar:"):
                return int(line.split()[1]) / 2 ** 30
    except OSError:
        pass
    return float("nan")


def remove_work(root, *names) -> None:
    """Delete phase work directories no later phase reads: the disk holds
    at most one write-heavy phase's slots at once."""
    for name in names:
        shutil.rmtree(Path(root) / name, ignore_errors=True)


def pct(values, q):
    """The nearest-rank ``q`` quantile of ``values``."""
    return sorted(values)[max(math.ceil(q * len(values)) - 1, 0)]


def timed_request(run, vols):
    """One request awaited by a synchronisation: (output, seconds, the
    kernels' launches it counted, from counts set to 0 just before it)."""
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = run(*vols)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counts()


def captured_vs_eager(label, captured, eager, vols, n):
    """The first captured call (the capture included) against the eager
    output, then ``n`` captured requests interleaved with ``n`` eager ones
    on the same inputs: seconds, p50 and p90 of each, peak memory of the
    first call above what was allocated before it, what stays allocated and
    reserved after it, and whether every captured output equals the eager
    one bit for bit. The launches the replays credit to the wrappers'
    counters (infer/aot.py) are kept as ``credited``: they repeat what the
    capture counted, so only the profiler (profiled_pair) shows what a
    replay runs."""
    want, _, eager_launches = timed_request(eager, vols)
    free_memory()
    base, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    first, first_s, _ = timed_request(captured, vols)
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    held_gib = (torch.cuda.memory_allocated() - base) / 2 ** 30
    free_memory()       # what stays reserved then is the graphs' private pool
    pool_gib = (torch.cuda.memory_reserved() - base_reserved) / 2 ** 30
    equal = [same_bits(first, want)]
    cap_s, eager_s, launches = [], [], []
    for _ in range(n):
        out, s, counts = timed_request(captured, vols)
        cap_s.append(s)
        launches.append(counts)
        equal.append(same_bits(out, want))
        _, s, _ = timed_request(eager, vols)
        eager_s.append(s)
    row = {"first_s": first_s, "p50_s": pct(cap_s, 0.5), "p90_s": pct(cap_s, 0.9),
           "times_s": cap_s, "eager_p50_s": pct(eager_s, 0.5), "eager_p90_s": pct(eager_s, 0.9),
           "eager_times_s": eager_s, "equal": all(equal), "eager_launches": eager_launches,
           "credited_per_request": launches[-1],
           "peak_gib": peak_gib, "held_gib": held_gib, "pool_gib": pool_gib,
           "captures": [s.captures for s in captured.stages]}
    log(f"captured {label}: first call {first_s} s (capture included), {n} requests p50 "
        f"{row['p50_s']} s, p90 {row['p90_s']} s; eager p50 {row['eager_p50_s']} s, p90 "
        f"{row['eager_p90_s']} s (interleaved); equal to eager bit for bit: {row['equal']}; "
        f"eager launches per request {eager_launches}, credited to each replay "
        f"{row['credited_per_request']}; "
        f"peak memory of the first call {peak_gib:.2f} GiB, held after it {held_gib:.2f} GiB, "
        f"reserved by the graphs {pool_gib:.2f} GiB; "
        f"captures {row['captures']}")
    if not row["equal"]:
        raise AssertionError(f"captured {label}: not equal to eager: {row}")
    return row, want


PROFILE_GROUPS = {"attention": "K1 attention", "instance_norm": "K2 instance norm",
                  "conv3d_k3": "K3 conv3d_k3"}


def profiled_pair(label, captured, eager, vols, counted):
    """One eager and one replayed request under the profiler: the K1, K2
    and K3 kernels the profiler sees in each, which must equal ``counted``
    (the launches an eager request counts where the wrappers launch), and
    the device's idle share."""
    prof = {"eager": profiled(lambda: eager(*vols), f"eager {label}", settle=True),
            "captured": profiled(lambda: captured(*vols), f"replayed {label}", settle=True)}
    if any(p is None for p in prof.values()):
        raise AssertionError(f"captured {label}: the profiler reported no device time")
    groups = {k: {name: p["groups_launches"].get(g, 0) for name, g in PROFILE_GROUPS.items()}
              for k, p in prof.items()}
    log(f"captured {label}: kernels in the profile, eager {groups['eager']}, replayed "
        f"{groups['captured']}, launches an eager request counts {counted}; idle share eager "
        f"{prof['eager']['idle_share']:.3f}, replayed {prof['captured']['idle_share']:.3f}; "
        f"device busy eager {prof['eager']['busy_ms']:.2f} ms, replayed "
        f"{prof['captured']['busy_ms']:.2f} ms")
    if not (groups["captured"] == groups["eager"] == counted
            and counted["attention"] > 0 and counted["instance_norm"] > 0):
        raise AssertionError(f"captured {label}: kernels in the replay {groups}, counted "
                             f"{counted}")
    return {"groups_launches": groups, "idle_share": {k: p["idle_share"] for k, p in prof.items()},
            "busy_ms": {k: p["busy_ms"] for k, p in prof.items()},
            "wall_ms": {k: p["wall_ms"] for k, p in prof.items()}}


def captured_cli(dev, root) -> dict:
    """infer --serve-dtype bfloat16 from the trainer phase's slots (no slot
    of its own): it must capture stage1 and stage2, and its NIfTI equal the
    captured cascade's and the eager cascade's from the same weights."""
    from dose_prediction_tpu_torch.infer import aot

    cohort, work = Path(root), Path(root) / "trainer"
    seg_ck, dose_ck = work / "transeg" / "last.pt", work / "pyfer" / "last.pt"
    if not (seg_ck.is_file() and dose_ck.is_file()):
        raise AssertionError(f"captured: the trainer phase's slots are gone: {seg_ck}, {dose_ck}")
    out = work / "infer_captured.nii.gz"
    captured, capture = [], aot.LazyAOTStage._capture

    def record(stage, *args):
        captured.append(stage.name)
        return capture(stage, *args)

    t0 = time.perf_counter()
    with mock.patch.object(aot.LazyAOTStage, "_capture", record):
        rc, _, text = cli("infer", "--patient", cohort / "pt_3", "--seg-ckpt", seg_ck,
                          "--dose-ckpt", dose_ck, "--out", out, "--serve-dtype", "bfloat16")
    seconds = time.perf_counter() - t0
    free_memory()
    if rc != 0:
        raise AssertionError(f"captured: infer returned {rc}:\n{text[-2000:]}")
    row = {"s": seconds, "captured_stages": captured,
           "equal_captured": same_nifti_as_cascade(dev, out, cohort / "pt_3", seg_ck, dose_ck,
                                                   "sliding", True, aot=True),
           "equal_eager": same_nifti_as_cascade(dev, out, cohort / "pt_3", seg_ck, dose_ck,
                                                "sliding", True)}
    out.unlink()
    log(f"captured: infer --serve-dtype bfloat16 in {seconds:.1f} s, stages captured "
        f"{captured}; NIfTI equal to the captured cascade's {row['equal_captured']}, to the "
        f"eager cascade's {row['equal_eager']}")
    if not (captured == ["stage1", "stage2"] and row["equal_captured"] and row["equal_eager"]):
        raise AssertionError(f"captured: infer check failed: {row}")
    return row


def captured_doctor(dev) -> dict:
    """doctor --probe --json --strict in a subprocess: exit 0, the card named,
    capability 9.0, the probe's K1 launched and equal to its plain version."""
    repo = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dose_prediction_tpu_torch", "doctor",
                           "--probe", "--json", "--strict"], cwd=repo, capture_output=True,
                          text=True, timeout=600)
    seconds = time.perf_counter() - t0
    report = json.loads(proc.stdout) if proc.stdout.strip().startswith("{") else {}
    backend = report.get("backend", {})
    row = {"rc": proc.returncode, "s": seconds, "backend": backend,
           "versions": report.get("versions")}
    log(f"captured: doctor --probe --json --strict exited {proc.returncode} in {seconds:.1f} s: "
        f"backend {backend}; versions {row['versions']}")
    if not (proc.returncode == 0 and backend.get("device_name") == torch.cuda.get_device_name(0)
            and backend.get("capability") == [9, 0] and backend.get("k1_s") is not None
            and backend.get("k1_max_abs_err", 1.0) <= 2.0 ** -6 * 4):
        lines = subprocess.run([sys.executable, "-m", "dose_prediction_tpu_torch", "doctor"],
                               cwd=repo, capture_output=True, text=True, timeout=600).stdout
        raise AssertionError(f"captured: doctor check failed: {row}\n{lines}\n"
                             f"{proc.stderr[-2000:]}")
    return row


def phase_captured(dev, root, serve_k3) -> dict:
    """Phase 24: the captured serve path (infer/aot.py) at full width in
    bfloat16 against the eager path, on the same seeded weights and volumes
    as the serve phases: sliding through make_cascade_fn(aot=True), the
    kernels in a replayed request's profile, two requests' outputs not
    aliased, the K3 routing (a recapture, K3 in the replay's profile),
    dense, ten requests through StreamingCascade, the CLI's infer and
    doctor."""
    from dose_prediction_tpu_torch.infer.cascade import make_cascade_fn
    from dose_prediction_tpu_torch.infer.pipeline import StreamingCascade

    smi = nvidia_smi()
    seg, dose = seeded_models(dev)
    sv, dv = seg.state_dict(), dose.state_dict()
    geometry = dict(roi_size=SEG_CROP, sw_batch_size=8, overlap=0.25, dose_scale=70.0)
    vols = seeded_volumes(dev, torch.bfloat16)
    eager = make_cascade_fn(seg, sv, dose, dv, **geometry)
    row = {}
    aot_run = make_cascade_fn(seg, sv, dose, dv, aot=True, **geometry)
    row["sliding_aot"], want = captured_vs_eager("sliding aot", aot_run, eager, vols, 10)
    row["sliding_profile"] = profiled_pair("sliding request", aot_run, eager, vols,
                                           row["sliding_aot"]["eager_launches"])

    # outputs not aliased: a second request with other inputs after the first
    other = tuple(torch.roll(v, shifts=17, dims=1) for v in vols)
    a = aot_run(*vols)
    b = aot_run(*other)
    torch.cuda.synchronize()
    row["not_aliased"] = same_bits(a, want) and same_bits(b, eager(*other)) \
        and not same_bits(a, b)
    log(f"captured: two requests with different inputs, both outputs intact and each equal to "
        f"eager: {row['not_aliased']}")
    del a, b

    # the K3 routing patched between requests: a recapture, K3 in the replay
    with k3_routing(True):
        row["routed"], _ = captured_vs_eager("sliding aot, K3 routing on", aot_run, eager, vols, 3)
        row["routed_profile"] = profiled_pair("sliding request, K3 routing on", aot_run, eager,
                                              vols, row["routed"]["eager_launches"])
    k3_per_request = serve_k3["launches"]["conv3d_k3"] // 3
    replayed_k3 = row["routed_profile"]["groups_launches"]["captured"]["conv3d_k3"]
    if not (row["routed"]["captures"] == [2, 2] and replayed_k3 == k3_per_request):
        raise AssertionError(f"captured: routing did not recapture, or the replay ran K3 "
                             f"{replayed_k3} times against serve_k3's {k3_per_request}: "
                             f"{row['routed']}")
    del aot_run
    free_memory()

    dense_eager = make_cascade_fn(dense_seg(dev), sv, dose, dv, seg_mode="dense",
                                  dose_scale=70.0)
    dense_aot = make_cascade_fn(dense_seg(dev), sv, dose, dv, seg_mode="dense",
                                dose_scale=70.0, aot=True)
    row["dense_aot"], _ = captured_vs_eager("dense aot", dense_aot, dense_eager, vols, 5)
    row["dense_profile"] = profiled_pair("dense request", dense_aot, dense_eager, vols,
                                         row["dense_aot"]["eager_launches"])
    del dense_aot, dense_eager
    free_memory()

    # StreamingCascade on the one card: ten requests over two input sets
    pipe = StreamingCascade(seg, sv, dose, dv, **geometry)
    inputs = [vols, other]
    wants = [want, eager(*other)]
    requests = [inputs[i % 2] for i in range(10)]
    pipe.run_one(*vols)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for out in pipe.run_stream(requests):
        torch.cuda.synchronize()
        outs.append(out)
    seconds = time.perf_counter() - t0
    row["streaming"] = {"requests": 10, "s": seconds, "volumes_per_sec": 10 / seconds,
                        "equal": all(same_bits(o, wants[i % 2]) for i, o in enumerate(outs))}
    log(f"captured: StreamingCascade.run_stream, 10 requests on the one card in {seconds} s, "
        f"{10 / seconds} volumes/s; each equal to make_cascade_fn's: "
        f"{row['streaming']['equal']}")
    del pipe, outs, wants, want
    free_memory()
    if not (row["not_aliased"] and row["streaming"]["equal"]):
        raise AssertionError(f"captured: aliasing or streaming check failed: {row}")

    row["cli"] = captured_cli(dev, root)
    row["doctor"] = captured_doctor(dev)
    log(f"captured: sliding p50 aot {row['sliding_aot']['p50_s']} s, eager "
        f"{row['sliding_aot']['eager_p50_s']} s; dense p50 aot {row['dense_aot']['p50_s']} s, "
        f"eager {row['dense_aot']['eager_p50_s']} s; peak memory of the first aot call sliding "
        f"{row['sliding_aot']['peak_gib']:.2f} GiB, dense {row['dense_aot']['peak_gib']:.2f} "
        f"GiB; reserved by the graphs, sliding {row['sliding_aot']['pool_gib']:.2f} GiB, dense "
        f"{row['dense_aot']['pool_gib']:.2f} GiB; on {smi}")
    return row


# train_captured: the calls of each step compared (eager twice, captured once)
CAPTURED_TRAIN_CALLS = 6


def seeded_packed_batch(dev):
    """A fixed 128³ batch in the packed feed's wire format: bf16 CT and dose,
    the PTV × 70 as uint8, seven OAR bits and the possible-dose bit, and one
    augmentation (shift, flips, rot90) of AUGMENT_DECISIONS."""
    g = torch.Generator(dev).manual_seed(SEED + 8)
    shape = (1, 128, 128, 128)
    mask = (torch.rand(shape, generator=g, device=dev) < 0.6).to(torch.uint8)
    oars = torch.randint(0, 128, shape, generator=g, device=dev).to(torch.uint8)
    shift, flip, rot_k = AUGMENT_DECISIONS[1]
    return {"ct": torch.randn(shape, generator=g, device=dev).to(torch.bfloat16),
            "dose": (torch.rand(shape, generator=g, device=dev) * mask).to(torch.bfloat16),
            "ptv": (torch.rand(shape, generator=g, device=dev) < 0.05).to(torch.uint8) * 70,
            "mask_bits": oars | (mask << 7),
            "shift": torch.tensor([shift], dtype=torch.float32, device=dev),
            "flip": torch.tensor([flip], dtype=torch.int32, device=dev),
            "rot_k": torch.tensor([rot_k], dtype=torch.int32, device=dev)}


def captured_train_steps():
    """(label, make(dev) -> (model, step, state), batch(dev), K3 routing):
    train pyfer's step (float32, adam8bit, net_A frozen) on a float32 and on
    a packed batch, phase 12's bf16 AdamW step routed and not, phase 14's
    TranSeg step and phase 16's grad_accum=2 step."""
    pyfer_cli = lambda dev: make_trainer(dev, kind="adam8bit", packed=True)  # noqa: E731
    bf16 = lambda dev: seeded_batch(dev, torch.bfloat16)  # noqa: E731
    return [("pyfer float32 adam8bit", pyfer_cli, lambda dev: seeded_batch(dev, torch.float32),
             False),
            ("pyfer packed adam8bit", pyfer_cli, seeded_packed_batch, False),
            ("pyfer bf16 adamw, K3 routing on", make_trainer, bf16, True),
            ("pyfer bf16 adamw", make_trainer, bf16, False),
            ("transeg bf16, K3 routing on", make_seg_trainer,
             lambda dev: seeded_seg_batch(dev, torch.bfloat16), True),
            ("pyfer bf16 grad_accum=2, K3 routing on",
             lambda dev: make_trainer(dev, grad_accum=2), bf16, True)]


def leaf_max_abs(a, b) -> list:
    """max |x − y| of each pair of tensors, read in one synchronisation."""
    return torch.stack([(x - y).abs().max() for x, y in zip(a, b)]).tolist()


def captured_step_parity(losses, params, first) -> dict:
    """One call's captured run (c) against the first eager run (a), the
    second (b) giving eager's own spread. Where a and b are equal bit for
    bit, c must be too. Otherwise (cuDNN's weight gradients and the
    trilinear backward may add with atomics) check_step_parity's rule,
    applied to each parameter's displacement from the initial weights
    ``first``: within max(1e-3, 2 × the eager runs' worst relative
    departure) × that displacement's largest |value|, floor 2e-6 × the
    largest; the loss within max(1e-5, 2 × the eager runs' relative
    difference) of the nearer eager run's (one scalar's spread is one
    sample, where a leaf's limit is the worst of every leaf's)."""
    (la, lb, lc), (pa, pb, pc) = losses, params
    if la == lb and all(torch.equal(x, y) for x, y in zip(pa, pb)):
        equal = lc == la and all(torch.equal(x, z) for x, z in zip(pa, pc))
        return {"rule": "bit for bit", "ok": equal}
    scale = [max(d, 1e-30) for d in leaf_max_abs(pa, first)]
    spread, err = leaf_max_abs(pb, pa), leaf_max_abs(pc, pa)
    noise = max(d / s for d, s in zip(spread, scale))
    floor = 2e-6 * max(scale)
    worst = max(e / max(max(1e-3, 2 * noise) * s, floor) for e, s in zip(err, scale))
    loss_rel, loss_spread = min(abs(lc - la), abs(lc - lb)) / abs(la), abs(lb - la) / abs(la)
    return {"rule": "eager spread", "ok": worst <= 1 and loss_rel <= max(1e-5, 2 * loss_spread),
            "worst_leaf_ratio": worst, "eager_departure": noise, "loss_rel": loss_rel,
            "eager_loss_rel": loss_spread}


def captured_train_run(dev, label, make, batch, route_k3) -> dict:
    """CAPTURED_TRAIN_CALLS calls of one step in two eager runs and through a
    LazyTrainStage, in turns, from the same seeded weights on the same batch:
    each call's seconds, loss, credited launches and captured_step_parity;
    the first captured call's seconds and peak memory above what was
    allocated before it, the memory the graphs keep reserved; then
    profiled_pair: one eager and one replayed call under the profiler,
    whose K1, K2 and K3 kernels must equal the launches an eager call
    counts (K2's two-kernel calls twice)."""
    from dose_prediction_tpu_torch.infer.aot import LazyTrainStage

    runs = {name: make(dev) for name in ("eager_a", "eager_b", "captured")}
    stage = LazyTrainStage(f"train:{label}", runs["captured"][1])
    steps = {"eager_a": runs["eager_a"][1], "eager_b": runs["eager_b"][1], "captured": stage}
    states = {name: run[2] for name, run in runs.items()}
    params = [list(run[0].parameters()) for run in runs.values()]
    first = [p.detach().clone() for p in params[0]]
    calls = {name: [] for name in runs}
    checks = []
    with torch_default_tf32(), k3_routing(route_k3):
        for i in range(CAPTURED_TRAIN_CALLS):
            for name, step in steps.items():
                if name == "captured" and i == 0:
                    free_memory()
                    base, base_reserved = torch.cuda.memory_allocated(), \
                        torch.cuda.memory_reserved()
                    torch.cuda.reset_peak_memory_stats()
                captures = stage.captures
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.perf_counter()
                states[name], loss = step(states[name], batch)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                if name == "captured" and i == 0:
                    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
                calls[name].append({
                    "s": seconds, "loss": float(loss), "launches": read_counts(),
                    "two_kernel": kernel_wrappers()["instance_norm"].two_kernel_launches,
                    "captured": stage.captures > captures})
            checks.append(captured_step_parity([calls[n][-1]["loss"] for n in runs], params,
                                               first))
        free_memory()
        pool_gib = (torch.cuda.memory_reserved() - base_reserved) / 2 ** 30

        def call(name):
            def run():
                states[name], _ = steps[name](states[name], batch)
            return run

        eager = calls["eager_a"][-1]
        counted = {"attention": eager["launches"]["attention"],
                   "instance_norm": eager["launches"]["instance_norm"] + eager["two_kernel"],
                   "conv3d_k3": eager["launches"]["conv3d_k3"]}
        prof = profiled_pair(f"train step {label}", call("captured"), call("eager_a"), (),
                             counted)
    replayed = [c["s"] for c in calls["captured"] if not c["captured"]]
    eager_s = [c["s"] for n in ("eager_a", "eager_b") for c in calls[n][1:]]
    row = {"first_s": calls["captured"][0]["s"], "captures": stage.captures,
           "p50_s": pct(replayed, 0.5), "times_s": [c["s"] for c in calls["captured"]],
           "eager_p50_s": pct(eager_s, 0.5), "eager_times_s": eager_s,
           "losses": {n: [c["loss"] for c in calls[n]] for n in runs},
           "checks": checks, "peak_gib": peak_gib, "pool_gib": pool_gib,
           "credited": calls["captured"][-1]["launches"], "eager_launches": eager["launches"],
           "groups_launches": prof["groups_launches"], "idle_share": prof["idle_share"],
           "busy_ms": prof["busy_ms"]}
    rules = [c["rule"] + (" ok" if c["ok"] else " FAILED") for c in checks]
    log(f"train_captured {label}: first call {row['first_s']} s (warm-up and capture), "
        f"{row['captures']} capture(s); replayed p50 {row['p50_s']} s over {len(replayed)} "
        f"calls {replayed}; eager p50 {row['eager_p50_s']} s over {eager_s}; losses "
        f"{row['losses']}; per call {rules}, worst "
        f"{[round(c.get('worst_leaf_ratio', 0.0), 4) for c in checks]} of the limit; "
        f"credited launches {row['credited']}; peak memory of the first captured call "
        f"{peak_gib:.2f} GiB, reserved by the graphs {pool_gib:.2f} GiB")
    finite = all(math.isfinite(x) for v in row["losses"].values() for x in v)
    routed = (counted["conv3d_k3"] > 0) == route_k3
    if not (finite and routed and all(c["ok"] for c in checks)
            and row["credited"] == eager["launches"]):
        raise AssertionError(f"train_captured {label} check failed: {row}")
    return row


def phase_train_captured(dev) -> dict:
    """Phase 25: whole train steps captured as CUDA graphs
    (infer/aot.py::LazyTrainStage) at full width against their eager runs,
    captured_train_run for each of captured_train_steps(); no slot is
    written."""
    smi = nvidia_smi()
    rows = {}
    for label, make, batch, route_k3 in captured_train_steps():
        rows[label] = captured_train_run(dev, label, make, batch(dev), route_k3)
        free_memory()
    log("train_captured: replayed p50 against eager, " + "; ".join(
        f"{k} {v['p50_s']} s ({v['eager_p50_s']} s eager)" for k, v in rows.items())
        + f"; on {smi}")
    return rows


MESH_STEPS = 3                  # part (a): steps of each trainer
MESH_WORKER_STEPS = 2           # part (b): steps of each run in the workers
MESH_NOISE_RUNS = 3
MESH_WORKER_TIMEOUT_S = 600
# part (b)'s two meshes: (tag, mesh_shape, global batch); part (c)'s
# TranSeg takes the same two
MESH_RUNS = (("data", {"data": 2}, 2), ("model", {"model": 2}, 1))
SEG_MESH_STEPS = 2              # part (c): steps of each TranSeg run in the workers
SEG_VAL_SW_BATCH = 8            # part (c): the one-process sweep the sharded one is held to


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_trainer(dev, root, tag, mesh_shape, batch, steps, kind="adamw"):
    """A PyferTrainer at full width (phase 12's seeded weights, the
    optimizer ``kind`` at the trainer's defaults, net_A frozen, the float32
    feed) on ``mesh_shape``, or without a mesh and eager (its step not
    captured) for None."""
    from dose_prediction_tpu_torch.train import trainers as T

    cfg = T.TrainConfig(batch_size=batch, mesh_shape=mesh_shape, max_epochs=1,
                        max_steps=steps, check_val=1000, device=str(dev), optimizer=kind,
                        ckpt_dir=str(Path(root) / "mesh" / tag / "ck"),
                        log_dir=str(Path(root) / "mesh" / tag / "log"))
    with mock.patch.dict(os.environ, {"DPT_NO_AOT": "1"}):
        return T.PyferTrainer(cfg, model=seeded_pyfer(dev), example_shape=(1,) + DATA_SHAPE + (9,))


def mesh_feed_steps(tr, ds, n, reverse_rows=False) -> list:
    """``n`` steps of ``tr``'s own step on the first batches of its epoch-0
    feed, as fit feeds them (this process's rows on a 'data' axis), or, in
    one process, with each batch's rows in reverse order (``reverse_rows``):
    each step's seconds to a synchronisation, loss and kernel launches; for
    the first step also forward_probe's output before it and the gradients
    of the whole leaves after it (summed over a 'data' axis, gathered over
    'model'; a collective on a mesh)."""
    feed = tr.batches(ds, 0)
    out, probe = [], None
    with contextlib.closing(feed):
        for _, batch in zip(range(n), feed):
            if reverse_rows:
                batch = {k: v.flip(0) for k, v in batch.items()}
            if probe is None:
                probe = forward_probe(tr.model, batch)
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.state, loss = tr.train_step(tr.state, batch)
            torch.cuda.synchronize()
            out.append({"s": time.perf_counter() - t0, "loss": float(loss),
                        "launches": read_counts()})
            if len(out) == 1:
                out[0]["probe"] = probe
                plan = tr.state.plan
                out[0]["grads"] = {
                    n: (p.grad if plan is None or plan.shard_of(p) is None
                        else plan.shard_of(p).gather(p.grad, plan.mesh)).detach().clone()
                    for n, p in tr.model.named_parameters() if p.grad is not None}
    return out


def forward_probe(model, batch) -> torch.Tensor:
    """The full-resolution dose (DOSE-PYFER) or the logits (TranSeg) of a
    train-mode forward of ``batch`` (NCDHW, float32), the model's buffers
    left as they were."""
    from dose_prediction_tpu_torch.train import steps

    model.train()
    with torch.no_grad(), steps.buffers_kept(model):
        if "ct" in batch:
            return model(steps.to_ncdhw(batch["ct"])).float()
        return model(steps.to_ncdhw(batch["input"]), stop_gradient_a=True)[1][0].float()


def trainable(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}


def mesh_hold(first, ref, noisy, got, ref_losses, noisy_losses, got_losses, steps) -> dict:
    """A mesh run (``got``) against the one-process run of the same global
    batch (``ref``) by the noise-run rule of captured_step_parity, the
    spread taken from the noise runs, each a one-process run (through the
    plain versions with noise on their outputs as large as the mesh's
    forward gap from the one-process run, at least TRAIN_PARITY_NOISE; for a
    batch of several rows, the rows reversed and the convolutions row by
    row: mesh_witnesses): each leaf's
    displacement from ``first`` within max(1e-3, 2 × the worst relative
    departure of a noise run) × its largest |value|, floor 2e-6 × the
    largest; the conv biases that feed a norm (zero gradient in exact
    arithmetic) moved by at most 2 × lr a step on both sides; the first
    step's loss within 1e-5, the later ones within max(1e-5, 2 × the noise
    runs' relative departure)."""
    import re

    zero = re.compile(ZERO_GRAD_BIAS)
    names = [n for n in ref if not zero.search(n)]
    zeros = [n for n in ref if zero.search(n)]
    scale = dict(zip(names, (max(d, 1e-30) for d in leaf_max_abs([ref[n] for n in names],
                                                                  [first[n] for n in names]))))
    departures = [max(d / scale[n] for n, d in zip(names, leaf_max_abs(
        [run[n] for n in names], [ref[n] for n in names]))) for run in noisy]
    noise = max(departures)
    floor = 2e-6 * max(scale.values())
    err = dict(zip(names, leaf_max_abs([got[n] for n in names], [ref[n] for n in names])))
    ratio = {n: err[n] / max(max(1e-3, 2 * noise) * scale[n], floor) for n in names}
    worst = max(names, key=ratio.get)
    own = {n: max(d / scale[n] for d in leaf_max_abs([run[n] for run in noisy],
                                                     [ref[n] for _ in noisy])) for n in names}
    own_ratio = {n: err[n] / max(max(1e-3, 2 * own[n]) * scale[n], floor) for n in names}
    worst_own = max(names, key=own_ratio.get)
    moved = max(leaf_max_abs([t[n] for t in (got, ref) for n in zeros],
                             [first[n] for _ in (got, ref) for n in zeros]), default=0.0)
    loss_rel = [abs(g - r) / abs(r) for g, r in zip(got_losses, ref_losses)]
    loss_noise = [max(abs(x[i] - ref_losses[i]) / abs(ref_losses[i]) for x in noisy_losses)
                  for i in range(len(ref_losses))]
    loss_ok = loss_rel[0] <= 1e-5 and all(
        r <= max(1e-5, 2 * nz) for r, nz in zip(loss_rel[1:], loss_noise[1:]))
    return {"ok": ratio[worst] <= 1 and moved <= 2 * TRAIN_LR * steps and loss_ok,
            "worst_leaf_ratio": ratio[worst], "worst_leaf": worst, "noise_departure": noise,
            "noise_departures": departures,
            "worst_per_leaf_ratio": own_ratio[worst_own], "worst_per_leaf_leaf": worst_own,
            "zero_grad_biases": len(zeros), "zero_grad_moved": moved,
            "loss_rel": loss_rel, "loss_noise_rel": loss_noise,
            "loss_rel_by_run": [[abs(x[i] - ref_losses[i]) / abs(ref_losses[i])
                                 for i in range(len(ref_losses))] for x in noisy_losses],
            "leaves": len(names)}


def mesh_grad_hold(ref, noisy, got) -> dict:
    """The first step's gradients of a mesh run (``got``) against the
    one-process run's (``ref``) by check_step_parity's per-leaf rule: each
    leaf within max(1e-3, 2 × its own largest noise-run departure) × its
    max |g|, floor 2e-6 × the largest |g|; the conv biases that feed a norm
    below 1e-5 × the largest on both sides."""
    import re

    zero = re.compile(ZERO_GRAD_BIAS)
    names = [n for n in ref if not zero.search(n)]
    zeros = [n for n in ref if zero.search(n)]
    scale = dict(zip(names, (max(v, 1e-30) for v in leaf_max_abs(
        [ref[n] for n in names], [torch.zeros_like(ref[n]) for n in names]))))
    g_max = max(scale.values())
    own = {n: 0.0 for n in names}
    for run in noisy:
        for n, d in zip(names, leaf_max_abs([run[n] for n in names], [ref[n] for n in names])):
            own[n] = max(own[n], d / scale[n])
    err = dict(zip(names, leaf_max_abs([got[n] for n in names], [ref[n] for n in names])))
    ratio = {n: err[n] / max(max(1e-3, 2 * own[n]) * scale[n], 2e-6 * g_max) for n in names}
    worst = max(names, key=ratio.get)
    biggest_zero = max(leaf_max_abs([t[n] for t in (got, ref) for n in zeros],
                                    [torch.zeros_like(ref[n]) for _ in (got, ref)
                                     for n in zeros]), default=0.0)
    return {"ok": ratio[worst] <= 1 and biggest_zero <= 1e-5 * g_max and set(got) == set(ref),
            "worst_per_leaf_ratio": ratio[worst], "worst_leaf": worst,
            "worst_rel_err": err[worst] / scale[worst], "its_noise": own[worst],
            "over_1": sum(r > 1 for r in ratio.values()), "leaves": len(names),
            "zero_grad_largest": biggest_zero / g_max}


def leaves_digest(leaves: dict) -> str:
    """A digest of each leaf's float64 sum, in name order: equal on two
    ranks whose leaves are equal."""
    import hashlib

    sums = torch.stack([leaves[n].double().sum() for n in sorted(leaves)]).tolist()
    return hashlib.sha256(json.dumps(sums).encode()).hexdigest()[:16]


def replicated_broadcast(tr) -> dict:
    """What the 'model' axis's broadcast of the replicated leaves'
    gradients (train/state.py::_replicate_over_model) costs a step: its
    bytes, and the seconds of three broadcasts of the last step's
    gradients, each to a synchronisation (a collective: every rank of the
    axis calls it)."""
    import torch.distributed as dist

    plan = tr.state.plan
    flat = torch.cat([p.grad.reshape(-1) for p in tr.model.parameters()
                      if p.grad is not None and plan.shard_of(p) is None])
    group, times = plan.mesh.group("model"), []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"bytes": flat.numel() * flat.element_size(), "s": times}


@contextlib.contextmanager
def row_convs():
    """Every convolution evaluated one row of the batch at a time, in one
    process: each weight gradient is then a sum over the rows, as a 'data'
    axis sums it over its ranks, where one call sums the whole batch in
    cuDNN's own order."""
    import torch.nn.functional as F

    def by_row(conv):
        return lambda x, w, *a, **k: torch.cat([conv(x[i:i + 1], w, *a, **k)
                                                for i in range(x.shape[0])])

    with mock.patch.object(F, "conv3d", by_row(F.conv3d)), \
            mock.patch.object(F, "conv_transpose3d", by_row(F.conv_transpose3d)):
        yield


def mesh_witnesses(batch, amplitude, kernels, dev) -> list:
    """The one-process runs whose departures from the one-process reference
    size a mesh hold's noise, as (name, context, rows reversed):
    MESH_NOISE_RUNS runs through the plain versions with noise of
    ``amplitude`` on their outputs and, for a batch of several rows, one with
    the rows reversed and one with each convolution evaluated row by row
    (row_convs): the order and the split of the batch's sums are what a
    'data' axis changes. None runs mesh code, so a fault of the mesh cannot
    hide in them."""
    k1, k2, k3 = kernels
    out = [(f"noise{i}", noisy_plain_kernels(k1, k2, k3, amplitude, SEED + i, dev), False)
           for i in range(MESH_NOISE_RUNS)]
    if batch > 1:
        out += [("reversed", contextlib.nullcontext(), True),
                ("row_convs", row_convs(), False)]
    return out


def seg_mesh_trainer(dev, root, tag, mesh_shape, batch, steps):
    """A TranSegTrainer at full width (seeded_seg_model's weights, AdamW at
    the trainer's defaults, SEG_CROP crops, the float32 feed) on
    ``mesh_shape``, or without a mesh and eager for None."""
    from dose_prediction_tpu_torch.train import trainers as T

    cfg = T.TrainConfig(batch_size=batch, mesh_shape=mesh_shape, max_epochs=1,
                        max_steps=steps, check_val=1000, device=str(dev),
                        ckpt_dir=str(Path(root) / "mesh" / tag / "ck"),
                        log_dir=str(Path(root) / "mesh" / tag / "log"))
    with mock.patch.dict(os.environ, {"DPT_NO_AOT": "1"}):
        return T.TranSegTrainer(cfg, model=seeded_seg_model(dev), crop=SEG_CROP)


def mesh_runs(dev, args, ds, make, steps, prefix, after=None):
    """This rank's share of each mesh of MESH_RUNS: the trainer ``make``
    builds on it, ``steps`` steps of its own feed (mesh_feed_steps), then
    ``after(tag, trainer, whole state)``'s readings. Returns (readings by
    mesh, (whole trainable leaves, losses, first gradients, first probe) by
    mesh)."""
    rank, out, finals = args["rank"], {}, {}
    for tag, shape, batch in MESH_RUNS:
        free_memory()
        torch.cuda.reset_peak_memory_stats(dev)
        tr = make(dev, args["root"], f"{prefix}{tag}{rank}", shape, batch, steps)
        rows = mesh_feed_steps(tr, ds, steps)
        whole = tr.state.plan.whole_model_state(tr.model)
        finals[tag] = ({n: whole[n].clone() for n in trainable(tr.model)},
                       [r["loss"] for r in rows], rows[0].pop("grads"), rows[0].pop("probe"))
        out[tag] = {"steps_s": [r["s"] for r in rows], "losses": finals[tag][1],
                    "launches": rows[-1]["launches"],
                    "split_leaves": len(tr.state.plan.shards),
                    "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                    "replicas": leaves_digest(finals[tag][0])}
        if shape.get("model", 1) > 1:
            out[tag]["broadcast"] = replicated_broadcast(tr)
        if after is not None:
            out[tag].update(after(tag, tr, whole))
        del tr, whole
    return out, finals


def mesh_hold_rank(dev, args, ds, make, steps, prefix, finals, kernels) -> dict:
    """This rank's mesh of MESH_RUNS (rank 0 the 'data' mesh, rank 1 the
    'model' mesh) against the one-process run of the same global batch, its
    noise from mesh_witnesses: the parameters and losses after the steps
    (mesh_hold) and the first step's gradients (mesh_grad_hold)."""
    rank = args["rank"]
    tag, _, batch = MESH_RUNS[rank]

    def one_process(name, ctx=contextlib.nullcontext(), reverse_rows=False):
        free_memory()
        tr = make(dev, args["root"], f"{prefix}{tag}{rank}_{name}", None, batch, steps)
        first = trainable(tr.model)
        with ctx:
            rows = mesh_feed_steps(tr, ds, steps, reverse_rows=reverse_rows)
        return first, (trainable(tr.model), [r["loss"] for r in rows], rows[0].pop("grads"),
                       rows[0].pop("probe"))

    first, (ref, ref_losses, ref_grads, probe) = one_process("ref")
    # the noise runs' amplitude: the mesh's own forward gap from the
    # one-process run at the first weights (this rank's rows of the global
    # batch), at least TRAIN_PARITY_NOISE, as tests/test_torch_port_trainers.py
    # sizes its noise runs
    mine = finals[tag][3]
    theirs = probe[rank if tag == "data" else 0:][:mine.shape[0]]
    gap = float((mine - theirs).abs().max() / theirs.abs().max())
    amplitude = max(TRAIN_PARITY_NOISE, gap)
    runs = {name: one_process(name, ctx, reverse)[1]
            for name, ctx, reverse in mesh_witnesses(batch, amplitude, kernels, dev)}
    noise = list(runs.values())
    return {"hold": {"mesh": tag, "forward_gap": gap, "noise_amplitude": amplitude,
                     "noise_runs": list(runs),
                     **mesh_hold(first, ref, [r[0] for r in noise], finals[tag][0], ref_losses,
                                 [r[1] for r in noise], finals[tag][1], steps)},
            "grads": mesh_grad_hold(ref_grads, [r[2] for r in noise], finals[tag][2])}


def seg_sharded_validation(tr, patient) -> dict:
    """TranSegTrainer.validate of one patient on the trainer's 'data' mesh
    (the window batch split over the ranks), to a synchronisation: its
    seconds, metrics and kernel launches, and the sweep's logits (caught at
    ``sliding_logits``) with a digest of their bytes."""
    import hashlib

    caught, sliding = [], tr.sliding_logits

    def keep(volume, **kwargs):
        caught.append(sliding(volume, **kwargs))
        return caught[-1]

    tr.sliding_logits = keep
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dice, hd95, val_loss = tr.validate(patient, sw_batch_size=SEG_VAL_SW_BATCH)
    torch.cuda.synchronize()
    row = {"s": time.perf_counter() - t0, "dice": dice, "hd95": hd95, "val_loss": val_loss,
           "launches": read_counts(), "vit_layers": len(tr.model.vit.blocks),
           "logits": caught[0]}
    row["logits_digest"] = hashlib.sha256(caught[0].cpu().numpy().tobytes()).hexdigest()[:16]
    return row


def seg_val_hold(dev, state, patient, got) -> dict:
    """The sharded sweep's logits (``got``) against one process's
    sliding_window_inference at sw batch SEG_VAL_SW_BATCH, from the same
    weights and buffers (``state``): within max(2 × the one-process sweep's
    own departure at sw batch 4, the windows a rank predicts a call, and
    tolerance()). The grid needs no padding window, so both sweep the same
    windows."""
    from dose_prediction_tpu_torch.infer.sliding_window import (
        sliding_window_inference,
        window_grid,
    )

    model = seeded_seg_model(dev)
    model.load_state_dict(state)
    model.eval()
    ct = patient.patients[0].ct
    vol = torch.from_numpy(ct[None, None].astype("float32")).to(dev)
    with torch.no_grad():
        want, four = (sliding_window_inference(vol, model, roi_size=SEG_CROP, sw_batch_size=b,
                                               out_channels=8)
                      for b in (SEG_VAL_SW_BATCH, 4))
    err = (got - want).abs().max().item()
    own = (four - want).abs().max().item()
    limit = max(2 * own, tolerance(want))
    return {"ok": bool(torch.isfinite(got).all()) and err <= limit, "max_abs_err": err,
            "sw4_departure": own, "limit": limit, "shape": list(got.shape),
            "windows": len(window_grid(ct.shape, SEG_CROP))}


def mesh_worker(args_path: str) -> int:
    """One rank of parts (b) and (c) (``chip_smoke.py --mesh-worker
    args.json``): gloo on the one card; part (b), PyferTrainer on each mesh
    of MESH_RUNS for MESH_WORKER_STEPS steps, then this rank's share of the
    one-process references (mesh_hold_rank); part (c), TranSegTrainer on
    the same meshes for SEG_MESH_STEPS steps, the 'data' mesh then
    validating one 128³ patient with its window batch split over the ranks
    (rank 0 holds its logits against one process's sweep, seg_val_hold),
    then the one-process references. Prints one RESULT line."""
    import torch.distributed as dist

    args = json.loads(Path(args_path).read_text())
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from dose_prediction_tpu_torch.data.openkbp import OpenKBPDataset
    from dose_prediction_tpu_torch.kernels import attention as k1
    from dose_prediction_tpu_torch.kernels import conv3d as k3
    from dose_prediction_tpu_torch.kernels import cuda_lib
    from dose_prediction_tpu_torch.kernels import instance_norm as k2
    from dose_prediction_tpu_torch.parallel import multihost as MH

    # float32 parity: TF32 off; cuDNN at its defaults, as users train (the
    # 'model' axis's broadcast keeps the replicas in step whatever its
    # algorithms sum in)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rank = args["rank"]
    dev = MH.initialize(f"127.0.0.1:{args['port']}", 2, rank, device="cuda", backend="gloo")
    cuda_lib.library()
    ds = OpenKBPDataset(args["pattern"], keep_structures=True)
    kernels = (k1, k2, k3)
    out = {"rank": rank, "device": str(dev)}
    runs, finals = mesh_runs(dev, args, ds, mesh_trainer, MESH_WORKER_STEPS, "")
    out.update(runs)
    out.update(mesh_hold_rank(dev, args, ds, mesh_trainer, MESH_WORKER_STEPS, "", finals,
                              kernels))
    del finals
    patient, state = OpenKBPDataset(args["pattern"], size=1), {}

    def validate(tag, tr, whole):
        if tag != "data":
            return {}
        if rank == 0:
            state.update((k, v.clone()) for k, v in whole.items())
        return {"validate": seg_sharded_validation(tr, patient)}

    seg, finals = mesh_runs(dev, args, ds, seg_mesh_trainer, SEG_MESH_STEPS, "seg_", validate)
    logits = seg["data"]["validate"].pop("logits")
    if rank == 0:
        seg["val_hold"] = seg_val_hold(dev, state, patient, logits)
    del logits, state
    seg.update(mesh_hold_rank(dev, args, ds, seg_mesh_trainer, SEG_MESH_STEPS, "seg_", finals,
                              kernels))
    out["seg"] = seg
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def mesh_part_a(dev, data, root) -> dict:
    """Part (a): NCCL in this process, a world of one. PyferTrainer on
    {'data': 1, 'model': 1} with adam8bit (the CLI's optimizer, whose 1 GB
    slot is half AdamW's) fits MESH_STEPS steps of the data phase's cohort
    (its 'last' slot written as whole leaves, then removed) against the
    trainer without a mesh, eager, on the same seed and batches: bit for
    bit, or else within a second eager run's spread (captured_step_parity)."""
    import torch.distributed as dist

    from dose_prediction_tpu_torch.parallel import multihost as MH

    ds = data["dataset"]
    MH.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        with torch_default_tf32():
            ref = mesh_trainer(dev, root, "eager_a", None, 1, MESH_STEPS, "adam8bit")
            first = trainable(ref.model)
            ref_rows = mesh_feed_steps(ref, ds, MESH_STEPS)
            ref_params = list(trainable(ref.model).values())
            del ref
            free_memory()
            torch.cuda.reset_peak_memory_stats(dev)
            tr = mesh_trainer(dev, root, "nccl", {"data": 1, "model": 1}, 1, MESH_STEPS,
                              "adam8bit")
            step, rows = tr.train_step, []

            def timed(state, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = step(state, batch)
                torch.cuda.synchronize()
                rows.append({"s": time.perf_counter() - t0, "loss": float(loss)})
                return state, loss

            tr.train_step = timed
            zero_counts()
            tr.fit(ds, resume=False)
            launches = read_counts()
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            slot_gb = (Path(tr.cfg.ckpt_dir) / "last.pt").stat().st_size / 1e9
            params = list(trainable(tr.model).values())
            ref_loss = ref_rows[-1]["loss"]
            check = captured_step_parity([ref_loss, ref_loss, rows[-1]["loss"]],
                                         [ref_params, ref_params, params], list(first.values()))
            if not check["ok"]:
                # not bit-equal: a second eager run gives eager's own spread
                del tr
                free_memory()
                again = mesh_trainer(dev, root, "eager_b", None, 1, MESH_STEPS, "adam8bit")
                again_rows = mesh_feed_steps(again, ds, MESH_STEPS)
                check = captured_step_parity(
                    [ref_rows[-1]["loss"], again_rows[-1]["loss"], rows[-1]["loss"]],
                    [ref_params, list(trainable(again.model).values()), params],
                    list(first.values()))
                del again
    finally:
        dist.destroy_process_group()
        remove_work(root, "mesh")
    equal_losses = [r["loss"] for r in rows] == [r["loss"] for r in ref_rows]
    row = {"p50_s": pct([r["s"] for r in rows], 0.5), "steps_s": [r["s"] for r in rows],
           "eager_steps_s": [r["s"] for r in ref_rows], "losses": [r["loss"] for r in rows],
           "eager_losses": [r["loss"] for r in ref_rows], "losses_equal": equal_losses,
           "launches": launches, "peak_gib": peak, "slot_gb": slot_gb, "check": check}
    log(f"mesh (a) NCCL world of 1, mesh {{'data': 1, 'model': 1}}, adam8bit, float32 at TF32 "
        f"defaults: step p50 {row['p50_s']} s over {row['steps_s']} (eager without a mesh "
        f"{row['eager_steps_s']}); losses {row['losses']} against eager {row['eager_losses']} "
        f"(equal: {equal_losses}); parameters: {check}; K1/K2/K3 launches in the fit's "
        f"{MESH_STEPS} steps {launches}; peak {peak:.2f} GiB; slot {slot_gb:.2f} GB")
    if not (check["ok"] and launches["attention"] == 8 * MESH_STEPS
            and launches["instance_norm"] > 0):
        raise AssertionError(f"mesh (a) failed: {row}")
    return row


def mesh_workers(data, root) -> list:
    """Two worker processes on the one card (gloo on CUDA tensors; NCCL
    refuses two ranks on one device), each running mesh_worker; a worker's
    failure or hang fails the phase and kills the other. Returns each
    rank's RESULT."""
    port, procs = free_port(), []
    for rank in (0, 1):
        args = Path(root) / f"mesh_worker{rank}.json"
        args.write_text(json.dumps({"rank": rank, "port": port, "pattern": data["pattern"],
                                    "root": str(root)}))
        procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                       "--mesh-worker", str(args)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs, deadline = [], time.monotonic() + MESH_WORKER_TIMEOUT_S
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
            except subprocess.TimeoutExpired:
                raise AssertionError(f"mesh worker hung past {MESH_WORKER_TIMEOUT_S} s")
            if p.returncode != 0:
                raise AssertionError(f"mesh worker failed ({p.returncode}):\n{outs[-1][-6000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                tail = p.communicate()[0]
                print(tail[-6000:], flush=True)
    return [json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1][7:])
            for out in outs]


def mesh_ranks_hold(part, ranks) -> None:
    """Fail ``part`` unless each rank's hold and gradients are within their
    limits, both ranks' losses and whole leaves are equal after each mesh,
    and K1 and K2 launched on every rank on each mesh."""
    bad = [r["rank"] for r in ranks if not (r["hold"]["ok"] and r["grads"]["ok"])]
    same = all(ranks[0][t]["losses"] == ranks[1][t]["losses"]
               and ranks[0][t]["replicas"] == ranks[1][t]["replicas"] for t, _, _ in MESH_RUNS)
    launched = all(r[t]["launches"]["attention"] > 0 and r[t]["launches"]["instance_norm"] > 0
                   for r in ranks for t, _, _ in MESH_RUNS)
    if bad or not same or not launched:
        raise AssertionError(f"mesh {part} failed: ranks {bad} over their limits, losses and "
                             f"whole leaves equal across ranks {same}, K1 and K2 launched on "
                             f"every rank {launched}")


def mesh_log_ranks(part, model, ranks) -> None:
    for r in ranks:
        for tag, _, batch in MESH_RUNS:
            m = r[tag]
            log(f"mesh {part} rank {r['rank']} on {r['device']}, {model} on the {tag} mesh, "
                f"global batch {batch}: steps {m['steps_s']} s, losses {m['losses']}, K1/K2/K3 "
                f"launches a step {m['launches']}, {m['split_leaves']} split leaves, peak "
                f"{m['peak_gib']:.2f} GiB, whole leaves' digest {m['replicas']}"
                + (f", the replicated gradients' broadcast {m['broadcast']['bytes']} bytes a "
                   f"step, {m['broadcast']['s']} s" if "broadcast" in m else "")
                + " (two processes share the card: not a scaling figure)")
        log(f"mesh {part} rank {r['rank']}: parameters and losses after the steps "
            f"{r['hold']}; first step's gradients {r['grads']}")


def mesh_part_b(ranks) -> dict:
    """Part (b): PyferTrainer in the two workers (mesh_worker)."""
    mesh_log_ranks("(b)", "DOSE-PYFER", ranks)
    mesh_ranks_hold("(b)", ranks)
    return {"ranks": [{k: v for k, v in r.items() if k != "seg"} for r in ranks]}


def mesh_part_c(ranks) -> dict:
    """Part (c): TranSegTrainer in the two workers (mesh_worker): part (b)'s
    holds, and the sharded validation's: both ranks' logits equal, rank 0's
    within seg_val_hold's limit, K1 launched once a ViT layer on each rank
    (one predictor call of its windows) and K2 launched."""
    seg = [r["seg"] | {"rank": r["rank"], "device": r["device"]} for r in ranks]
    mesh_log_ranks("(c)", "TranSeg", seg)
    for r in seg:
        v = r["data"]["validate"]
        log(f"mesh (c) rank {r['rank']}: validate of one 128³ patient on the data mesh "
            f"(window batch split over the ranks) {v['s']:.3f} s, Dice {v['dice']}, HD95 "
            f"{v['hd95']}, val loss {v['val_loss']}, K1/K2/K3 launches {v['launches']}, "
            f"logits digest {v['logits_digest']}")
    hold = seg[0]["val_hold"]
    log(f"mesh (c): the sharded logits against one process's sweep at sw batch "
        f"{SEG_VAL_SW_BATCH}: {hold}")
    mesh_ranks_hold("(c)", seg)
    val = [r["data"]["validate"] for r in seg]
    if not (hold["ok"] and val[0]["logits_digest"] == val[1]["logits_digest"]
            and all(v["launches"]["attention"] == v["vit_layers"]
                    and v["launches"]["instance_norm"] > 0 for v in val)):
        raise AssertionError(f"mesh (c) failed: sharded validation {hold}, logits digests "
                             f"{[v['logits_digest'] for v in val]}, launches "
                             f"{[v['launches'] for v in val]}")
    return {"ranks": seg}


def phase_mesh(dev, data, root) -> dict:
    """The mesh phase: part (a), then parts (b) and (c) (module docstring)."""
    smi = nvidia_smi()
    a = mesh_part_a(dev, data, root)
    free_memory()
    ranks = mesh_workers(data, root)
    b, c = mesh_part_b(ranks), mesh_part_c(ranks)
    log(f"mesh: on {smi}")
    return {"a": a, "b": b, "c": c}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
        return 1
    if sys.argv[1:2] == ["--mesh-worker"]:
        return mesh_worker(sys.argv[2])
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from dose_prediction_tpu_torch.infer.cascade import make_cascade_stages
        from dose_prediction_tpu_torch.kernels import attention as k1
        from dose_prediction_tpu_torch.kernels import conv3d as k3
        from dose_prediction_tpu_torch.kernels import cuda_lib
        from dose_prediction_tpu_torch.kernels import instance_norm as k2
    except ImportError as e:
        log(f"cannot import the port (run from a checkout of the repository): {e}")
        return 1
    # float32 parity runs with TF32 off for both cuDNN convolutions and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    results = {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            results[name] = fn()
        except Exception:
            traceback.print_exc()
            log(f"phase {name}: FAILED after {time.perf_counter() - t0:.1f} s "
                f"({written_gib():.2f} GiB written by this process so far)")
            raise
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s "
            f"(total {time.perf_counter() - t_start:.1f} s; {written_gib():.2f} GiB written by "
            f"this process so far)")

    try:
        run("device", lambda: {"smi": nvidia_smi(), "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()})
        print(results["device"]["smi"], flush=True)
        run("build", lambda: (cuda_lib.library(), str(cuda_lib.build()))[1])
        run("kernels", lambda: phase_kernels(dev))
        models = {}
        run("models", lambda: models.update(zip(("seg", "dose"), seeded_models(dev))))
        stage1, stage2 = make_cascade_stages(models["seg"], models["dose"],
                                             roi_size=(96, 96, 96), sw_batch_size=8,
                                             overlap=0.25, dose_scale=70.0)
        args = (dev, models["seg"], models["dose"], stage1, stage2)
        run("parity", lambda: phase_parity(*args, (k1, k2, k3)))
        run("serve", lambda: phase_serve(*args))
        run("profile", lambda: phase_profile(*args))
        run("serve_k3", lambda: {**phase_serve(*args, route_k3=True),
                                 "profile": phase_profile(*args, route_k3=True)})
        run("dense", lambda: phase_dense(dev, models["seg"], models["dose"]))
        run("sweep", lambda: phase_sweep(dev, models["seg"], models["dose"]))
        run("routes", lambda: phase_routes(*args, results["serve"]))
        run("parity_dense", lambda: phase_parity_dense(dev, models["seg"], models["dose"],
                                                       (k1, k2, k3)))
        del models, stage1, stage2, args
        torch.cuda.empty_cache()
        run("train", lambda: phase_train(dev))
        torch.cuda.empty_cache()
        run("train_parity", lambda: phase_train_parity(dev, (k1, k2, k3)))
        for name, fn in (("train_seg", lambda: phase_train_seg(dev)),
                         ("train_c3d", lambda: phase_train_c3d(dev)),
                         ("train_options", lambda: phase_train_options(dev)),
                         ("train_seg_parity", lambda: phase_train_seg_parity(dev, (k1, k2, k3)))):
            free_memory()
            torch.cuda.reset_peak_memory_stats(dev)
            run(name, fn)
        free_memory()
        with tempfile.TemporaryDirectory() as root:
            run("data", lambda: phase_data(dev, root))
            run("train_feed", lambda: phase_train_feed(dev, results["data"]))
            free_memory()
            run("mesh", lambda: phase_mesh(dev, results["data"], root))
            free_memory()
            run("trainer", lambda: phase_trainer(dev, results["data"], root))
            free_memory()
            torch.cuda.reset_peak_memory_stats(dev)
            run("zoo", lambda: phase_zoo(dev, results["data"], root, (k1, k2, k3)))
            remove_work(root, "zoo")
            free_memory()
            run("hpo_gan", lambda: phase_hpo_gan(dev, results["data"], root))
            remove_work(root, "gan", "hpo")
            free_memory()
            torch.cuda.reset_peak_memory_stats(dev)
            run("exp_gan", lambda: phase_exp_gan(dev, results["data"], root, (k1, k2, k3)))
            remove_work(root, "exp_gan")
            del results["data"]["dataset"]
            free_memory()
            run("captured", lambda: phase_captured(dev, root, results["serve_k3"]))
        free_memory()
        run("train_captured", lambda: phase_train_captured(dev))
    except Exception:
        return 1

    smi = results["device"]["smi"]
    log(f"serve p50 {results['serve']['p50_s']} s, serve_k3 p50 {results['serve_k3']['p50_s']} "
        f"s; dense_fastpath_p50_s {results['dense']['dense_fastpath_p50_s']}; "
        f"sweep_volumes_per_sec {results['sweep']['sweep_volumes_per_sec']}; p50 with "
        + ", ".join(f"{k} {v['p50_s']} s" for k, v in results["routes"].items())
        + f"; train step p50 {results['train']['p50_s']} s with K3 routing, "
        f"{results['train']['p50_s_routing_off']} s without; train_seg p50 "
        f"{results['train_seg']['p50_s']} s, train_c3d p50 {results['train_c3d']['p50_s']} s; "
        + ", ".join(f"{k} p50 {v['p50_s']} s" for k, v in results["train_options"].items())
        + "; train step p50 fed by "
        + ", ".join(f"{k} {results['train_feed'][k]['p50_s']} s" for k in ("float32", "bfloat16",
                                                                           "packed"))
        + f"; mesh (a) step p50 {results['mesh']['a']['p50_s']} s (NCCL world of 1; eager "
        f"{pct(results['mesh']['a']['eager_steps_s'], 0.5)} s)"
        + f"; trainer step p50 {results['trainer']['pyfer']['step_p50_s']} s (train pyfer, "
        f"float32); eval sweeps {results['trainer']['eval']['host']['sweep_s']} s host, "
        f"{results['trainer']['eval']['device']['sweep_s']} s device; checkpoint writes "
        + ", ".join(f"{n} {s:.2f} s" for n, s, _ in results["trainer"]["pyfer"]["writes"])
        + "; zoo serve p50 "
        + ", ".join(f"{k} {v['p50_s']} s" for k, v in results["zoo"]["serve"].items())
        + ", zoo train p50 "
        + ", ".join(f"{k} {v['p50_s']} s" for k, v in results["zoo"]["train"].items())
        + f"; DoseGAN step p50 {results['hpo_gan']['step']['p50_s']} s, peak "
        f"{results['hpo_gan']['step']['peak_gib']:.2f} GiB; tune wall "
        + ", ".join(f"{k} {v['s']:.1f} s" for k, v in results["hpo_gan"]["search"].items())
        + "; exp_gan step p50 "
        + ", ".join(f"{k} {v['p50_s']} s (peak {v['peak_gib']:.2f} GiB)"
                    for k, v in results["exp_gan"]["steps"].items())
        + f"; captured sliding p50 {results['captured']['sliding_aot']['p50_s']} s (eager "
        f"{results['captured']['sliding_aot']['eager_p50_s']} s), dense "
        f"{results['captured']['dense_aot']['p50_s']} s (eager "
        f"{results['captured']['dense_aot']['eager_p50_s']} s), streaming "
        f"{results['captured']['streaming']['volumes_per_sec']} volumes/s"
        + "; captured train steps p50 "
        + ", ".join(f"{k} {v['p50_s']} s (eager {v['eager_p50_s']} s)"
                    for k, v in results["train_captured"].items())
        + f"; total {time.perf_counter() - t_start:.1f} s; on {smi}")
    sources = {   # each kernel's source and the TPU kernel it replaces
        "attention": ("dose_prediction_tpu_torch/csrc/attention.cu",
                      "dose_prediction_tpu/kernels/attention.py:26"),
        "instance_norm": ("dose_prediction_tpu_torch/csrc/instance_norm.cu",
                          "dose_prediction_tpu/kernels/instance_norm.py:32"),
        "conv3d_k3": ("dose_prediction_tpu_torch/csrc/conv3d_k3.cu",
                      "dose_prediction_tpu/kernels/conv3d.py:60")}
    kernels = []
    for name, shape, phase in (("attention", K1_SHAPES[0], "serve"),
                               ("instance_norm", K2_SHAPES[0], "serve"),
                               ("conv3d_k3", K3_SHAPES[3], "serve_k3")):
        source, replaces = sources[name]
        row = results["kernels"][(name, shape, torch.bfloat16)]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": results[phase]["launches"][name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "shape": list(shape), "dtype": "bfloat16", "launches_in": phase})
    zoo_shapes = [("instance_norm", s) for s in K2_ZOO_SHAPES] + \
        [("conv3d_k3", s) for s in K3_ZOO_SHAPES]
    for name, shape in zoo_shapes:
        source, replaces = sources[name]
        row = results["kernels"][(name, shape, torch.bfloat16)]
        launches = results["zoo"]["train"]["hdunet"]["shapes"][f"{name} {shape} bfloat16"]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches, "max_abs_err": row["max_abs_err"],
                        "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "shape": list(shape),
                        "dtype": "bfloat16",
                        "launches_in": f"zoo: HD-UNet bf16 train steps (a warm-up and "
                                       f"{ZOO_TRAIN_STEPS})"})
    exp_gan = results["exp_gan"]
    for name, shape, counts, where in (
            [("instance_norm", s, exp_gan["shapes"], "exp_gan: the zoo forwards, the ViT-GAN "
              "and exp steps and their CLI (train, eval, predict)") for s in K2_EXP_GAN_SHAPES]
            + [("attention", K1_SHAPES[4], exp_gan["k1_shapes"], "exp_gan: the ViT generators' "
                "sliding-window evaluation in the CLI (sw batch 4)")]):
        source, replaces = sources[name]
        row = results["kernels"][(name, shape, torch.float32)]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": counts.get(f"{name} {shape} float32", 0),
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "shape": list(shape), "dtype": "float32", "launches_in": where})
    captured = results["captured"]
    for name, shape, profile, where in (
            ("attention", K1_SHAPES[0], captured["sliding_profile"], "captured: kernels the "
             "profiler saw in one replayed sliding request, every shape"),
            ("instance_norm", K2_SHAPES[0], captured["sliding_profile"], "captured: kernels "
             "the profiler saw in one replayed sliding request, every shape"),
            ("conv3d_k3", K3_SHAPES[3], captured["routed_profile"], "captured: kernels the "
             "profiler saw in one replayed sliding request with the K3 routing on, every "
             "shape")):
        source, replaces = sources[name]
        row = results["kernels"][(name, shape, torch.bfloat16)]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": profile["groups_launches"]["captured"][name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "shape": list(shape), "dtype": "bfloat16", "launches_in": where})
    steps = results["train_captured"]
    for name, shape, label in (
            ("attention", K1_SHAPES[1], "pyfer bf16 adamw, K3 routing on"),
            ("instance_norm", K2_SHAPES[5], "pyfer bf16 adamw, K3 routing on"),
            ("conv3d_k3", K3_SHAPES[0], "pyfer bf16 adamw, K3 routing on"),
            ("attention", K1_SHAPES[3], "transeg bf16, K3 routing on"),
            ("instance_norm", K2_SHAPES[11], "transeg bf16, K3 routing on"),
            ("conv3d_k3", K3_SHAPES[10], "transeg bf16, K3 routing on")):
        source, replaces = sources[name]
        row = results["kernels"][(name, shape, torch.bfloat16)]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": steps[label]["groups_launches"]["captured"][name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "shape": list(shape), "dtype": "bfloat16",
                        "launches_in": f"train_captured: kernels the profiler saw in one "
                                       f"replayed step ({label}), every shape"})
    seg_mesh = results["mesh"]["c"]["ranks"]
    for shape, launches, where in (
            (K1_SHAPES[7], seg_mesh[1]["model"]["launches"]["attention"],
             "mesh (c): rank 1's last TranSeg step on {'model': 2}"),
            (K1_SHAPES[8], seg_mesh[0]["data"]["validate"]["launches"]["attention"],
             "mesh (c): rank 0's share of the sharded validation of one 128³ patient on "
             "{'data': 2}")):
        source, replaces = sources["attention"]
        row = results["kernels"][("attention", shape, torch.float32)]
        kernels.append({"name": "attention", "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "shape": list(shape), "dtype": "float32", "launches_in": where})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": results["device"]["kind"],
                                             "count": results["device"]["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
