#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit: ``python3 chip_smoke.py``. It imports nothing of JAX or of the JAX
package. Phases, each fatal on failure:

1. build    - compile every CUDA kernel of ``manipose_tpu_torch/ops/csrc``
              with nvcc (one process per source, in parallel); print each
              kernel's registers and spills, and the count of tensor-core
              instructions in the SASS (cuobjdump) of each library, which
              must be more than 0, and of each device kernel, which must
              be more than 0 in every instantiation of K3 and K4; print
              K3's and K4's launch shapes (warps, ring slots, blocks an
              SM) per dtype and head dim at N = 17, 16 and 27.
2. kernels  - each kernel (K1 dense attention, K3 per-window attention,
              K5 fused MLP, and their backward kernels K2, K4, K6) against
              its plain PyTorch version at the shapes the flagship gives
              it, K3-K6 at the 3DHP model's (L = 27, batch 25: K3/K4
              on the temporal layers' windows of 27 frames, K5/K6 on
              11475 and 10800 rows), and K1, K3 and K5 at a streaming
              session's one-window shapes at L = 243 and L = 27
              (STREAM_ATTENTION_CASES, STREAM_MLP_CASES), in fp32 and
              bf16, timed (with its achieved TFLOP/s)
              beside its plain version, its roofline bound and one PyTorch
              library call computing the same function (the median of 5
              groups of 10 launches). Times are CUDA events around 10
              launches queued behind a sleep kernel, so the host's time
              to launch is not counted.
3. flagship - ``Predictor.predict_video`` at ``configs/config.yaml`` (rMCL,
              fp32, 16 windows of 243 frames, TTA on) with seeded random
              weights: output checks, the manifold invariant, the kernel
              launch counts of the run, and frames/s.
4. cpu-card - one window of the flagship model, TTA off, on the CPU (plain
              versions) and on the card (kernels) with the same weights.
5. train    - the flagship train step (fp32, B=16 synthetic windows,
              drop-path 0.1, Adam): every loss term finite on every step,
              every parameter's gradient finite after the first backward,
              the launch counts of one step, then train sequences/s over
              10 steps and the peak device memory.
6. cpu-card train - one flagship train step on one window, drop-path off,
              on the CPU and on the card from the same weights: the loss
              and every gradient.
7-10. bf16  - phases 3-6 again under ``model.dtype=bfloat16`` (fp32
              parameters, bf16 activations): serving frames/s with K1, K3
              and K5 launched on bf16 operands only; the card against the
              CPU on one window (both branches' outputs, then the decoded
              poses and hypotheses); the train step's sequences/s (printed
              beside bench.py's metric name) and peak memory with all six
              kernels launched on bf16 operands only; one train step on
              one window, the card against the CPU (loss terms, finite
              gradients, and the branches' gradients under a fixed
              cotangent). bf16 tolerances below.
11. bf16 accuracy - bf16 K1-K4 at the flagship's rotations and segments
              shapes against fp64 from the same bf16 inputs: each output
              (out, dq, dk, dv) within 1.05 x the plain version's error
              (+1e-6), K2's within 1.02 x, printed beside the errors and
              times the kernels had with P and dS in one bf16 part and
              K2's with delta from the bf16-rounded output.
12-15. eval - the eval-only H36M driver (``drivers.h36m.main``,
              run.train=false) at the flagship in fp32, then in bf16, on
              H36M-format npz files written from ``run.seed`` (S11, two
              actions, 4 cameras, 3888 frames each: 128 windows of 243
              frames in batches of 10): the native windowing core loaded,
              the phase's peak memory, the protocol's average row (every
              value finite), and K1, K3 and K5 launched (on the dtype's
              operands) and no backward kernel; then eval frames/s (valid
              frames over ``evaluate``'s wall time) over at least
              EVAL_WINDOW_S of warm calls of one action's ``evaluate``,
              and the device's busy share of as many calls under the
              profiler. After each, one action, one camera and 2 windows
              in one batch of 3 (one padded row), scored against targets
              made from the model's own hypotheses, through ``evaluate``
              on the card and on the CPU from the same weights: fp32
              predictions
              within MODEL_TOL of their magnitude and the MPJPE, oracle,
              pseudo-oracle and P-MPJPE within 1e-4 relative; bf16 the
              predictions and the same metrics within max(BF16_TOL, 2 *
              the CPU's bf16 spread + GAP_SLACK).
16-17. train driver - the training driver (``drivers.h36m.main``,
              run.train=true) at the flagship in bf16, then in fp32, on the
              same npz files with S1 (the same actions, cameras and
              frames) training and S9 (one window a camera) and S11
              validating: 2 epochs of 8 steps of 16 windows, validation
              loss and MPJPE every epoch, then the test protocol. All six
              kernels launched, every launch on the dtype's operands, the
              backward kernels once a layer a step; finite losses; every
              best tag, end and the last resume state written; the
              protocol table finite. Per epoch: the meter's train
              sequences/s, the wall seconds of training, validation loss,
              MPJPE eval and checkpoint writes, peak memory.
18. resume  - the bf16 run relaunched with one more epoch and
              run.auto_resume=true: it starts at epoch 2 and trains one.
19. run dir - ``Predictor.from_any`` on the fp32 run's directory, tag
              best_mpjpe: one 243-frame window within MODEL_TOL of the
              magnitude of the tag's eval forward (``evaluate``, TTA).
20. cpu-card loop - one epoch of the driver at flagship widths, depth 2,
              L = 27, fp32, drop-path 0, on the CPU and on the card from
              the same seeded weights: the train loss within 1e-4
              relative, the validation loss within 2 x the CPU's own
              change under input changes of +-MODEL_TOL + 1e-4, every
              parameter within twice the most Adam can move it over the
              run.
21-24. 3dhp - FK-synthetic MPI-INF-3DHP archives (the port's
              ``tools.make_synthetic_3dhp`` from ``run.seed``: 2 train
              sequences x 2 cameras x 2000 frames, TS1-TS6 of 1500 frames)
              and the 3DHP driver (``drivers.dhp3.main``, run.train=true,
              data=mpi_inf_3dhp, L = 27) at the flagship's widths in bf16,
              then fp32: batch 25, 2 epochs with validation and MPJPE each,
              then the PCK/AUC protocol (test batch 30). K1 and K2 never
              launched; K3-K6 launched on the dtype's operands, the
              backward kernels once a layer a step; finite losses; every
              tag and the five CSVs written; PCK, AUC, agg_pck and agg_auc
              in [0, 100]. Per epoch the meter's sequences/s, the wall
              split and peak memory; the protocol's valid frames/s. After
              each, the protocol on TS1 and TS5 cut to 2 windows each, from
              the run's best_mpjpe weights with targets at the model's
              scale, on the card and on the CPU: fp32 predictions within
              MODEL_TOL of their magnitude, the metrics within 1e-4
              relative and PCK/AUC within one joint-frame's share; bf16 by
              the spread rule.
25. stream  - ``Predictor.stream`` on the card: stride L, lookahead 0
              equals ``predict_video``; then at the H36M flagship (L = 243)
              and the 3DHP model (L = 27), fp32 and bf16, strides 1 and 3,
              default lookahead: ms per firing push (median, p90 of warm
              pushes) and frames/s beside latency_frames.
26. stream cpu-card - a stride-1 session (default lookahead) at both
              models in fp32 and bf16, STREAM_CPU_WINDOWS firing pushes, on
              the card and on the CPU from the same weights: fp32 within
              MODEL_TOL of the magnitude, bf16 by the spread rule.
27. profile - only with ``--profile``: one flagship ``predict_video`` and
              one flagship train step under ``torch.profiler``, in fp32
              and in bf16, one epoch of the train loop in each, ten train
              steps of the 3DHP model (L = 27) and ten firing pushes of a
              stream at L = 243 and at L = 27 in each, and one int8
              ``predict_video`` in each (phases 29-30), device time by
              kernel class and the device's busy share of each.
28. int8 gemms - ``quant.int8_speedup()`` (the gate of
              ``quantize=True``), then the trunks' int8 products (qkv,
              proj, fc1, fc2 of both trunks at 16 windows of 243) through
              ``quant.int_mm`` (``torch._int_mm``), exact against fp64,
              timed beside a bf16 ``F.linear`` and their bound.
29-30. int8 serving - ``Predictor(quantize="force")`` at the flagship
              (16 windows, TTA) in fp32, then bf16 compute: outputs
              finite, K1 and K3 launched on the dtype's operands and K5
              never, frames/s, the gap to the float predictor (fatal at
              0.2 relative), and 2 windows on the card against the CPU
              (fp32: 2 x the CPU's change under a one-ulp input nudge +
              MODEL_TOL of the magnitude; bf16: the bf16 spread rule).
31. data-parallel - ``Predictor(data_parallel=True)`` on the one card
              bit-equal to the plain predictor, and its stream (each
              window replicated up to the batch) within MODEL_TOL of the
              plain one's.
32. export  - ``export_program`` (symbolic batch) and ``load_program`` of
              the fp32 flagship on the card: batches 1, 2 and 16 within
              1e-5 of the magnitude of the live forward, K1, K3 and K5
              launched inside the program, frames/s of program and live
              forward.
33. http    - the port's HTTP server (``tools.serve``) in this process on
              a local port: /healthz, /predict and a stream lifecycle
              equal to the direct calls, then requests/s and latency of
              /predict requests of 4 windows of 243 frames.

The last lines are the card's name and power limit (as nvidia-smi prints
them), one JSON object ``{"kernels": [...]}``, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W): the
# roofline bound of a kernel is the larger of bytes / memory rate and
# operations / peak rate of the operand type. fp32 products at fp32
# accuracy run on the tensor cores as 3xTF32 (three tf32 passes over
# operands split into big and small parts), a third of the 495 TFLOP/s
# tf32 rate and above the CUDA cores' 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}

# Tolerances (max abs error against the plain version on the same inputs):
# the JAX package's own - attention 2e-5 fp32 (tests/test_pallas_attention.py),
# MLP 5e-5 fp32 and 0.05 bf16 (tests/test_pallas_mlp.py). Attention in bf16
# takes the same 0.05: kernel and plain version accumulate in fp32 from the
# same bf16 inputs and differ only in the final rounding to bf16.
TOL = {
    ("attention", torch.float32): 2e-5,
    ("attention", torch.bfloat16): 0.05,
    ("mlp", torch.float32): 5e-5,
    ("mlp", torch.bfloat16): 0.05,
}
# Gradient tolerances (max abs error against the plain backward): the JAX
# package's, attention 5e-4 and MLP 5e-4 * max(1, |ref|max) in fp32; in
# bf16 0.05 * max(1, |ref|max) for both, where kernel and plain version
# sum in fp32 from the same bf16 inputs and round the results to bf16.
GRAD_TOL = {torch.float32: 5e-4, torch.bfloat16: 0.05}
# CPU vs card on the whole model: the JAX package's model-forward tolerance
# (5e-5), relative to the output's magnitude (16 fp32 trunk blocks whose
# sums run in another order on each side).
MODEL_TOL = 5e-5
# CPU vs card under bf16 compute: the JAX package's bf16 model tolerance
# (tests/test_pallas_mlp.py), relative to max(1, |ref|max), for both
# branches' outputs (the rotations branch's hypotheses and scores, the
# segments branch's bone lengths) and the loss terms (relative), and 0.05
# relative in norm for each parameter's gradient of the branches' outputs
# under a fixed random cotangent. Where bf16 itself moves a quantity
# further on the CPU, the bound is 2 * that spread + 1e-3: the spread is
# how far the CPU's bf16 result moves when the input moves by one part in
# 256 (about one bf16 ulp; BF16_NUDGE) or, for gradients, the larger of
# that and its distance from the CPU's fp32 result. That covers poses and
# hypotheses, which pass through the FK decoder's Gram-Schmidt (at random
# weights it amplifies bf16's rounding), and the few gradients that bf16
# moves that far on the CPU (one score head's at the flagship). A loss
# term under GAP_SLACK of the total loss is held to BF16_TOL of that
# share rather than of itself: bf16's rounding can make all of it (the
# smoothness term of nearly constant poses, squared differences of bf16
# values, sat at 4e-7 of a 0.95 loss and 10 % apart on an NVIDIA H100
# 80GB HBM3 at 700 W). As FK amplifies bf16's rounding, the train step's
# gradients through FK and the WTA loss (which a 1e-3 change of the input
# moves by half on the CPU) are required finite, not close.
BF16_TOL = 0.05
GAP_SLACK = 1e-3
BF16_NUDGE = 1.0 + 2.0**-8

# launches per forward pass of the flagship rMCL model: 8 + 2 temporal
# (K1) and 8 + 2 spatial (K3) attention layers, 16 + 4 MLPs (K5); TTA runs
# the model twice per window batch
LAUNCHES_PER_FORWARD = {"attention_dense": 10, "attention_packed": 10,
                        "fused_mlp": 20}
# launches per flagship train step: one forward, and one backward kernel
# for each forward launch
LAUNCHES_PER_TRAIN_STEP = {**LAUNCHES_PER_FORWARD, "attention_dense_bwd": 10,
                           "attention_packed_bwd": 10, "fused_mlp_bwd": 20}

# the flagship train step: bench.py's batch, the config's learning rate
# (weight decay 1e-6 comes with train.optimizer_from_config, as in bench.py)
TRAIN_BATCH = 16
TRAIN_LR = 4e-5
TRAIN_STEPS = 10
# cycles of the sleep kernel ahead of a timed run of launches (~5 ms at the
# H100's 1.98 GHz boost clock): longer than the host takes to enqueue 10
# launches of any kernel timed here
SLEEP_CYCLES = 10_000_000
# CPU vs card train step on one window: each loss term relative (the JAX
# package's model tolerance); each gradient within GRAD_TOL[fp32] of its
# tensor's max(1, |g|max)
TRAIN_LOSS_TOL = 5e-5

# bf16 K1-K4 against fp64 from the same bf16 inputs: each output within
# 1.05 x the plain version's error (+1e-6), K2's dq, dk and dv within
# 1.02 x. The plain version keeps P and dS in fp32, as the Pallas kernels
# do; the kernels split them into two bf16 parts (csrc/attention.cu,
# AccMma), and K2 takes delta = rowsum(dP * P) in fp32 as they do.
BF16_ACCURACY_RATIO, BF16_ACCURACY_SLACK = 1.05, 1e-6
K2_BF16_ACCURACY_RATIO = 1.02
# K2's bf16 errors against fp64 (dq, dk) with delta = rowsum(dO * O) from
# the bf16-rounded output (chip_smoke.py phase 11 on an NVIDIA H100 80GB
# HBM3 at 700 W), and its bf16 times then (ms, phase 2 of the same run),
# printed beside this run's
DELTA_FROM_O_BF16_RATIOS = {("rotations", "dq"): 1.0152, ("rotations", "dk"): 1.0068,
                            ("segments", "dq"): 1.0461, ("segments", "dk"): 1.0098}
DELTA_FROM_O_BF16_MS = {"rotations": 0.7845, "segments": 0.3353}
# The errors of the kernels when they fed P and dS to the tensor cores in
# one bf16 part (run_probes bf16 on an NVIDIA H100 80GB HBM3 at 700 W), and
# their bf16 times (ms, phase 2 of the same run), printed beside this run's
ONE_PART_BF16_ERRORS = {("dense", "rotations", "out"): 2.153e-3,
                        ("dense", "rotations", "dq"): 2.400e-3,
                        ("packed", "rotations", "out"): 2.000e-3,
                        ("packed", "rotations", "dq"): 2.360e-3}
ONE_PART_BF16_MS = {("attention_dense", "rotations"): 0.2223,
                    ("attention_dense", "segments"): 0.1073,
                    ("attention_dense_bwd", "rotations"): 0.6728,
                    ("attention_dense_bwd", "segments"): 0.2847,
                    ("attention_packed", "rotations"): 0.1018,
                    ("attention_packed", "segments"): 0.0322,
                    ("attention_packed_bwd", "rotations"): 0.1800,
                    ("attention_packed_bwd", "segments"): 0.0566}

# The eval phases' data: H36M-format npz files written from run.seed, the
# test subject S11 with two actions of EVAL_FRAMES frames on 4 cameras:
# 2 x 4 x 16 windows of 243 frames, in batches of train.batch_size_test.
EVAL_ACTIONS = {"Walking": "walking", "Eating": "eating"}
EVAL_FRAMES = 3888
# eval card vs CPU, fp32: the MPJPE, oracle, pseudo-oracle and P-MPJPE
EVAL_METRIC_TOL = 1e-4
# The card-vs-CPU windows' 3D targets: per frame one of the model's own
# hypotheses (drawn from run.seed) plus N(0, EVAL_TARGET_NOISE_M) per
# coordinate, so that every metric moves with what the model predicts and
# a wrong oracle pick or normalization moves it past its limit.
EVAL_TARGET_NOISE_M = 0.005
# eval frames/s: warm evaluate calls of one action repeated until the
# window holds at least this many seconds (one action is 0.5-1.2 s)
EVAL_WINDOW_S = 6.0

# The training driver's phases: S1 (EVAL_ACTIONS, 4 cameras, EVAL_FRAMES
# frames: 128 windows of 243, 8 steps of TRAIN_BATCH an epoch) trains; S9
# (S9_FRAMES, one window a camera) and S11 validate, S11 tests.
S9_FRAMES = 243
DRIVER_EPOCHS = 2
# every tag a training run writes (rMCL), and the resume state of its end
RUN_TAGS = ("best_val", "best_mpjpe", "best_oracle_mpjpe", "best_ps_oracle_mpjpe", "end",
            f"train_state_{DRIVER_EPOCHS:06d}")
# the loop on the card against the CPU: flagship widths at depth 2 and
# L = 27 on short videos (LOOP_FRAMES frames: 4 windows a camera, 2 steps),
# one epoch, fp32, drop-path 0; losses within LOOP_LOSS_TOL relative
LOOP_OVERRIDES = ("model.layers=2", "data.seq_len=27", "model.drop_path_rate=0.0",
                  "train.epochs=1", "train.mpjpe_epoch_interval=5", "run.test=false")
LOOP_FRAMES = 108
LOOP_LOSS_TOL = 1e-4
ADAM_BETAS = (0.9, 0.999)

# The 3DHP phases: FK-synthetic MPI-INF-3DHP archives written by the port's
# make_synthetic_3dhp from run.seed (train: 2 sequences x 2 cameras x 2000
# frames; test: TS1-TS6 of 1500 frames, about 5 % invalid, TS5/TS6 at
# 1920x1080), and the 3DHP driver at configs/config.yaml's widths with the
# data=mpi_inf_3dhp group (L = 27): train=mix_ste's batch of 25, the
# README's test batch of 30, DRIVER_EPOCHS epochs with validation and MPJPE
# every epoch, then the PCK/AUC protocol.
DHP3_TRAIN_SEQS, DHP3_CAMS, DHP3_FRAMES, DHP3_TEST_FRAMES = 2, 2, 2000, 1500
DHP3_SEQ_LEN = 27
DHP3_BATCH, DHP3_BATCH_TEST = 25, 30
# at L = 27 every attention layer runs per window (N <= 32): per forward 8 +
# 2 temporal and 8 + 2 spatial K3 launches, 16 + 4 K5; a train step adds
# one backward kernel for each
DHP3_LAUNCHES_PER_TRAIN_STEP = {"attention_packed": 20, "fused_mlp": 20,
                                "attention_packed_bwd": 20, "fused_mlp_bwd": 20}
DHP3_OUTPUT_CSVS = ("seg_symmetry", "seg_consistency", "jw_err", "cw_err", "test_metrics")
# the card against the CPU: the protocol on TS1 and TS5 cut to
# DHP3_CPU_WINDOWS windows each, in one batch
DHP3_CPU_SEQUENCES, DHP3_CPU_WINDOWS = ("TS1", "TS5"), 2
# streaming: sessions at the H36M flagship (L = 243) and the 3DHP model
# (L = 27), default lookahead, these strides; each push one frame, the
# first STREAM_WARM firing pushes not timed, STREAM_FIRINGS timed
STREAM_STRIDES = (1, 3)
STREAM_WARM, STREAM_FIRINGS = 3, 30
# a firing push is a one-window forward, so its kernels run on a window's
# rows alone: at L = 243 K1 on the temporal layers (17 joints or 16 bones
# x 8 heads), K3 on the spatial ones (243 frames x 8 heads); at L = 27 K3
# on both (temporal 17 or 16 x 8 windows of 27, spatial 27 x 8 of 17 or
# 16); K5 on L * 17 and L * 16 rows. Phase 2 holds each against its plain
# version at these shapes (kind, trunk, batch, heads, N, d).
STREAM_ATTENTION_CASES = (
    ("attention_dense", "stream-243-rotations", 17, 8, 243, 64),
    ("attention_dense", "stream-243-segments", 16, 8, 243, 16),
    ("attention_packed", "stream-243-rot-spatial", 243, 8, 17, 64),
    ("attention_packed", "stream-243-seg-spatial", 243, 8, 16, 16),
    ("attention_packed", "stream-27-rot-temporal", 17, 8, 27, 64),
    ("attention_packed", "stream-27-seg-temporal", 16, 8, 27, 16),
    ("attention_packed", "stream-27-rot-spatial", 27, 8, 17, 64),
    ("attention_packed", "stream-27-seg-spatial", 27, 8, 16, 16),
)
# (trunk, rows, C, H)
STREAM_MLP_CASES = (
    ("stream-243-rotations", 243 * 17, 512, 1024),
    ("stream-243-segments", 243 * 16, 128, 256),
    ("stream-27-rotations", 27 * 17, 512, 1024),
    ("stream-27-segments", 27 * 16, 128, 256),
)
# the card against the CPU on a stride-1 session with default lookahead:
# this many firing pushes (one window each), at both models and dtypes
STREAM_CPU_WINDOWS = 2

# The rest of serving (phases 28-32). The trunks' int8 products at the
# flagship's serving batch (16 windows of 243): (trunk, M, k, n) for qkv,
# proj, fc1 and fc2, rows M = 16 * 243 * 17 joints (rotations) or 16 bones
# (segments); int8 peak of one H100 SXM (dense, data sheet, 700 W)
INT8_GEMM_CASES = tuple(
    (f"{trunk}-{layer}", TRAIN_BATCH * 243 * rows, k, n)
    for trunk, rows, c in (("rotations", 17, 512), ("segments", 16, 128))
    for layer, k, n in (("qkv", c, 3 * c), ("proj", c, c), ("fc1", c, 2 * c),
                        ("fc2", 2 * c, c))
)
PEAK_INT8_OPS = 1979e12
# int8 serving: 16 windows of 243, TTA, quantize="force"; per window batch
# K1 and K3 run as in float serving and K5 never (two QuantLinears instead)
INT8_LAUNCHES_PER_FORWARD = {"attention_dense": 10, "attention_packed": 10}
# int8 card vs CPU: 2 windows, TTA off; fp32 within 2 * the CPU's own change
# under a one-ulp input nudge (int8 codes flip where a row's sums differ in
# the last bit) + MODEL_TOL of the magnitude; bf16 by the bf16 spread rule
INT8_CPU_WINDOWS = 2
# the int8 predictor's poses against the float one's on the card, relative
# in norm (tests/test_serving.py's bound)
INT8_FLOAT_REL = 0.2
# export: the program against the live forward (tests/test_serving.py)
EXPORT_TOL = 1e-5
# the HTTP server: requests of SERVE_WINDOWS windows of 243 frames to a
# predictor of that batch, SERVE_WARM untimed, then SERVE_REQUESTS timed
SERVE_WINDOWS, SERVE_WARM, SERVE_REQUESTS = 4, 2, 10

ATTENTION_CU = "manipose_tpu_torch/ops/csrc/attention.cu"
MLP_CU = "manipose_tpu_torch/ops/csrc/mlp.cu"
KERNELS = {
    "attention_dense": dict(
        source=ATTENTION_CU, replaces="manipose_tpu/ops/pallas_attention.py:97",
    ),
    "attention_dense_bwd": dict(
        source=ATTENTION_CU, replaces="manipose_tpu/ops/pallas_attention.py:119",
    ),
    "attention_packed": dict(
        source=ATTENTION_CU, replaces="manipose_tpu/ops/pallas_attention.py:224",
    ),
    "attention_packed_bwd": dict(
        source=ATTENTION_CU, replaces="manipose_tpu/ops/pallas_attention.py:248",
    ),
    "fused_mlp": dict(
        source=MLP_CU, replaces="manipose_tpu/ops/pallas_mlp.py:95",
    ),
    "fused_mlp_bwd": dict(
        source=MLP_CU, replaces="manipose_tpu/ops/pallas_mlp.py:172",
    ),
}
# the device kernels (as compiled) that each wrapper launches
DEVICE_KERNELS = {
    "attention_dense": ("attention_dense_kernel",),
    "attention_dense_bwd": ("attention_dense_bwd_dq_kernel",
                            "attention_dense_bwd_dkv_kernel"),
    "attention_packed": ("attention_packed_kernel",),
    "attention_packed_bwd": ("attention_packed_bwd_kernel",),
    "fused_mlp": ("fused_mlp_kernel",),
    "fused_mlp_bwd": ("fused_mlp_bwd_rows_kernel", "fused_mlp_bwd_gemm_kernel",
                      "fused_mlp_bwd_reduce_kernel"),
}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cmd_output(cmd) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except OSError as e:
        return f"unavailable ({e})"


def ptxas_summary(log: str):
    """One line per compiled kernel from ``nvcc -Xptxas -v``: the kernel
    and its template arguments, its registers and its spills."""
    kernel, spills = "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?\d([a-z_]+_kernel)I(\w*?)E+v", line)
        if m:
            targs = m.group(2).replace("13__nv_bfloat16", "bf16").replace("S1_", "bf16")
            kernel = f"{m.group(1)}<{targs.replace('Li', ',').replace('E', '')}>"
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            yield f"{kernel}: {line.split(':', 1)[1].strip()}; {spills}"
        elif "error" in line:
            yield line.strip()


def tensor_core_instructions(name: str) -> dict:
    """SASS instructions of library ``name`` that run on the tensor cores
    (``HMMA`` from mma.sync, ``HGMMA`` from wgmma), from ``cuobjdump
    --dump-sass`` of the built library: {function (mangled): {op: count}}."""
    from manipose_tpu_torch.ops import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "--dump-sass", str(build._target(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts = {}
    for part in re.split(r"^\s*Function : ", sass, flags=re.M)[1:]:
        function, body = part.split("\n", 1)
        ops = re.findall(r"\b(HGMMA|HMMA)\.", body)
        counts[function.strip()] = {op: ops.count(op) for op in ("HMMA", "HGMMA")}
    return counts


def phase_build(build) -> None:
    """Every kernel built; each library's and each wrapper's device kernels'
    tensor-core instructions (fatal where a library has none, or a
    per-window attention kernel has none); K3's and K4's launch shapes."""
    from manipose_tpu_torch.ops import cuda_attention as ca

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in ptxas_summary(log):
            print(f"  nvcc {name}: {line}")
    for name in build.SIGNATURES:
        by_function = tensor_core_instructions(name)
        total = {op: sum(c[op] for c in by_function.values()) for op in ("HMMA", "HGMMA")}
        print(f"sass {name}: tensor-core instructions {sum(total.values())} "
              f"({', '.join(f'{k} {v}' for k, v in total.items())})", flush=True)
        require(sum(total.values()) > 0, f"the {name} kernels run on the tensor cores")
        for ours, device_names in DEVICE_KERNELS.items():
            for device_name in device_names:
                found = [c for f, c in by_function.items() if re.search(
                    rf"\d{device_name}[IE]", f)]
                if not found:
                    continue
                hmma = sum(c["HMMA"] + c["HGMMA"] for c in found)
                print(f"  sass {ours}: {device_name} x{len(found)} instantiations, "
                      f"tensor-core instructions {hmma}")
                if ours.startswith("attention_packed"):
                    require(all(c["HMMA"] + c["HGMMA"] > 0 for c in found),
                            f"every {device_name} runs on the tensor cores")
    for dtype in (torch.float32, torch.bfloat16):
        for d in ca.HEAD_DIMS:
            for n in (17, 16, DHP3_SEQ_LEN):
                line = []
                for kind, backward in (("K3", False), ("K4", True)):
                    shape = ca.packed_launch_shape(dtype, d, n, backward, 1 << 30)
                    line.append(f"{kind} {shape['warps']} warps x {shape['slots']} slots, "
                                f"{shape['blocks_per_sm']} blocks/SM, "
                                f"{shape['smem_bytes']} B a block")
                print(f"packed shape {str(dtype)[6:]:8s} d={d:2d} N={n}: "
                      + "; ".join(line), flush=True)


def time_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after a warm-up.
    A sleep kernel ahead of the start event keeps the card busy while the
    host enqueues the launches, so the host's time to launch (tens of
    microseconds a call, as long as the shortest kernels here) is not
    counted as the kernel's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, groups: int = 5, reps: int = 10) -> float:
    """Median over ``groups`` of the mean device time of ``reps`` launches:
    the library yardsticks' times vary between runs more than the
    kernels' do."""
    return float(np.median([time_ms(fn, reps) for _ in range(groups)]))


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_case(kind, trunk, batch, heads, n, d, dtype, gen):
    """K1/K3 at one shape: q, k, v are strided views of one qkv tensor
    (batch, n, 3, heads, d), as the model's Attention builds them."""
    import torch.nn.functional as F

    from manipose_tpu_torch.ops import cuda_attention as ca

    qkv = torch.randn((batch, n, 3, heads, d), generator=gen, device="cuda")
    q, k, v = (t.transpose(1, 2) for t in qkv.to(dtype).unbind(2))
    scale = d**-0.5
    wrapper = ca.attention_dense if kind == "attention_dense" else ca.attention_packed
    out = wrapper(q, k, v, scale)
    ref = ca.attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[("attention", dtype)]
    require(err <= tol, f"{kind} {trunk} {dtype}: max abs err {err} > {tol}")
    elem = q.element_size()
    bh = batch * heads
    flops = 4.0 * bh * n * n * d
    b_ms, b_by = bound_ms(4 * bh * n * d * elem, flops, dtype)
    ms = time_ms(lambda: wrapper(q, k, v, scale))
    return dict(
        trunk=trunk, dtype=str(dtype).replace("torch.", ""),
        shape=[batch, heads, n, d], max_abs_err=err, tol=tol,
        ms=ms, tflops=flops / ms * 1e-9,
        plain_ms=time_ms(lambda: ca.attention_plain(q, k, v, scale)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
        ),
    )


def mlp_case(trunk, m, c, h, dtype, gen):
    """K5 at one shape, torch-default-init scaled weights."""
    import torch.nn.functional as F

    from manipose_tpu_torch.ops import cuda_mlp as cm

    def uniform(shape, fan_in):
        u = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
        return (u / fan_in**0.5).to(dtype)

    x = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
    w1, b1 = uniform((h, c), c), uniform((h,), c)
    w2, b2 = uniform((c, h), h), uniform((c,), h)
    out = cm.fused_mlp(x, w1, b1, w2, b2)
    ref = cm.mlp_plain(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[("mlp", dtype)]
    require(err <= tol, f"fused_mlp {trunk} {dtype}: max abs err {err} > {tol}")
    elem = x.element_size()
    flops = 4.0 * m * c * h
    b_ms, b_by = bound_ms((2 * m * c + 2 * c * h + h + c) * elem, flops, dtype)
    ms = time_ms(lambda: cm.fused_mlp(x, w1, b1, w2, b2))
    return dict(
        trunk=trunk, dtype=str(dtype).replace("torch.", ""),
        shape=[m, c, h], max_abs_err=err, tol=tol, ms=ms,
        tflops=flops / ms * 1e-9,
        plain_ms=time_ms(lambda: cm.mlp_plain(x, w1, b1, w2, b2)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(
            lambda: F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)
        ),
    )


def grad_tol(ref: torch.Tensor, dtype, relative: bool) -> float:
    scale = max(1.0, ref.float().abs().max().item())
    return GRAD_TOL[dtype] * (scale if relative or dtype == torch.bfloat16 else 1.0)


def attention_bwd_case(kind, trunk, batch, heads, n, d, dtype, gen):
    """K2/K4 at one shape: the gradient of the qkv tensor for a random
    output gradient laid out as the kernels' outputs are, against the plain
    backward; the library yardstick is the backward of
    ``scaled_dot_product_attention`` on the same views."""
    import torch.nn.functional as F

    from manipose_tpu_torch.ops import cuda_attention as ca

    qkv = torch.randn((batch, n, 3, heads, d), generator=gen, device="cuda")
    q, k, v = (t.transpose(1, 2) for t in qkv.to(dtype).unbind(2))
    dout = torch.randn((batch, n, heads, d), generator=gen, device="cuda")
    dout = dout.to(dtype).transpose(1, 2)
    scale = d**-0.5
    elem = q.element_size()
    bh = batch * heads
    if kind == "attention_dense_bwd":
        lse = torch.empty((batch, heads, n), dtype=torch.float32, device="cuda")
        out = ca.attention_dense(q, k, v, scale, lse=lse)

        def run():
            return ca.attention_dense_bwd(q, k, v, out, dout, lse, scale)

        # q, k, v, out, dout and the log-sum-exp read; dq, dk, dv written
        n_bytes = 8 * bh * n * d * elem + 4 * bh * n
    else:
        def run():
            return ca.attention_packed_bwd(q, k, v, dout, scale)

        n_bytes = 7 * bh * n * d * elem  # q, k, v, dout read; dq, dk, dv
    got = run()
    want = torch.stack([g.transpose(1, 2) for g in
                        ca.attention_plain_bwd(q, k, v, dout, scale)], dim=2)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = grad_tol(want, dtype, relative=False)
    require(err <= tol, f"{kind} {trunk} {dtype}: max abs err {err} > {tol}")
    del got, want
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, scale=scale)
    flops = 10.0 * bh * n * n * d
    b_ms, b_by = bound_ms(n_bytes, flops, dtype)
    ms = time_ms(run)
    return dict(
        trunk=trunk, dtype=str(dtype).replace("torch.", ""),
        shape=[batch, heads, n, d], max_abs_err=err, tol=tol,
        ms=ms, tflops=flops / ms * 1e-9,
        plain_ms=time_ms(lambda: ca.attention_plain_bwd(q, k, v, dout, scale)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(lambda: torch.autograd.grad(
            lib_out, leaves, dout, retain_graph=True)),
    )


def mlp_bwd_case(trunk, m, c, h, dtype, gen):
    """K6 at one shape: all five gradients against the plain backward, each
    within its own tolerance; the library yardstick is the autograd
    backward of ``F.linear -> F.gelu -> F.linear``."""
    import torch.nn.functional as F

    from manipose_tpu_torch.ops import cuda_mlp as cm

    def uniform(shape, fan_in):
        u = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
        return (u / fan_in**0.5).to(dtype)

    x = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
    w1, b1 = uniform((h, c), c), uniform((h,), c)
    w2, b2 = uniform((c, h), h), uniform((c,), h)
    g = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
    got = cm.fused_mlp_bwd(x, w1, b1, w2, g)
    want = cm.mlp_plain_bwd(x, w1, b1, w2, g)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, r in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        e = (a.float() - r.float()).abs().max().item()
        tol = grad_tol(r, dtype, relative=True)
        require(e <= tol, f"fused_mlp_bwd {trunk} {dtype} {name}: "
                          f"max abs err {e} > {tol}")
        err = max(err, e)
    del got, want
    leaves = [t.detach().requires_grad_() for t in (x, w1, b1, w2, b2)]
    lib_out = F.linear(F.gelu(F.linear(leaves[0], leaves[1], leaves[2])),
                       leaves[3], leaves[4])
    elem = x.element_size()
    # x, g, w1, b1, w2 read; dx, dw1, db1, dw2, db2 written
    n_bytes = (3 * m * c + 4 * c * h + 2 * h + c) * elem
    flops = 10.0 * m * c * h
    b_ms, b_by = bound_ms(n_bytes, flops, dtype)
    ms = time_ms(lambda: cm.fused_mlp_bwd(x, w1, b1, w2, g))
    return dict(
        trunk=trunk, dtype=str(dtype).replace("torch.", ""),
        shape=[m, c, h], max_abs_err=err, tol=f"{GRAD_TOL[dtype]} * max(1, |ref|max)",
        ms=ms, tflops=flops / ms * 1e-9,
        plain_ms=time_ms(lambda: cm.mlp_plain_bwd(x, w1, b1, w2, g)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(lambda: torch.autograd.grad(
            lib_out, leaves, g, retain_graph=True)),
    )


def phase_kernels():
    """Every kernel against its plain version at the flagship's shapes
    (B = 16 windows, L = 243, J = 17 joints, S = 16 bones, 8 heads), and the
    per-window kernels and the MLPs at the 3DHP model's (B = 25, L = 27):
    K3/K4 on the temporal layers' windows of 27 frames, K5/K6 on 25 * 27 *
    17 and 25 * 27 * 16 rows."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, l, j, s = TRAIN_BATCH, 243, 17, 16
    b3, l3 = DHP3_BATCH, DHP3_SEQ_LEN
    cases = {name: [] for name in KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        for kind in ("attention_dense", "attention_dense_bwd"):
            case = attention_case if kind == "attention_dense" else attention_bwd_case
            cases[kind] += [
                case(kind, "rotations", b * j, 8, l, 64, dtype, gen),
                case(kind, "segments", b * s, 8, l, 16, dtype, gen),
            ]
        for kind in ("attention_packed", "attention_packed_bwd"):
            case = attention_case if kind == "attention_packed" else attention_bwd_case
            cases[kind] += [
                case(kind, "rotations", b * l, 8, j, 64, dtype, gen),
                case(kind, "segments", b * l, 8, s, 16, dtype, gen),
                case(kind, "3dhp-rotations-temporal", b3 * j, 8, l3, 64, dtype, gen),
                case(kind, "3dhp-segments-temporal", b3 * s, 8, l3, 16, dtype, gen),
            ]
        for kind, case in (("fused_mlp", mlp_case), ("fused_mlp_bwd", mlp_bwd_case)):
            cases[kind] += [
                case("rotations", b * l * j, 512, 1024, dtype, gen),
                case("segments", b * l * s, 128, 256, dtype, gen),
                case("3dhp-rotations", b3 * l3 * j, 512, 1024, dtype, gen),
                case("3dhp-segments", b3 * l3 * s, 128, 256, dtype, gen),
            ]
            torch.cuda.empty_cache()
        # a streaming session's firing push: one window (batch 1) a forward
        for kind, trunk, *shape in STREAM_ATTENTION_CASES:
            cases[kind].append(attention_case(kind, trunk, *shape, dtype, gen))
        for trunk, *shape in STREAM_MLP_CASES:
            cases["fused_mlp"].append(mlp_case(trunk, *shape, dtype, gen))
    for name, rows in cases.items():
        for r in rows:
            print(f"kernel {name:20s} {r['trunk']:23s} {r['dtype']:8s} "
                  f"shape={r['shape']} err={r['max_abs_err']:.3g} "
                  f"ms={r['ms']:.4f} "
                  f"({r['tflops']:.1f} TFLOP/s) "
                  f"plain_ms={r['plain_ms']:.4f} "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                  f"library_ms={r['library_ms']:.4f}", flush=True)
    return cases


def bone_lengths(poses: np.ndarray, parents) -> np.ndarray:
    js = [i for i, p in enumerate(parents) if p >= 0]
    ps = [parents[i] for i in js]
    return np.linalg.norm(poses[..., js, :] - poses[..., ps, :], axis=-1)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def require_counts(dtype: str, want: dict, what: str) -> dict:
    """The launches since the last reset: ``want`` for each kernel, all of
    them on ``dtype`` operands. Returns the counts."""
    from manipose_tpu_torch import ops

    counts = ops.launch_counts()
    on_dtype = ops.launch_counts(DTYPES[dtype])
    print(f"{what} launches {counts} ({dtype} operands: {on_dtype})")
    for name in LAUNCHES_PER_TRAIN_STEP:
        n = want.get(name, 0)
        require(counts[name] == n, f"{what}: {name} launched {counts[name]}, want {n}")
        require(on_dtype[name] == n, f"{what}: {name} launched {on_dtype[name]} "
                                     f"times on {dtype} operands, want {n}")
    return counts


def phase_flagship(dtype: str = "float32"):
    from manipose_tpu_torch import ops
    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.serving import Predictor

    cfg = load_config("config", [f"model.dtype={dtype}"])
    predictor = Predictor(cfg=cfg, batch_size=16, tta=True)
    n_windows = 16
    l = cfg.data.seq_len
    video = np.random.default_rng(0).normal(size=(n_windows * l, 17, 2))
    video = video.astype(np.float32)
    predictor.predict_video(video)  # warm-up

    ops.reset_launch_counts()
    poses, hyps, scores = predictor.predict_video(video, return_hypotheses=True)
    n_batches = -(-n_windows // predictor.batch_size)
    counts = require_counts(
        dtype, {k: 2 * n * n_batches for k, n in LAUNCHES_PER_FORWARD.items()},
        f"flagship {dtype} serving ({n_batches} window batch(es))")

    n_hyp = cfg.multi_hyp.n_hyp
    require(poses.shape == (n_windows * l, 17, 3), f"poses shape {poses.shape}")
    require(hyps.shape == (n_windows, n_hyp, l, 17, 3), f"hyps shape {hyps.shape}")
    require(scores.shape == (n_windows, n_hyp, l, 1), f"scores shape {scores.shape}")
    for name, a in (("poses", poses), ("hyps", hyps), ("scores", scores)):
        require(bool(np.isfinite(a).all()), f"{name} not finite")
    score_err = float(np.abs(scores.sum(axis=1) - 1.0).max())
    require(score_err <= 1e-5, f"scores sum to 1 over H within 1e-5 ({score_err})")
    lengths = bone_lengths(hyps, predictor.skeleton.parents)  # (W, H, L, S)
    spread = float((lengths.max(axis=2) - lengths.min(axis=2)).max())
    limit = 1e-5 * max(1.0, float(np.abs(lengths).max()))
    require(spread <= limit, f"bone lengths constant over frames ({spread} > {limit})")

    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        predictor.predict_video(video)
    dt = (time.perf_counter() - t0) / reps
    fps = video.shape[0] / dt
    print(f"flagship predict_video: {video.shape[0]} frames in {dt * 1e3:.2f} ms "
          f"-> {fps:.1f} frames/s (mean of {reps}, TTA on, batch 16, {dtype}); "
          f"score err {score_err:.3g}, bone-length spread {spread:.3g}", flush=True)
    return predictor, counts, fps


def rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    """max |got - ref| over max(1, |ref|max)."""
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def phase_cpu_vs_card(card_predictor) -> None:
    """One flagship window (TTA off) on the CPU (plain versions) and on the
    card (kernels), same weights and dtype. fp32: within MODEL_TOL. bf16:
    the scores and both branches' outputs within BF16_TOL; poses and
    hypotheses within the larger of BF16_TOL and 2 * the CPU's bf16 spread
    under a one-ulp input nudge + GAP_SLACK."""
    from manipose_tpu_torch.serving import Predictor

    cfg = card_predictor.cfg
    dtype = cfg.model.get("dtype", "float32")
    bf16 = dtype == "bfloat16"
    state = {k: v.cpu() for k, v in card_predictor.model.state_dict().items()}
    window = np.random.default_rng(1).normal(size=(cfg.data.seq_len, 17, 2))
    window = window.astype(np.float32)
    outs, branches = {}, {}
    for device in ("cpu", "cuda"):
        pred = Predictor(cfg=cfg, state_dict=state, batch_size=1, tta=False,
                         device=device)
        outs[device] = pred.predict_video(window, return_hypotheses=True)
        if bf16:  # both branches alone, before FK
            x = torch.from_numpy(window[None]).to(pred.device)
            with torch.inference_mode():
                hyps6d, scores = pred.model.rotations_module(x)
                lengths = pred.model.segments_module(x)
            branches[device] = [t.float().cpu().numpy() for t in (hyps6d, scores, lengths)]
            if device == "cpu":
                nudged = pred.predict_video(window * BF16_NUDGE, return_hypotheses=True)
    errs = {}
    for i, name in enumerate(("poses", "hyps", "scores")):
        ref, got = outs["cpu"][i], outs["cuda"][i]
        if not bf16:
            err = float(np.abs(ref - got).max())
            tol = MODEL_TOL * max(1.0, float(np.abs(ref).max()))
        else:
            err, tol = rel_err(got, ref), BF16_TOL
            if name != "scores":
                spread = rel_err(nudged[i], ref)
                tol = max(BF16_TOL, 2 * spread + GAP_SLACK)
                name = f"{name} (cpu bf16 spread {spread:.3g})"
        require(err <= tol, f"cpu vs card {dtype} {name}: {err} > {tol}")
        errs[name] = (err, tol)
    if bf16:
        for name, got, ref in zip(("rotations-branch hypotheses (6D, before FK)",
                                   "rotations-branch scores", "segments-branch lengths"),
                                  branches["cuda"], branches["cpu"]):
            err = rel_err(got, ref)
            require(err <= BF16_TOL, f"cpu vs card bf16 {name}: {err} > {BF16_TOL}")
            errs[name] = (err, BF16_TOL)
    scale = " relative to max(1, |ref|max)" if bf16 else ""
    print(f"cpu vs card {dtype} (one flagship window, TTA off){scale}: "
          + ", ".join(f"{k} err {e:.3g} (tol {t:.3g})" for k, (e, t) in errs.items()),
          flush=True)


def flagship_batch(seq_len: int, batch: int):
    """bench.py's synthetic train batch: x ~ N(0, 1) 2D keypoints, y ~
    0.1 N(0, 1) 3D poses, from numpy seed 0."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch, seq_len, 17, 2)).astype(np.float32)
    y = (0.1 * rng.normal(size=(batch, seq_len, 17, 3))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def make_trainer(cfg, device, state_dict=None):
    """The flagship model of ``cfg`` on ``device`` (seeded init, or
    ``state_dict``), Adam and the train step."""
    from manipose_tpu_torch.drivers import instantiate_model
    from manipose_tpu_torch.geometry import h36m_skeleton_17
    from manipose_tpu_torch.train import (
        LossConfig,
        TrainState,
        make_train_step,
        optimizer_from_config,
    )

    skeleton = h36m_skeleton_17()
    model, _ = instantiate_model(cfg, skeleton)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    # Adam with weight decay 1e-6 (bench.py's) and the config's grad_clip and
    # skip_nonfinite, as the JAX train loop builds it
    opt = optimizer_from_config(model, cfg)
    state = TrainState.create(model, opt, seed=cfg.run.seed, device=device)
    t = cfg.train
    loss_cfg = LossConfig(sq_loss=t.sq_loss, w_loss=t.w_loss, vel_loss=t.vel_loss,
                          smooth_reg=t.smooth_reg, rmcl_score_reg=t.rmcl_score_reg,
                          rigid_seg_reg=t.rigid_seg_reg, rmcl=True)
    return state, make_train_step(model, loss_cfg, skeleton, opt)


def require_finite(metrics, what: str) -> None:
    for k, v in metrics.items():
        require(bool(torch.isfinite(v)), f"{what}: loss term {k} = {float(v)}")


def phase_train(dtype: str = "float32"):
    """The flagship train step on the card: B = 16 synthetic windows in
    ``dtype``, drop-path at the config's 0.1 from the state's seeded
    generator."""
    from manipose_tpu_torch import ops
    from manipose_tpu_torch.config import load_config

    cfg = load_config("config", [f"model.dtype={dtype}"])
    require(cfg.model.drop_path_rate > 0, "the flagship trains with drop-path on")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()  # what earlier phases still hold
    state, step = make_trainer(cfg, "cuda")
    x, y = (t.cuda() for t in flagship_batch(cfg.data.seq_len, TRAIN_BATCH))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    history = [step(state, x, y, TRAIN_LR)]
    torch.cuda.synchronize()
    counts = require_counts(dtype, LAUNCHES_PER_TRAIN_STEP, f"{dtype} train step")
    n_params = 0
    for name, p in state.model.named_parameters():
        require(p.grad is not None, f"{name} got no gradient")
        require(bool(torch.isfinite(p.grad).all()), f"{name}'s gradient not finite")
        n_params += 1

    history.append(step(state, x, y, TRAIN_LR))  # second warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        history.append(step(state, x, y, TRAIN_LR))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    for i, metrics in enumerate(history):
        require_finite(metrics, f"train step {i}")
    # the phase's own peak: its model, optimizer, batch and step
    peak_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
    seq_s = TRAIN_BATCH / dt
    losses = " ".join(f"{float(m['loss']):.5f}" for m in history)
    print(f"train: {n_params} parameters, every gradient finite after the first "
          f"backward; losses per step {losses}")
    print(f"flagship train step: {dt * 1e3:.2f} ms -> {seq_s:.2f} sequences/s "
          f"(mean of {TRAIN_STEPS} after 2 warm-ups, B={TRAIN_BATCH}, {dtype}, "
          f"drop-path {cfg.model.drop_path_rate}); peak device memory "
          f"{peak_gb:.2f} GB", flush=True)
    if dtype == "bfloat16":  # bench.py's metric (the JAX flagship trains in bf16)
        print(f"rmcl_manipose_243f_train_throughput {seq_s:.3f} seq/s (bf16, "
              f"B={TRAIN_BATCH}, L={cfg.data.seq_len}, one card)", flush=True)
    return state, step, (x, y), counts, seq_s, peak_gb


def train_step_on(cfg, device, weights, x, y):
    """One train step of ``cfg``'s model from ``weights`` on ``device``:
    (metrics as floats, gradients on the CPU)."""
    state, step = make_trainer(cfg, device, state_dict=weights)
    metrics = {k: float(v) for k, v in step(state, x, y, TRAIN_LR).items()}
    return metrics, {n: p.grad.cpu() for n, p in state.model.named_parameters()}


def phase_cpu_vs_card_train(trained_state):
    """One flagship train step on one window, drop-path off, on the CPU
    (plain versions) and on the card (kernels) from the same weights: the
    loss terms within 5e-5 relative, every gradient within 5e-4 of its
    magnitude. Returns the weights."""
    from manipose_tpu_torch.config import load_config

    cfg = load_config("config", ["model.drop_path_rate=0.0"])
    weights = {k: v.detach().cpu() for k, v in trained_state.model.state_dict().items()}
    x, y = (t[:1] for t in flagship_batch(cfg.data.seq_len, 1))
    metrics, grads = {}, {}
    for device in ("cpu", "cuda"):
        metrics[device], grads[device] = train_step_on(cfg, device, weights, x, y)
    worst = 0.0
    for k, want in metrics["cpu"].items():
        err = abs(metrics["cuda"][k] - want)
        require(err <= TRAIN_LOSS_TOL * abs(want),
                f"cpu vs card train {k}: {metrics['cuda'][k]} vs {want}")
        worst = max(worst, err / abs(want))
    worst_grad = ("", 0.0)
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        require(bool(torch.isfinite(got).all()), f"card gradient {name} not finite")
        require(err <= GRAD_TOL[torch.float32] * scale,
                f"cpu vs card gradient {name}: {err} > {GRAD_TOL[torch.float32] * scale}")
        if err / scale > worst_grad[1]:
            worst_grad = (name, err / scale)
    print(f"cpu vs card train step (one flagship window, drop-path off): loss "
          f"{metrics['cpu']['loss']:.6f} cpu, {metrics['cuda']['loss']:.6f} card, "
          f"worst term rel err {worst:.3g} (tol {TRAIN_LOSS_TOL}); worst gradient "
          f"err / max(1, |g|max) {worst_grad[1]:.3g} at {worst_grad[0]} "
          f"(tol {GRAD_TOL[torch.float32]}) over {len(grads['cpu'])} tensors",
          flush=True)
    return weights


def branch_grads(cfg, device, weights, x):
    """Each parameter's gradient (on the CPU) of both branches' outputs of
    ``cfg``'s model from ``weights`` on ``x`` (drop-path off) under a fixed
    random cotangent, drawn on the CPU from seed 0."""
    from manipose_tpu_torch.drivers import instantiate_model
    from manipose_tpu_torch.geometry import h36m_skeleton_17

    model, _ = instantiate_model(cfg, h36m_skeleton_17())
    model.load_state_dict(weights, strict=True)
    model.to(device).train()
    x = x.to(device)
    hyps6d, scores = model.rotations_module(x)
    outs = (hyps6d, scores, model.segments_module(x))
    gen = torch.Generator().manual_seed(0)
    total = sum((t.float() * torch.randn(t.shape, generator=gen).to(device)).sum()
                for t in outs)
    total.backward()
    return {n: p.grad.cpu() for n, p in model.named_parameters()}


def phase_cpu_vs_card_train_bf16(weights) -> None:
    """One flagship train step on one window under bf16 compute, drop-path
    off, on the CPU and on the card from the fp32 phase's weights: each loss
    term within BF16_TOL of the larger of its size and GAP_SLACK times the
    total loss (a term under a thousandth of the loss can sit at bf16's
    rounding: the smoothness term of nearly constant poses, a sum of
    squared differences of bf16 values), every gradient fp32 and finite;
    and each
    parameter's gradient of both branches' outputs under a fixed cotangent
    (every kernel forward and backward, the trunks and heads, without FK
    and the WTA loss) within BF16_TOL relative in norm, or 2 * the CPU's
    bf16 spread + GAP_SLACK where that is larger."""
    from manipose_tpu_torch.config import load_config

    cfg = load_config("config", ["model.drop_path_rate=0.0", "model.dtype=bfloat16"])
    x, y = (t[:1] for t in flagship_batch(cfg.data.seq_len, 1))
    t0 = time.perf_counter()
    cpu_metrics, cpu_grads = train_step_on(cfg, "cpu", weights, x, y)
    cpu_s = time.perf_counter() - t0
    metrics, grads = train_step_on(cfg, "cuda", weights, x, y)
    worst_term = ("", 0.0)
    for k, want in cpu_metrics.items():
        scale = max(abs(want), GAP_SLACK * abs(cpu_metrics["loss"]))
        err = abs(metrics[k] - want) / scale
        require(err <= BF16_TOL, f"cpu vs card bf16 train {k}: {metrics[k]} vs {want} "
                                 f"({err} of {scale} > {BF16_TOL})")
        if err >= worst_term[1]:
            worst_term = (k, err)
    step_worst = ("", 0.0)
    for name, want in cpu_grads.items():
        got = grads[name]
        require(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
                f"card bf16 gradient {name} fp32 and finite")
        err = (got - want).norm().item() / max(want.norm().item(), 1e-30)
        if err > step_worst[1]:
            step_worst = (name, err)
    want = branch_grads(cfg, "cpu", weights, x)
    nudged = branch_grads(cfg, "cpu", weights, x * BF16_NUDGE)
    want32 = branch_grads(load_config("config", ["model.drop_path_rate=0.0"]), "cpu",
                          weights, x)
    got = branch_grads(cfg, "cuda", weights, x)

    def rel(a, b):
        return (a - b).norm().item() / b.norm().item()

    worst, widened = ("", 0.0, 0.0, 0.0), 0
    for name, w in want.items():
        spread = max(rel(nudged[name], w), rel(w, want32[name]))
        tol = max(BF16_TOL, 2 * spread + GAP_SLACK)
        err = rel(got[name], w)
        require(err <= tol, f"cpu vs card bf16 branch gradient {name}: {err} > {tol} "
                            f"(cpu bf16 spread {spread})")
        widened += tol > BF16_TOL
        if err / tol > worst[1]:
            worst = (name, err / tol, err, tol)
    print(f"cpu vs card bf16 train step (one flagship window, drop-path off; the "
          f"CPU step took {cpu_s:.1f} s): loss {cpu_metrics['loss']:.6f} cpu, "
          f"{metrics['loss']:.6f} card, worst term err {worst_term[1]:.3g} at "
          f"{worst_term[0]} (of max(|term|, {GAP_SLACK} |loss|); tol {BF16_TOL}); every "
          f"gradient fp32 and finite (through "
          f"FK and WTA, not held: worst rel err in norm {step_worst[1]:.3g} at "
          f"{step_worst[0]}); branch gradients under a fixed cotangent: worst err/tol "
          f"{worst[1]:.3g} at {worst[0]} (rel err in norm {worst[2]:.3g}, tol "
          f"{worst[3]:.3g}) over {len(want)} tensors, {widened} of them with a cpu "
          f"bf16 spread past the {BF16_TOL} floor", flush=True)


def phase_bf16_accuracy(cases) -> None:
    """bf16 K1-K4 at the flagship's shapes against fp64 from the same bf16
    inputs, beside their plain versions and the errors with P and dS in
    one bf16 part; the kernels' bf16 times from phase 2 beside those."""
    from manipose_tpu_torch.ops.probes.run_probes import bf16_attention_errors

    gen = torch.Generator(device="cuda").manual_seed(1)
    b, l, j, s = TRAIN_BATCH, 243, 17, 16
    for kind, trunk, windows, n, d in (("dense", "rotations", b * j, l, 64),
                                       ("dense", "segments", b * s, l, 16),
                                       ("packed", "rotations", b * l, j, 64),
                                       ("packed", "segments", b * l, s, 16)):
        qkv = torch.randn((windows, n, 3, 8, d), generator=gen, device="cuda").bfloat16()
        dout = torch.randn((windows, n, 8, d), generator=gen, device="cuda").bfloat16()
        errs = bf16_attention_errors(kind, qkv, dout.transpose(1, 2), d**-0.5)
        del qkv, dout
        torch.cuda.empty_cache()
        line = []
        for name, (kernel, plain) in errs.items():
            ratio = (K2_BF16_ACCURACY_RATIO if kind == "dense" and name != "out"
                     else BF16_ACCURACY_RATIO)
            bound = ratio * plain + BF16_ACCURACY_SLACK
            before = ONE_PART_BF16_ERRORS.get((kind, trunk, name))
            from_o = DELTA_FROM_O_BF16_RATIOS.get((trunk, name)) if kind == "dense" else None
            line.append(f"{name} {kernel:.4e} (plain {plain:.4e}, ratio {kernel / plain:.4f}"
                        f" <= {ratio}"
                        + (f", one part {before:.3e}" if before else "")
                        + (f", delta from O {from_o:.4f}" if from_o else "") + ")")
            require(kernel <= bound, f"bf16 {kind} {trunk} {name}: error against fp64 "
                                     f"{kernel} > {ratio} x plain {plain} "
                                     f"+ {BF16_ACCURACY_SLACK}")
        print(f"bf16 accuracy {kind:6s} {trunk:9s} {windows}*8 x {n} x {d} against fp64: "
              + "; ".join(line), flush=True)
    for name in ("attention_dense", "attention_dense_bwd", "attention_packed",
                 "attention_packed_bwd"):
        for c in cases[name]:
            if c["dtype"] == "bfloat16" and (name, c["trunk"]) in ONE_PART_BF16_MS:
                from_o = (f", delta from O {DELTA_FROM_O_BF16_MS[c['trunk']]:.4f} ms"
                          if name == "attention_dense_bwd" else "")
                print(f"bf16 time {name:20s} {c['trunk']:9s} {c['ms']:.4f} ms "
                      f"(one part {ONE_PART_BF16_MS[(name, c['trunk'])]:.4f} ms{from_o}), "
                      f"{c['tflops']:.1f} TFLOP/s", flush=True)


def write_h36m(data_dir: Path, seed: int, frames: int = EVAL_FRAMES,
               train_frames: int = EVAL_FRAMES, s9_frames: int = S9_FRAMES,
               scale_2d: float = 1.0) -> None:
    """H36M-format npz files (``data_3d_h36m.npz`` with 32-joint world
    positions in meters, ``data_2d_h36m_cpn_ft_h36m_dbb.npz`` with pixel
    detections per camera, times ``scale_2d``) for EVAL_ACTIONS of S11
    (``frames`` frames), of the train subject S1 (``train_frames``) and of
    S9 (``s9_frames``; the validation split is the test subjects, S9 and
    S11), from ``seed``. S11 draws first from the seed's stream, as it did
    alone; S1 and S9 from (seed, 1)."""
    subjects = {"S11": (np.random.default_rng(seed), frames)}
    extra = np.random.default_rng([seed, 1])
    subjects.update({"S1": (extra, train_frames), "S9": (extra, s9_frames)})
    positions_3d, positions_2d = {}, {}
    for subject, (rng, n) in subjects.items():
        positions_3d[subject] = {a: rng.normal(scale=0.3, size=(n, 32, 3)).astype(np.float32)
                                 for a in EVAL_ACTIONS}
        positions_2d[subject] = {a: [(rng.uniform(0, 1000, size=(n, 17, 2)) * scale_2d)
                                     .astype(np.float32) for _ in range(4)]
                                 for a in EVAL_ACTIONS}
    np.savez(data_dir / "data_3d_h36m.npz", positions_3d=positions_3d)
    np.savez(data_dir / "data_2d_h36m_cpn_ft_h36m_dbb.npz", positions_2d=positions_2d)


def eval_config(dtype: str, data_dir: Path, extra=()):
    from manipose_tpu_torch.config import load_config

    return load_config("config", [
        f"model.dtype={dtype}", f"data.data_dir={data_dir}",
        f"run.output_dir={data_dir / 'outputs'}", f"run.experiment=eval_{dtype}",
        "run.train=false", f"data.actions={','.join(EVAL_ACTIONS.values())}", *extra])


def eval_model(cfg, device):
    """The flagship model of ``cfg`` with the seeded init that the driver
    gives it, on ``device``."""
    from manipose_tpu_torch.drivers import instantiate_model
    from manipose_tpu_torch.geometry import h36m_skeleton_17

    return instantiate_model(cfg, h36m_skeleton_17())[0].to(device).eval()


def phase_eval(dtype: str, data_dir: Path):
    """The eval-only driver at the flagship on the card. Returns (launch
    counts, eval frames/s)."""
    import csv

    from manipose_tpu_torch import ops
    from manipose_tpu_torch.data import native
    from manipose_tpu_torch.drivers import create_loader, h36m
    from manipose_tpu_torch.eval.engine import EvalConfig, evaluate
    from manipose_tpu_torch.utils.logging import MetricLogger

    cfg = eval_config(dtype, data_dir)
    native.load_library()  # raises when the core does not build
    print(f"windowing: the native core, {native.library_path().relative_to(ROOT)} "
          f"(built with g++ from native/windowing.cpp)", flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logger = MetricLogger()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    require(h36m.main(cfg, logger=logger) is None, "eval-only main returns None")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
    per_action = -(-4 * (EVAL_FRAMES // cfg.data.seq_len) // cfg.train.batch_size_test)
    n_batches = len(EVAL_ACTIONS) * per_action
    counts = require_counts(
        dtype, {k: 2 * n * n_batches for k, n in LAUNCHES_PER_FORWARD.items()},
        f"eval {dtype} ({n_batches} batches of {cfg.train.batch_size_test}, TTA)")

    timed = [r for r in logger.history if "eval_seconds" in r]
    require(len(timed) == len(EVAL_ACTIONS), f"one evaluate per action: {timed}")
    with open(Path(cfg.run.output_dir) / cfg.run.experiment / "protocol_1_err.csv",
              newline="") as f:
        head, *rows = list(csv.reader(f))
    values = np.asarray([r[1:] for r in rows], float)
    require(values.shape == (len(EVAL_ACTIONS) + 1, 10), f"protocol table {values.shape}")
    require(bool(np.isfinite(values).all()), f"protocol table finite: {rows}")

    # eval frames/s: one action's evaluate, warm, repeated over a window of
    # EVAL_WINDOW_S or more (host clock, each call ended by its last
    # harvest); then the device's busy share of a window of as many calls
    # under the profiler
    keypoints, dataset = h36m.fetch_and_prepare_data(cfg)
    loader = create_loader(keypoints, dataset, ["walking"], ["S11"], cfg, train=False)
    model = eval_model(cfg, "cuda")
    eval_cfg = EvalConfig(tta=cfg.train.tta)
    evaluate(model, loader, dataset.skeleton, eval_cfg)  # warm-up
    frames = len(loader.dataset) * cfg.data.seq_len
    calls = []
    while sum(calls) < EVAL_WINDOW_S:
        t0 = time.perf_counter()
        evaluate(model, loader, dataset.skeleton, eval_cfg)
        calls.append(time.perf_counter() - t0)
    fps = frames * len(calls) / sum(calls)
    per_call = [frames / c for c in calls]
    wall_ms, busy_ms = profile_call(
        f"{dtype} evaluate of one action, {len(calls)} calls",
        lambda: [evaluate(model, loader, dataset.skeleton, eval_cfg) for _ in calls])
    busy = f"{100 * busy_ms / wall_ms:.1f} %" if busy_ms else "not measured"
    driver = ", ".join("{} {} frames in {:.3f} s".format(
        r["action"], r["eval_frames"], r["eval_seconds"]) for r in timed)
    print(f"eval {dtype}: {fps:.1f} frames/s over {len(calls)} warm calls of one action's "
          f"evaluate ({frames} frames each) in {sum(calls):.3f} s (host clock to the last "
          f"harvest; per call min {min(per_call):.1f}, median "
          f"{float(np.median(per_call)):.1f}, max {max(per_call):.1f} frames/s); device "
          f"busy {busy} of a profiled window of as many calls; the driver: {driver}; "
          f"main {main_s:.1f} s; peak device memory {peak_gb:.2f} GB", flush=True)
    print(f"eval {dtype} protocol average: "
          + ", ".join(f"{h} {v:.4f}" for h, v in zip(head[1:], values[-1])), flush=True)
    return counts, fps


def eval_windows(cfg):
    """One action (walking), one camera and 2 windows of S11 from the
    phase's npz files: (2D keypoints (2L, J, 2), skeleton)."""
    from manipose_tpu_torch.data import fetch
    from manipose_tpu_torch.drivers import h36m

    keypoints, dataset = h36m.fetch_and_prepare_data(cfg)
    _, poses_2d, _, _ = fetch(["S11"], dataset, keypoints, ["walking"])
    return poses_2d[0][:2 * cfg.data.seq_len], dataset.skeleton


def eval_targets(cfg, pose_2d: np.ndarray) -> np.ndarray:
    """3D targets (2L, J, 3) in meters at the model's own scale: for each
    frame, one of the CPU model's hypotheses on ``pose_2d`` (the index
    drawn from ``run.seed``) plus N(0, EVAL_TARGET_NOISE_M) noise."""
    seq_len = cfg.data.seq_len
    x = torch.from_numpy(pose_2d.reshape(2, seq_len, *pose_2d.shape[1:]))
    with torch.inference_mode():
        hyps, _ = eval_model(cfg, "cpu")(x)  # (2, H, L, J, 3)
    hyps = hyps.float().numpy()
    rng = np.random.default_rng(cfg.run.seed)
    pick = rng.integers(0, hyps.shape[1], size=(2, seq_len))
    chosen = np.take_along_axis(hyps, pick[:, None, :, None, None], axis=1)[:, 0]
    noise = rng.normal(scale=EVAL_TARGET_NOISE_M, size=chosen.shape)
    return (chosen + noise).astype(np.float32).reshape(2 * seq_len, *chosen.shape[2:])


def eval_on(cfg, device, pose_2d: np.ndarray, targets: np.ndarray, skeleton):
    """``evaluate`` of 2 windows in one batch of ``train.batch_size_test`` =
    3 (one padded row) on ``device``: the predictions (mm), the MPJPE,
    oracle and pseudo-oracle MPJPE, and the P-MPJPE of the oracle poses, as
    the protocol takes it."""
    from manipose_tpu_torch.data import PoseSequenceDataset, SequenceLoader
    from manipose_tpu_torch.eval.engine import EvalConfig, evaluate
    from manipose_tpu_torch.metrics import p_mpjpe

    ds = PoseSequenceDataset([targets], [pose_2d], seq_len=cfg.data.seq_len)
    loader = SequenceLoader(ds, batch_size=cfg.train.batch_size_test)
    require(len(ds) == 2 and len(loader) == 1, "2 windows in one padded batch")
    preds, ys, mpjpe, oracle, psoracle, oracle_preds = evaluate(
        eval_model(cfg, device), loader, skeleton, EvalConfig(tta=cfg.train.tta))
    pm = float(p_mpjpe(torch.from_numpy(oracle_preds[0]).to(device),
                       torch.from_numpy(ys[0] * 1000.0).to(device)))
    return preds[0], {"mpjpe": mpjpe, "oracle mpjpe": oracle,
                      "pseudo oracle mpjpe": psoracle, "p-mpjpe": pm}


def phase_eval_cpu_vs_card(dtype: str, data_dir: Path) -> None:
    """``evaluate`` of 2 windows (one padded row) on the CPU and the card
    from the same weights, against targets at the model's own scale
    (``eval_targets``). fp32: predictions within MODEL_TOL of their
    magnitude, the four metrics within EVAL_METRIC_TOL relative. bf16: each
    within max(BF16_TOL, 2 * the CPU's bf16 spread under a one-ulp input
    nudge + GAP_SLACK), relative to max(1, |ref|)."""
    cfg = eval_config(dtype, data_dir, ["train.batch_size_test=3"])
    pose_2d, skeleton = eval_windows(cfg)
    t0 = time.perf_counter()
    targets = eval_targets(eval_config("float32", data_dir), pose_2d)
    ref_preds, ref = eval_on(cfg, "cpu", pose_2d, targets, skeleton)
    cpu_s = time.perf_counter() - t0
    got_preds, got = eval_on(cfg, "cuda", pose_2d, targets, skeleton)
    require(got_preds.shape == (2, cfg.data.seq_len, 17, 3), f"preds {got_preds.shape}")
    errs = {}
    if dtype == "float32":
        err = float(np.abs(got_preds - ref_preds).max())
        errs["predictions"] = (err, MODEL_TOL * max(1.0, float(np.abs(ref_preds).max())))
        for k, want in ref.items():
            errs[k] = (abs(got[k] - want), EVAL_METRIC_TOL * abs(want))
    else:
        nudged_preds, nudged = eval_on(cfg, "cpu", pose_2d * BF16_NUDGE, targets, skeleton)
        spread = rel_err(nudged_preds, ref_preds)
        errs["predictions"] = (rel_err(got_preds, ref_preds),
                               max(BF16_TOL, 2 * spread + GAP_SLACK))
        for k, want in ref.items():
            spread = rel_err(np.asarray(nudged[k]), np.asarray(want))
            errs[k] = (rel_err(np.asarray(got[k]), np.asarray(want)),
                       max(BF16_TOL, 2 * spread + GAP_SLACK))
    for k, (err, tol) in errs.items():
        require(err <= tol, f"eval cpu vs card {dtype} {k}: {err} > {tol}")
    print(f"eval cpu vs card {dtype} (2 windows, one padded row, targets a seeded "
          f"hypothesis + {1000 * EVAL_TARGET_NOISE_M:g} mm noise a coordinate; the CPU "
          f"took {cpu_s:.1f} s): " + ", ".join(f"{k} err {e:.3g} (tol {t:.3g})"
                                               for k, (e, t) in errs.items())
          + "; cpu " + ", ".join(f"{k} {v:.4f}" for k, v in ref.items())
          + "; card " + ", ".join(f"{k} {v:.4f}" for k, v in got.items()), flush=True)


def train_config(dtype: str, data_dir: Path, extra=()):
    """The training driver at the flagship on the phases' npz files: S1
    trains (data.data=one), DRIVER_EPOCHS epochs of TRAIN_BATCH windows with
    validation and MPJPE every epoch, then the test protocol on S11."""
    from manipose_tpu_torch.config import load_config

    return load_config("config", [
        f"model.dtype={dtype}", f"data.data_dir={data_dir}",
        f"run.output_dir={data_dir / 'outputs'}", f"run.experiment=train_{dtype}",
        "run.train=true", "run.test=true", "data.data=one",
        f"data.actions={','.join(EVAL_ACTIONS.values())}", f"train.epochs={DRIVER_EPOCHS}",
        f"train.batch_size={TRAIN_BATCH}", "train.valid_epoch_interval=1",
        "train.mpjpe_epoch_interval=1", *extra])


def run_dir(cfg) -> Path:
    return Path(cfg.run.output_dir) / cfg.run.experiment


def epoch_rows(logger) -> list:
    """The train loop's per-epoch rows of the driver's log."""
    return [r for r in logger.history if "tr_loss" in r]


def print_epochs(what: str, rows) -> None:
    for r in rows:
        print(f"{what} epoch {r['step']}: {r['seq_per_sec']:.2f} train sequences/s (the "
              f"meter, steps 2..); wall s: train {r['train_seconds']:.3f}, validation loss "
              f"{r['valid_seconds']:.3f}, MPJPE eval {r['mpjpe_seconds']:.3f}, checkpoint "
              f"writes {r['checkpoint_seconds']:.3f} (launching thread), epoch "
              f"{r['epoch_seconds']:.3f}; train loss {r['tr_loss']:.6f}, val loss "
              f"{r.get('val_loss', float('nan')):.6f}, val MPJPE "
              f"{r.get('val_mpjpe', float('nan')):.4f} mm; peak device memory "
              f"{r.get('peak_memory_gb', float('nan')):.2f} GB", flush=True)


def phase_train_driver(dtype: str, data_dir: Path):
    """The training driver (``drivers.h36m.main``, run.train=true) at the
    flagship on the card: all six kernels launched, every launch on the
    dtype's operands and the backward kernels once a layer a step; finite
    losses; every tag and the last resume state written; the protocol
    table finite. Returns (launch counts, per-epoch log rows)."""
    import csv

    from manipose_tpu_torch import ops
    from manipose_tpu_torch.drivers import h36m
    from manipose_tpu_torch.utils.logging import MetricLogger

    cfg = train_config(dtype, data_dir)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    logger = MetricLogger()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    best = h36m.main(cfg, logger=logger)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts, on_dtype = ops.launch_counts(), ops.launch_counts(DTYPES[dtype])
    steps = DRIVER_EPOCHS * -(-len(EVAL_ACTIONS) * 4 * (EVAL_FRAMES // cfg.data.seq_len)
                              // TRAIN_BATCH)
    print(f"train driver {dtype} launches {counts} ({dtype} operands: {on_dtype}); "
          f"{steps} train steps")
    for name in KERNELS:
        require(counts[name] > 0, f"train driver {dtype}: {name} launched")
        require(on_dtype[name] == counts[name],
                f"train driver {dtype}: {name} launched {counts[name] - on_dtype[name]} "
                f"times on other than {dtype} operands")
        if name.endswith("_bwd"):
            want = LAUNCHES_PER_TRAIN_STEP[name] * steps
            require(counts[name] == want, f"train driver {dtype}: {name} launched "
                                          f"{counts[name]}, want {want}")
    out = run_dir(cfg)
    losses = {n: np.load(out / f"{n}.npy") for n in ("train_loss", "valid_loss")}
    for n, v in losses.items():
        require(v.shape == (DRIVER_EPOCHS,) and bool(np.isfinite(v).all()), f"{n} {v}")
    require(best is not None and bool(np.isfinite(best)), f"best validation MPJPE {best}")
    for tag in RUN_TAGS:
        require((out / tag / "model.pth").is_file(), f"train driver {dtype}: tag {tag}")
    require((out / RUN_TAGS[-1] / "host_state.json").is_file(), "resume state committed")
    with open(out / "protocol_1_err.csv", newline="") as f:
        head, *rows = list(csv.reader(f))
    values = np.asarray([r[1:] for r in rows], float)
    require(values.shape == (len(EVAL_ACTIONS) + 1, 10) and bool(np.isfinite(values).all()),
            f"protocol table after training: {rows}")
    epochs = epoch_rows(logger)
    require([r["step"] for r in epochs] == list(range(DRIVER_EPOCHS)), f"epochs {epochs}")
    print_epochs(f"train driver {dtype}", epochs)
    print(f"train driver {dtype}: main {main_s:.1f} s; train losses {losses['train_loss']}, "
          f"validation losses {losses['valid_loss']}, best validation MPJPE {best:.4f} mm; "
          f"protocol average: " + ", ".join(f"{h} {v:.4f}" for h, v in
                                            zip(head[1:], values[-1])), flush=True)
    return counts, epochs


def phase_resume(data_dir: Path) -> None:
    """The bf16 run relaunched with train.epochs=DRIVER_EPOCHS + 1 and
    run.auto_resume=true: it resumes at epoch DRIVER_EPOCHS and trains that
    one epoch."""
    from manipose_tpu_torch.drivers import h36m
    from manipose_tpu_torch.utils.logging import MetricLogger

    cfg = train_config("bfloat16", data_dir, [f"train.epochs={DRIVER_EPOCHS + 1}",
                                              "run.auto_resume=true", "run.test=false"])
    logger = MetricLogger()
    t0 = time.perf_counter()
    h36m.main(cfg, logger=logger)
    main_s = time.perf_counter() - t0
    epochs = epoch_rows(logger)
    require([r["step"] for r in epochs] == [DRIVER_EPOCHS],
            f"resumed run trained epochs {[r['step'] for r in epochs]}, want "
            f"[{DRIVER_EPOCHS}]")
    losses = np.load(run_dir(cfg) / "train_loss.npy")
    require(losses.shape == (1,) and bool(np.isfinite(losses).all()), f"resumed losses {losses}")
    require((run_dir(cfg) / f"train_state_{DRIVER_EPOCHS + 1:06d}" / "host_state.json")
            .is_file(), "the resumed run's resume state")
    print_epochs("resume bf16", epochs)
    print(f"resume bf16 (run.auto_resume=true): started at epoch {epochs[0]['step']} and "
          f"trained 1 epoch, train loss {losses[0]:.6f}; main {main_s:.1f} s", flush=True)


def phase_serve_run_dir(data_dir: Path) -> None:
    """``Predictor.from_any`` on the fp32 training run's directory, tag
    best_mpjpe, on the card: one 243-frame window of S11 within MODEL_TOL
    of the magnitude of the trained model's own eval forward (``evaluate``
    with TTA of the tag's weights, restored into the flagship model, batch
    1 as the Predictor's)."""
    from manipose_tpu_torch.data import PoseSequenceDataset, SequenceLoader
    from manipose_tpu_torch.eval.engine import EvalConfig, evaluate
    from manipose_tpu_torch.serving import Predictor
    from manipose_tpu_torch.train.checkpoint import restore_checkpoint

    cfg = train_config("float32", data_dir)
    pose_2d, skeleton = eval_windows(cfg)
    window = pose_2d[:cfg.data.seq_len]
    pred = Predictor.from_any(str(run_dir(cfg)), tag="best_mpjpe", cfg=cfg, batch_size=1,
                              tta=True)
    got = pred.predict_video(window) * 1000.0  # mm
    model = restore_checkpoint(run_dir(cfg), "best_mpjpe", eval_model(cfg, "cuda"))
    ds = PoseSequenceDataset([np.zeros((len(window), 17, 3), np.float32)], [window],
                             seq_len=cfg.data.seq_len)
    want = evaluate(model, SequenceLoader(ds, batch_size=1), skeleton,
                    EvalConfig(tta=True))[0][0][0]
    require(got.shape == want.shape == (cfg.data.seq_len, 17, 3), f"{got.shape} {want.shape}")
    err = float(np.abs(got - want).max())
    tol = MODEL_TOL * float(np.abs(want).max())
    require(err <= tol, f"from_any on the run directory: {err} > {tol}")
    print(f"from_any(<run directory {run_dir(cfg).name}>, tag=best_mpjpe) on the card: one "
          f"window of 243 frames within {err:.3g} mm of the trained model's eval forward "
          f"(tol {tol:.3g} mm)", flush=True)


def phase_loop_cpu_vs_card(data_dir: Path) -> None:
    """One epoch of the training driver on the CPU and on the card from the
    same seeded weights (LOOP_OVERRIDES: flagship widths, depth 2, L = 27,
    fp32, drop-path 0; S1's LOOP_FRAMES-frame videos train): the epoch's
    train loss within LOOP_LOSS_TOL relative; the validation loss within
    2 * the CPU's own change when its 2D inputs move by +-MODEL_TOL (the
    card's forward tolerance; the larger of the two) + LOOP_LOSS_TOL;
    every parameter of the end tag within 2 * steps * lr * (1 - b1) /
    sqrt(1 - b2), twice the most Adam can move a parameter over the run.

    The validation loss takes the spread rule because two Adam steps from
    the init amplify tiny differences: the K = 5 heads start nearly alike,
    so the WTA loss's winners flip on rounding, and Adam's first steps move
    a parameter by about lr * sign(g) whatever |g| is. To show that the
    runs part there and not in the forward, it also prints the validation
    loss of the CPU run's weights on the card, and how many weights the two
    runs leave more than lr apart."""
    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.drivers import h36m
    from manipose_tpu_torch.weights import load_torch_checkpoint

    results, seconds = {}, {}
    for run, device, scale in (("cpu", "cpu", 1.0), ("cpu up", "cpu", 1.0 + MODEL_TOL),
                               ("cpu down", "cpu", 1.0 - MODEL_TOL), ("card", "cuda", 1.0)):
        run_data = data_dir / run.replace(" ", "_")
        run_data.mkdir(parents=True)
        write_h36m(run_data, 0, frames=LOOP_FRAMES, train_frames=LOOP_FRAMES,
                   s9_frames=LOOP_FRAMES, scale_2d=scale)
        cfg = load_config("config", [
            f"data.data_dir={run_data}", f"run.output_dir={run_data}",
            "data.data=one", f"data.actions={','.join(EVAL_ACTIONS.values())}",
            f"train.batch_size={TRAIN_BATCH}", "train.valid_epoch_interval=1",
            f"device={device}", *LOOP_OVERRIDES])
        t0 = time.perf_counter()
        h36m.main(cfg)
        seconds[run] = time.perf_counter() - t0
        out = run_dir(cfg)
        results[run] = (np.load(out / "train_loss.npy"), np.load(out / "valid_loss.npy"),
                        load_torch_checkpoint(out / "end" / "model.pth"))
    (tr_cpu, va_cpu, w_cpu), (tr_card, va_card, w_card) = results["cpu"], results["card"]
    require(tr_card.shape == tr_cpu.shape == va_card.shape == va_cpu.shape == (1,),
            f"one epoch: {tr_card} {tr_cpu} {va_card} {va_cpu}")
    train_err = abs(tr_card[0] - tr_cpu[0]) / abs(tr_cpu[0])
    require(train_err <= LOOP_LOSS_TOL, f"loop cpu vs card train loss: {tr_card} vs {tr_cpu}")
    spread = max(abs(results[run][1][0] - va_cpu[0]) / abs(va_cpu[0])
                 for run in ("cpu up", "cpu down"))
    valid_tol = 2 * spread + LOOP_LOSS_TOL
    valid_err = abs(va_card[0] - va_cpu[0]) / abs(va_cpu[0])
    require(valid_err <= valid_tol, f"loop cpu vs card validation loss: {va_card} vs "
                                    f"{va_cpu} ({valid_err} > {valid_tol})")
    steps = -(-len(EVAL_ACTIONS) * 4 * (LOOP_FRAMES // cfg.data.seq_len) // TRAIN_BATCH)
    b1, b2 = ADAM_BETAS
    envelope = 2 * steps * cfg.train.lr * (1 - b1) / (1 - b2) ** 0.5
    worst = max(((w_card[k] - w_cpu[k]).abs().max().item(), k) for k in w_cpu)
    require(worst[0] <= envelope, f"loop cpu vs card weights: {worst} > {envelope}")
    apart = sum(int(((w_card[k] - w_cpu[k]).abs() > cfg.train.lr).sum()) for k in w_cpu)
    va_cpu_weights_on_card = validation_loss(cfg, w_cpu)
    print(f"loop cpu vs card (one epoch, {steps} steps of {TRAIN_BATCH}, depth 2, L 27, "
          f"fp32, drop-path 0; the CPU took {seconds['cpu']:.1f} s, the card "
          f"{seconds['card']:.1f} s): train loss {tr_cpu[0]:.6f} cpu, {tr_card[0]:.6f} card, "
          f"rel err {train_err:.3g} (tol {LOOP_LOSS_TOL}); validation loss {va_cpu[0]:.6f} "
          f"cpu, {va_card[0]:.6f} card, rel err {valid_err:.3g} (tol {valid_tol:.3g}; the "
          f"CPU's own change with its inputs moved by +-{MODEL_TOL}: {spread:.3g}; the CPU "
          f"run's weights on the card: {va_cpu_weights_on_card:.6f}, rel err "
          f"{abs(va_cpu_weights_on_card - va_cpu[0]) / abs(va_cpu[0]):.3g}); worst weight gap "
          f"{worst[0]:.3g} at {worst[1]} (envelope {envelope:.3g}), {apart} weights more than "
          f"lr apart", flush=True)


def validation_loss(cfg, weights) -> float:
    """The driver's validation loss (the mean over batches of the test
    subjects' windows) of ``weights`` on the card, on ``cfg``'s data."""
    from manipose_tpu_torch.drivers import create_loader, h36m, instantiate_model
    from manipose_tpu_torch.train import LossConfig, make_eval_loss_step

    keypoints, dataset = h36m.fetch_and_prepare_data(cfg)
    loader = create_loader(keypoints, dataset, list(EVAL_ACTIONS.values()), ["S9", "S11"],
                           cfg, train=False)
    model, rmcl = instantiate_model(cfg, dataset.skeleton)
    model.load_state_dict(weights)
    t = cfg.train
    step = make_eval_loss_step(model.cuda(), LossConfig(
        sq_loss=t.sq_loss, w_loss=t.w_loss, vel_loss=t.vel_loss, smooth_reg=t.smooth_reg,
        rmcl_score_reg=t.rmcl_score_reg, rigid_seg_reg=t.rigid_seg_reg, rmcl=rmcl),
        dataset.skeleton)
    device = torch.device("cuda")
    losses = [step(*batch.to_device(device)[:2], int(batch.valid.sum()))["loss"]
              for batch in loader]
    return float(torch.stack(losses).double().mean())


def phase_profile_epoch(dtype: str, data_dir: Path) -> None:
    """One epoch of ``train.loop.train`` (training, validation loss, MPJPE
    eval, checkpoints) at the flagship under the profiler: device time by
    kernel class and the device's busy share."""
    from manipose_tpu_torch.drivers import create_loader, h36m, instantiate_model
    from manipose_tpu_torch.train.loop import train

    cfg = train_config(dtype, data_dir, ["train.epochs=1", f"run.experiment=profile_{dtype}"])
    keypoints, dataset = h36m.fetch_and_prepare_data(cfg)
    loaders = [create_loader(keypoints, dataset, list(EVAL_ACTIONS.values()), subjects, cfg,
                             train=is_train)
               for subjects, is_train in ((["S1"], True), (["S9", "S11"], False))]
    model, rmcl = instantiate_model(cfg, dataset.skeleton)
    profile_call(f"{dtype} one train-loop epoch ({len(loaders[0])} steps, validation, "
                 f"MPJPE eval, checkpoints)",
                 lambda: train(model, cfg, dataset.skeleton, *loaders, run_dir(cfg), rmcl))


def dhp3_config(dtype: str, data_dir: Path, extra=()):
    """The 3DHP driver at the flagship's widths on the phase's archives."""
    from manipose_tpu_torch.config import load_config

    return load_config("config", [
        "data=mpi_inf_3dhp", f"model.dtype={dtype}", f"data.data_dir={data_dir}",
        f"run.output_dir={data_dir / 'outputs'}", f"run.experiment=dhp3_{dtype}",
        "run.train=true", "run.test=true", f"train.epochs={DRIVER_EPOCHS}",
        f"train.batch_size={DHP3_BATCH}", f"train.batch_size_test={DHP3_BATCH_TEST}",
        "train.valid_epoch_interval=1", "train.mpjpe_epoch_interval=1", *extra])


def write_3dhp(data_dir: Path) -> None:
    from manipose_tpu_torch.tools.make_synthetic_3dhp import generate

    t0 = time.perf_counter()
    generate(data_dir, DHP3_TRAIN_SEQS, DHP3_CAMS, DHP3_FRAMES, DHP3_TEST_FRAMES,
             seed=dhp3_config("float32", data_dir).run.seed)
    print(f"3dhp data: FK-synthetic archives in {time.perf_counter() - t0:.1f} s", flush=True)


def phase_dhp3_driver(dtype: str, data_dir: Path):
    """The 3DHP driver (``drivers.dhp3.main``, run.train=true) at the
    flagship's widths and L = 27 on the card: K1 and K2 never launched; K3,
    K4, K5 and K6 launched, every launch on the dtype's operands and the
    backward kernels once a layer a step; finite losses; every tag written;
    PCK, AUC, agg_pck and agg_auc finite and in [0, 100]; the five CSVs
    written. Returns (launch counts, per-epoch log rows, protocol valid
    frames/s)."""
    import csv

    from manipose_tpu_torch import ops
    from manipose_tpu_torch.data.dhp3 import Dataset3DHP
    from manipose_tpu_torch.drivers import dhp3
    from manipose_tpu_torch.utils.logging import MetricLogger

    cfg = dhp3_config(dtype, data_dir)
    steps = DRIVER_EPOCHS * len(dhp3.create_loader(Dataset3DHP(data_dir, train=True), cfg))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    logger = MetricLogger()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    best = dhp3.main(cfg, logger=logger)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts, on_dtype = ops.launch_counts(), ops.launch_counts(DTYPES[dtype])
    print(f"3dhp driver {dtype} launches {counts} ({dtype} operands: {on_dtype}); "
          f"{steps} train steps of {DHP3_BATCH} windows of {DHP3_SEQ_LEN} frames")
    for name in KERNELS:
        if name not in DHP3_LAUNCHES_PER_TRAIN_STEP:
            require(counts[name] == 0, f"3dhp driver {dtype}: {name} launched "
                                       f"{counts[name]} times at L = {DHP3_SEQ_LEN}")
            continue
        require(counts[name] > 0, f"3dhp driver {dtype}: {name} launched")
        require(on_dtype[name] == counts[name],
                f"3dhp driver {dtype}: {name} launched {counts[name] - on_dtype[name]} "
                f"times on other than {dtype} operands")
        if name.endswith("_bwd"):
            want = DHP3_LAUNCHES_PER_TRAIN_STEP[name] * steps
            require(counts[name] == want, f"3dhp driver {dtype}: {name} launched "
                                          f"{counts[name]}, want {want}")
    out = run_dir(cfg)
    losses = {n: np.load(out / f"{n}.npy") for n in ("train_loss", "valid_loss")}
    for n, v in losses.items():
        require(v.shape == (DRIVER_EPOCHS,) and bool(np.isfinite(v).all()), f"3dhp {n} {v}")
    require(best is not None and bool(np.isfinite(best)), f"3dhp best validation MPJPE {best}")
    for tag in RUN_TAGS:
        require((out / tag / "model.pth").is_file(), f"3dhp driver {dtype}: tag {tag}")
    for name in DHP3_OUTPUT_CSVS:
        require((out / f"{name}.csv").is_file(), f"3dhp driver {dtype}: {name}.csv")
    with open(out / "test_metrics.csv", newline="") as f:
        (metrics,) = [{k: float(v) for k, v in row.items()} for row in csv.DictReader(f)]
    require(all(np.isfinite(v) for v in metrics.values()), f"3dhp test metrics {metrics}")
    for k in ("pck", "auc", "agg_pck", "agg_auc"):
        require(0.0 <= metrics[k] <= 100.0, f"3dhp {k} = {metrics[k]} in [0, 100]")
    epochs = epoch_rows(logger)
    require([r["step"] for r in epochs] == list(range(DRIVER_EPOCHS)), f"epochs {epochs}")
    print_epochs(f"3dhp driver {dtype}", epochs)
    (timed,) = [r for r in logger.history if "eval_frames" in r]
    fps = timed["eval_frames"] / timed["eval_seconds"]
    print(f"3dhp driver {dtype}: main {main_s:.1f} s; train losses {losses['train_loss']}, "
          f"validation losses {losses['valid_loss']}, best validation MPJPE {best:.4f} mm; "
          f"protocol: {timed['eval_frames']} valid frames in {timed['eval_seconds']:.3f} s "
          f"({fps:.1f} frames/s, batch {DHP3_BATCH_TEST}, TTA); "
          + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()), flush=True)
    return counts, epochs, fps


def dhp3_cut(cfg, data_dir: Path, weights):
    """TS1 and TS5 of the phase's test archive, cut to DHP3_CPU_WINDOWS
    windows each, with 3D targets at the model's own scale: per frame one
    of the CPU fp32 model's hypotheses (drawn from run.seed) plus
    N(0, EVAL_TARGET_NOISE_M) a coordinate. A Dataset3DHP stand-in."""
    from types import SimpleNamespace

    from manipose_tpu_torch.data.dhp3 import Dataset3DHP
    from manipose_tpu_torch.tools.make_synthetic_3dhp import TEST_SEQUENCES

    full = Dataset3DHP(data_dir, train=False)
    n = DHP3_CPU_WINDOWS * cfg.data.seq_len
    poses_2d = [full.poses_2d[TEST_SEQUENCES.index(seq)][:n] for seq in DHP3_CPU_SEQUENCES]
    model = dhp3_model(dhp3_config("float32", data_dir), "cpu", weights)
    x = torch.from_numpy(np.stack(poses_2d).reshape(-1, cfg.data.seq_len, 17, 2))
    with torch.inference_mode():
        hyps = model(x)[0].float().numpy()  # (windows, H, L, J, 3)
    rng = np.random.default_rng(cfg.run.seed)
    pick = rng.integers(0, hyps.shape[1], size=(hyps.shape[0], hyps.shape[2]))
    chosen = np.take_along_axis(hyps, pick[:, None, :, None, None], axis=1)[:, 0]
    chosen = chosen + rng.normal(scale=EVAL_TARGET_NOISE_M, size=chosen.shape)
    poses = list(chosen.astype(np.float32).reshape(len(poses_2d), n, 17, 3))
    return SimpleNamespace(skeleton=full.skeleton, poses=poses, poses_2d=poses_2d)


def dhp3_model(cfg, device, weights):
    """``cfg``'s model with ``weights`` on ``device``, in eval mode."""
    from manipose_tpu_torch.data.dhp3 import dhp3_skeleton
    from manipose_tpu_torch.drivers import instantiate_model

    model, _ = instantiate_model(cfg, dhp3_skeleton())
    model.load_state_dict(weights, strict=True)
    return model.to(device).eval()


def dhp3_protocol_on(cfg, device, weights, dataset, out_dir: Path):
    """The cut protocol on ``device``: (aggregated predictions (mm),
    metrics), both from its one ``evaluate``."""
    from manipose_tpu_torch.drivers import dhp3

    model = dhp3_model(cfg, device, weights)
    metrics, preds = dhp3.run_test_protocol(model, cfg, dataset, True, out_dir,
                                            return_predictions=True)
    return preds, metrics


def phase_dhp3_cpu_vs_card(dtype: str, data_dir: Path) -> None:
    """The 3DHP protocol on TS1 and TS5 cut to DHP3_CPU_WINDOWS windows each
    (``dhp3_cut``: targets at the model's scale), from the phase's
    best_mpjpe weights, on the card and on the CPU. fp32: predictions within
    MODEL_TOL of their magnitude, the MPJPE family, MPSSE and MPSCE within
    EVAL_METRIC_TOL relative, PCK and AUC within one joint-frame's share,
    100 / (valid frames * 17). bf16: each within max(BF16_TOL, 2 * the CPU's
    bf16 spread under a one-ulp input nudge + GAP_SLACK) relative to
    max(1, |ref|), PCK and AUC at least one joint-frame's share."""
    from types import SimpleNamespace

    from manipose_tpu_torch.weights import load_torch_checkpoint

    n_windows = len(DHP3_CPU_SEQUENCES) * DHP3_CPU_WINDOWS
    cfg = dhp3_config(dtype, data_dir, [f"train.batch_size_test={n_windows}"])
    weights = load_torch_checkpoint(run_dir(cfg) / "best_mpjpe" / "model.pth")
    dataset = dhp3_cut(cfg, data_dir, weights)
    out = data_dir / f"cpu_vs_card_{dtype}"
    t0 = time.perf_counter()
    ref_preds, ref = dhp3_protocol_on(cfg, "cpu", weights, dataset, out / "cpu")
    cpu_s = time.perf_counter() - t0
    got_preds, got = dhp3_protocol_on(cfg, "cuda", weights, dataset, out / "card")
    require(got_preds.shape == (n_windows, cfg.data.seq_len, 17, 3), f"preds {got_preds.shape}")
    joint_frame = 100.0 / (n_windows * cfg.data.seq_len * 17)
    share = {k for k in ref if "pck" in k or "auc" in k}
    errs = {}
    if dtype == "float32":
        errs["predictions"] = (float(np.abs(got_preds - ref_preds).max()),
                               MODEL_TOL * max(1.0, float(np.abs(ref_preds).max())))
        for k, want in ref.items():
            errs[k] = (abs(got[k] - want),
                       joint_frame if k in share else EVAL_METRIC_TOL * abs(want))
    else:
        nudged_set = SimpleNamespace(skeleton=dataset.skeleton, poses=dataset.poses,
                                     poses_2d=[p * BF16_NUDGE for p in dataset.poses_2d])
        nudged_preds, nudged = dhp3_protocol_on(cfg, "cpu", weights, nudged_set,
                                                out / "nudged")
        errs["predictions"] = (rel_err(got_preds, ref_preds),
                               max(BF16_TOL, 2 * rel_err(nudged_preds, ref_preds) + GAP_SLACK))
        for k, want in ref.items():
            spread = rel_err(np.asarray(nudged[k]), np.asarray(want))
            tol = max(BF16_TOL, 2 * spread + GAP_SLACK)
            errs[k] = (rel_err(np.asarray(got[k]), np.asarray(want)),
                       max(tol, joint_frame) if k in share else tol)
    for k, (err, tol) in errs.items():
        require(err <= tol, f"3dhp cpu vs card {dtype} {k}: {err} > {tol}")
    print(f"3dhp cpu vs card {dtype} ({'+'.join(DHP3_CPU_SEQUENCES)}, {n_windows} windows "
          f"of {cfg.data.seq_len} in one batch, best_mpjpe weights, targets a seeded "
          f"hypothesis + {1000 * EVAL_TARGET_NOISE_M:g} mm noise; the CPU took {cpu_s:.1f} s; "
          f"one joint-frame {joint_frame:.4f}): "
          + ", ".join(f"{k} err {e:.3g} (tol {t:.3g})" for k, (e, t) in errs.items())
          + "; cpu " + ", ".join(f"{k} {v:.4f}" for k, v in ref.items())
          + "; card " + ", ".join(f"{k} {v:.4f}" for k, v in got.items()), flush=True)


def stream_predictor(model: str, dtype: str, **kw):
    """A batch-1, TTA-on ``Predictor`` of the H36M flagship or of the 3DHP
    model (``data=mpi_inf_3dhp``) in ``dtype``; ``kw`` goes to it."""
    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.data.dhp3 import dhp3_skeleton
    from manipose_tpu_torch.serving import Predictor

    if model == "3dhp":
        return Predictor(cfg=load_config("config", ["data=mpi_inf_3dhp", f"model.dtype={dtype}"]),
                         skeleton=dhp3_skeleton(), batch_size=1, tta=True, **kw)
    return Predictor(cfg=load_config("config", [f"model.dtype={dtype}"]), batch_size=1,
                     tta=True, **kw)


def phase_stream_cpu_vs_card() -> None:
    """A stride-1 session with default lookahead at the H36M flagship (L =
    243) and at the 3DHP model (L = 27), fp32 and bf16, on the card and on
    the CPU from the same weights: STREAM_CPU_WINDOWS firing pushes, each a
    one-window forward (TTA on), so every kernel of a stream runs at a
    firing push's shapes. fp32: within MODEL_TOL of the magnitude. bf16:
    within max(BF16_TOL, 2 * the CPU's bf16 spread under a one-ulp input
    nudge + GAP_SLACK) relative to max(1, |ref|max)."""
    for model in ("h36m", "3dhp"):
        for dtype in ("float32", "bfloat16"):
            card = stream_predictor(model, dtype)
            state = {k: v.cpu() for k, v in card.model.state_dict().items()}
            cpu = stream_predictor(model, dtype, state_dict=state, device="cpu")
            n = card.seq_len // 2 + STREAM_CPU_WINDOWS
            video = np.random.default_rng(3).normal(size=(n, 17, 2)).astype(np.float32)
            t0 = time.perf_counter()
            ref = cpu.stream(stride=1).push(video)
            cpu_s = time.perf_counter() - t0
            got = card.stream(stride=1).push(video)
            require(got.shape == ref.shape == (STREAM_CPU_WINDOWS, 17, 3),
                    f"stream {model} {dtype}: shapes {got.shape}, {ref.shape}")
            if dtype == "float32":
                err = float(np.abs(got - ref).max())
                tol = MODEL_TOL * max(1.0, float(np.abs(ref).max()))
                spread = ""
            else:
                nudged = cpu.stream(stride=1).push(video * BF16_NUDGE)
                err, s = rel_err(got, ref), rel_err(nudged, ref)
                tol = max(BF16_TOL, 2 * s + GAP_SLACK)
                spread = f", cpu bf16 spread {s:.3g}, relative to max(1, |ref|max)"
            require(bool(np.isfinite(got).all()) and err <= tol,
                    f"stream {model} {dtype} cpu vs card: {err} > {tol}")
            print(f"stream cpu vs card {model:4s} L={card.seq_len:3d} {dtype:8s} (stride 1, "
                  f"lookahead {card.seq_len // 2}, {STREAM_CPU_WINDOWS} firing pushes; the CPU "
                  f"took {cpu_s:.1f} s): err {err:.3g} (tol {tol:.3g}{spread})", flush=True)
            del card, cpu


def phase_stream():
    """Live streaming sessions on the card. A session of stride L and
    lookahead 0 equals ``predict_video`` (batch 1) within MODEL_TOL of the
    magnitude at the H36M flagship (fp32). Then, at the H36M flagship (L =
    243) and the 3DHP model (L = 27), fp32 and bf16, default lookahead
    (L // 2), strides STREAM_STRIDES: frames pushed one at a time; ms per
    firing push (host clock: each firing push ends with its result on the
    host) over STREAM_FIRINGS warm firing pushes, median and p90, frames/s
    over those pushes, beside latency_frames. Returns the launch counts of
    the timed sessions."""
    from manipose_tpu_torch import ops

    pred = stream_predictor("h36m", "float32")
    l = pred.seq_len
    video = np.random.default_rng(2).normal(size=(2 * l + 10, 17, 2)).astype(np.float32)
    sess = pred.stream(stride=l, lookahead=0)
    got = np.concatenate([sess.push(video), sess.flush()], axis=0)
    want = pred.predict_video(video)
    err, tol = float(np.abs(got - want).max()), MODEL_TOL * max(1.0, float(np.abs(want).max()))
    require(got.shape == want.shape and err <= tol,
            f"stream(stride={l}, lookahead=0) against predict_video: {err} > {tol}")
    print(f"stream: stride {l}, lookahead 0 against predict_video (flagship fp32, "
          f"{len(video)} frames): max err {err:.3g} (tol {tol:.3g})", flush=True)
    counts = {name: 0 for name in KERNELS}
    for model in ("h36m", "3dhp"):
        for dtype in ("float32", "bfloat16"):
            pred = stream_predictor(model, dtype)
            l = pred.seq_len
            for stride in STREAM_STRIDES:
                sess = pred.stream(stride=stride)
                n_frames = sess.lookahead + stride * (STREAM_WARM + STREAM_FIRINGS)
                video = np.random.default_rng(stride).normal(size=(n_frames, 17, 2))
                video = video.astype(np.float32)
                times, emitted = [], 0
                ops.reset_launch_counts()
                for frame in video:
                    t0 = time.perf_counter()
                    out = sess.push(frame)
                    if len(out):
                        times.append(time.perf_counter() - t0)
                        emitted += len(out)
                for name, n in ops.launch_counts().items():
                    counts[name] += n
                require(emitted == n_frames - sess.lookahead and len(times) == STREAM_WARM
                        + STREAM_FIRINGS, f"stream {model} {dtype} stride {stride}: "
                                          f"{len(times)} firing pushes, {emitted} frames")
                warm = np.asarray(times[STREAM_WARM:]) * 1e3
                fps = stride * len(warm) / (warm.sum() / 1e3)
                print(f"stream {model:4s} L={l:3d} {dtype:8s} stride {stride} lookahead "
                      f"{sess.lookahead:3d}: latency_frames {sess.latency_frames}; ms per firing "
                      f"push median {float(np.median(warm)):.3f}, p90 "
                      f"{float(np.percentile(warm, 90)):.3f} over {len(warm)} warm pushes "
                      f"(first {times[0] * 1e3:.1f}); {fps:.1f} frames/s", flush=True)
    print(f"stream launches {counts}")
    for name in ("attention_dense", "attention_packed", "fused_mlp"):
        require(counts[name] > 0, f"stream: {name} launched")
    return counts


def phase_int8_gemms() -> list:
    """The int8 probe's ratio (``quant.int8_speedup``, the gate of
    ``quantize=True``), then the trunks' int8 products (``quant.int_mm``:
    ``torch._int_mm``) at the flagship's serving shapes, each exact against
    an fp64 product of the same codes, timed beside a bf16 ``F.linear`` of
    the same shape and a bound (bytes: the codes read, the int32 result
    written; operations: 2 M k n at the int8 peak)."""
    import torch.nn.functional as F

    from manipose_tpu_torch.ops import quant

    ratio = quant.int8_speedup()
    print(f"int8 probe: int8_speedup() = {ratio:.4f} (bf16 / int8 GEMM time at "
          f"8192 x 512 x 512; quantize=True serves int8 at >= 1.05)", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, m, k, n in INT8_GEMM_CASES:
        a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        got = quant.int_mm(a, w)
        want = (a.double() @ w.double().t()).to(torch.int32)
        require(bool(torch.equal(got, want)), f"int8 GEMM {name}: not exact")
        ms = time_ms(lambda: quant.int_mm(a, w))
        xb, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        bf16_ms = time_ms(lambda: F.linear(xb, wb))
        t_bytes = (m * k + n * k + 4 * m * n) / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * m * k * n / PEAK_INT8_OPS * 1e3
        row = dict(name=name, shape=[m, k, n], ms=ms, tops=2.0 * m * k * n / ms * 1e-9,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bf16_linear_ms=bf16_ms)
        rows.append(row)
        print(f"int8 gemm {name:15s} M={m} k={k} n={n}: {ms:.4f} ms ({row['tops']:.1f} TOPS), "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), bf16 F.linear "
              f"{bf16_ms:.4f} ms ({bf16_ms / ms:.2f}x)", flush=True)
    return rows


def flagship_state(cfg) -> dict:
    """The flagship's float weights drawn from ``cfg.run.seed`` (the
    Predictor's own random init), on the CPU."""
    from manipose_tpu_torch.drivers import instantiate_model
    from manipose_tpu_torch.geometry import h36m_skeleton_17

    return instantiate_model(cfg, h36m_skeleton_17())[0].state_dict()


def phase_int8_serving(dtype: str):
    """int8 serving at the flagship (16 windows of 243, TTA,
    ``quantize="force"``) in ``dtype`` compute: output checks, K1 and K3
    launched on the dtype's operands and K5 never, frames/s (mean of 5),
    the poses' gap to the float predictor of the same weights (mm and
    relative), then INT8_CPU_WINDOWS windows (TTA off) on the card and on
    the CPU by the spread rule. Returns (launch counts, frames/s)."""
    from manipose_tpu_torch import ops
    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.serving import Predictor

    cfg = load_config("config", [f"model.dtype={dtype}"])
    state = flagship_state(cfg)
    pred = Predictor(cfg=cfg, state_dict=state, batch_size=16, tta=True, quantize="force")
    require(pred.quantized, "quantize='force' serves int8")
    l = cfg.data.seq_len
    video = np.random.default_rng(0).normal(size=(16 * l, 17, 2)).astype(np.float32)
    pred.predict_video(video)  # warm-up
    ops.reset_launch_counts()
    poses, hyps, scores = pred.predict_video(video, return_hypotheses=True)
    counts = require_counts(dtype, {k: 2 * n for k, n in INT8_LAUNCHES_PER_FORWARD.items()},
                            f"int8 {dtype} serving (1 window batch)")
    for name, a in (("poses", poses), ("hyps", hyps), ("scores", scores)):
        require(bool(np.isfinite(a).all()), f"int8 {dtype} {name} not finite")
    score_err = float(np.abs(scores.sum(axis=1) - 1.0).max())
    require(score_err <= 1e-5, f"int8 scores sum to 1 over H within 1e-5 ({score_err})")
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict_video(video)
    fps = video.shape[0] / ((time.perf_counter() - t0) / reps)
    if "--profile" in sys.argv[1:]:
        profile_call(f"int8 {dtype} predict_video of {video.shape[0]} frames",
                     lambda: pred.predict_video(video))
    floats = Predictor(cfg=cfg, state_dict=state, batch_size=16, tta=True)
    ref = floats.predict_video(video)
    del floats
    gap_mm = float(np.linalg.norm(poses - ref, axis=-1).mean() * 1000.0)
    rel = float(np.linalg.norm(poses - ref) / np.linalg.norm(ref))
    require(rel < INT8_FLOAT_REL, f"int8 {dtype} against float: {rel} >= {INT8_FLOAT_REL}")
    print(f"int8 {dtype} predict_video: {video.shape[0]} frames -> {fps:.1f} frames/s (mean "
          f"of {reps}, TTA on, batch 16); gap to float {gap_mm:.3f} mm mean per joint, "
          f"{rel:.4f} relative", flush=True)

    window = video[: INT8_CPU_WINDOWS * l]
    outs = {}
    for device in ("cuda", "cpu"):
        p = Predictor(cfg=cfg, state_dict=state, batch_size=INT8_CPU_WINDOWS, tta=False,
                      quantize="force", device=device)
        outs[device] = p.predict_video(window)
    if dtype == "float32":
        nudged = p.predict_video(np.nextafter(window, np.float32(np.inf)))
        spread = float(np.abs(nudged - outs["cpu"]).max())
        err = float(np.abs(outs["cuda"] - outs["cpu"]).max())
        tol = 2 * spread + MODEL_TOL * max(1.0, float(np.abs(outs["cpu"]).max()))
    else:
        nudged = p.predict_video(window * BF16_NUDGE)
        spread = rel_err(nudged, outs["cpu"])
        err = rel_err(outs["cuda"], outs["cpu"])
        tol = max(BF16_TOL, 2 * spread + GAP_SLACK)
    require(err <= tol, f"int8 {dtype} cpu vs card: {err} > {tol}")
    print(f"int8 {dtype} cpu vs card ({INT8_CPU_WINDOWS} windows, TTA off): err {err:.3g} "
          f"(tol {tol:.3g}; the CPU's spread {spread:.3g}"
          f"{'' if dtype == 'float32' else ', relative to max(1, |ref|max)'})", flush=True)
    return counts, fps


def phase_data_parallel(plain):
    """``Predictor(data_parallel=True)`` on the one card (one shard on a
    stream of its own) against the plain predictor of the same weights:
    ``predict_video`` bit for bit, then a stream (stride 81, default
    lookahead: each window replicated up to the batch) within MODEL_TOL of
    the plain predictor's stream. Returns the launch counts of the
    data-parallel ``predict_video``."""
    from manipose_tpu_torch import ops
    from manipose_tpu_torch.serving import Predictor

    cfg = plain.cfg
    state = {k: v.cpu() for k, v in plain.model.state_dict().items()}
    dp = Predictor(cfg=cfg, state_dict=state, batch_size=plain.batch_size, tta=True,
                   data_parallel=True)
    l = cfg.data.seq_len
    video = np.random.default_rng(4).normal(size=(16 * l, 17, 2)).astype(np.float32)
    want = plain.predict_video(video, return_hypotheses=True)
    ops.reset_launch_counts()
    got = dp.predict_video(video, return_hypotheses=True)
    counts = require_counts("float32", {k: 2 * n for k, n in LAUNCHES_PER_FORWARD.items()},
                            "data-parallel serving (1 card, 1 window batch)")
    for name, g, w in zip(("poses", "hyps", "scores"), got, want):
        require(bool(np.array_equal(g, w)), f"data-parallel {name} equal to plain")
    frames = video[: l // 2 + 2 * 81]
    streams = []
    for p in (plain, dp):
        sess = p.stream(stride=81)
        streams.append(np.concatenate([sess.push(frames), sess.flush()], axis=0))
    err = float(np.abs(streams[1] - streams[0]).max())
    tol = MODEL_TOL * max(1.0, float(np.abs(streams[0]).max()))
    require(streams[1].shape == streams[0].shape == frames.shape[:1] + (17, 3) and err <= tol,
            f"data-parallel stream against plain: {err} > {tol}")
    print(f"data-parallel on {torch.cuda.device_count()} card(s): predict_video of "
          f"{video.shape[0]} frames bit-equal to plain; a stride-81 stream of "
          f"{len(frames)} frames within {err:.3g} of plain (tol {tol:.3g})", flush=True)
    return counts


def phase_export(plain):
    """``export_program`` of the fp32 flagship predictor on the card
    (symbolic batch), ``load_program``, then the program at batches 1, 2 and
    16 against the live forward within EXPORT_TOL of the magnitude; K1, K3
    and K5 launched inside the program (the counters at batch 16); frames/s
    of the program and of the live forward on the same 16 windows (mean of
    5, ending in a synchronize). Returns the program's launch counts."""
    from manipose_tpu_torch import ops
    from manipose_tpu_torch.serving import Predictor

    t0 = time.perf_counter()
    data = plain.export_program()
    t1 = time.perf_counter()
    program = Predictor.load_program(data)
    t2 = time.perf_counter()
    l = plain.seq_len
    live = plain.serving_forward
    gen = torch.Generator(device="cuda").manual_seed(5)
    for b in (1, 2, 16):
        x = torch.randn((b, l, 17, 2), generator=gen, device="cuda")
        with torch.no_grad():
            want = live(x)
        ops.reset_launch_counts()
        got = program(x)
        for name, g, w in zip(("poses", "hyps", "scores"), got, want):
            err = float((g - w).abs().max())
            tol = EXPORT_TOL * max(1.0, float(w.abs().max()))
            require(g.shape == w.shape and err <= tol,
                    f"exported program {name} at batch {b}: {err} > {tol}")
    counts = require_counts("float32", {k: 2 * n for k, n in LAUNCHES_PER_FORWARD.items()},
                            "exported program (batch 16)")

    def fps(fn) -> float:
        fn(x)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            fn(x)
        torch.cuda.synchronize()
        return 16 * l / ((time.perf_counter() - t) / 5)

    with torch.no_grad():
        live_fps = fps(live)
    program_fps = fps(program)
    print(f"export: {len(data) / 1e6:.1f} MB, export_program {t1 - t0:.1f} s, load_program "
          f"{t2 - t1:.1f} s; batches 1, 2, 16 within {EXPORT_TOL} of the live forward; "
          f"16 windows: program {program_fps:.1f} frames/s, live forward "
          f"{live_fps:.1f} frames/s", flush=True)
    return counts


def http_call(port: int, method: str, path: str, body=None):
    from http.client import HTTPConnection

    conn = HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def phase_http(state: dict):
    """The port's HTTP server (``tools.serve``) in this process on a local
    port, over a flagship fp32 predictor of batch SERVE_WINDOWS (TTA): one
    /predict of SERVE_WINDOWS windows and a stream lifecycle (open, pushes
    of 100 frames, flush) equal to the direct calls; then SERVE_REQUESTS
    timed /predict requests of SERVE_WINDOWS windows of 243 frames each,
    one at a time: requests/s and the latency's median and p90. Returns
    the launch counts of the timed requests."""
    import threading

    from manipose_tpu_torch import ops
    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.serving import Predictor
    from manipose_tpu_torch.tools.serve import PoseServer, make_http_server

    cfg = load_config("config")
    pred = Predictor(cfg=cfg, state_dict=state, batch_size=SERVE_WINDOWS, tta=True)
    server = PoseServer(pred)
    httpd = make_http_server(server, "127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        video = np.random.default_rng(6).normal(
            size=(SERVE_WINDOWS * pred.seq_len, 17, 2)).astype(np.float32)
        body = {"keypoints": video.tolist()}
        status, out = http_call(port, "GET", "/healthz")
        require(status == 200 and out["device"] == "cuda", f"healthz {status} {out}")
        status, out = http_call(port, "POST", "/predict", body)
        require(status == 200, f"/predict {status} {out.get('error')}")
        require(bool(np.array_equal(np.asarray(out["poses"], np.float32),
                                    pred.predict_video(video))),
                "/predict equal to predict_video")
        status, opened = http_call(port, "POST", "/stream/open", {"stride": 9})
        require(status == 200, f"/stream/open {status}")
        sid, got = opened["session"], []
        frames = video[:200]
        for i in range(0, len(frames), 50):
            status, out = http_call(port, "POST", f"/stream/{sid}/push",
                                    {"frames": frames[i:i + 50].tolist()})
            require(status == 200, f"/stream push {status}")
            got.append(np.asarray(out["poses"], np.float32).reshape(-1, 17, 3))
        status, out = http_call(port, "POST", f"/stream/{sid}/flush")
        got.append(np.asarray(out["poses"], np.float32).reshape(-1, 17, 3))
        sess = pred.stream(stride=9)
        want = np.concatenate([sess.push(frames), sess.flush()], axis=0)
        require(bool(np.array_equal(np.concatenate(got), want)),
                "the HTTP stream equal to a direct session")
        status, _ = http_call(port, "POST", f"/stream/{sid}/push", {"frames": []})
        require(status == 404, f"a flushed session is gone ({status})")
        for _ in range(SERVE_WARM):
            http_call(port, "POST", "/predict", body)
        ops.reset_launch_counts()
        times = []
        for _ in range(SERVE_REQUESTS):
            t0 = time.perf_counter()
            status, _ = http_call(port, "POST", "/predict", body)
            times.append(time.perf_counter() - t0)
            require(status == 200, f"/predict {status}")
        counts = ops.launch_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    require(not thread.is_alive(), "the server thread stopped")
    for name in ("attention_dense", "attention_packed", "fused_mlp"):
        require(counts[name] == 2 * SERVE_REQUESTS * LAUNCHES_PER_FORWARD[name],
                f"http serving: {name} launched {counts[name]}")
    ms = np.asarray(times) * 1e3
    print(f"http /predict ({SERVE_WINDOWS} windows of {pred.seq_len} frames a request, "
          f"{len(json.dumps(body)) / 1e6:.2f} MB of JSON in): {SERVE_REQUESTS / ms.sum() * 1e3:.2f} "
          f"requests/s, {SERVE_REQUESTS * video.shape[0] / ms.sum() * 1e3:.1f} frames/s; latency "
          f"median {float(np.median(ms)):.1f} ms, p90 {float(np.percentile(ms, 90)):.1f} ms; "
          f"/predict and a stream lifecycle equal to the direct calls", flush=True)
    return counts


def phase_profile_l27(dtype: str) -> None:
    """Ten warm train steps of the 3DHP model (L = 27, B = 25 synthetic
    windows, drop-path 0.1) and ten warm firing pushes of a stride-1
    session at the H36M flagship and at the 3DHP model, in ``dtype``, under
    the profiler: how much of a short step and of a one-window push the
    card is busy."""
    from manipose_tpu_torch.config import load_config

    cfg = load_config("config", ["data=mpi_inf_3dhp", f"model.dtype={dtype}"])
    state, step = make_trainer(cfg, "cuda")
    x, y = (t.cuda() for t in flagship_batch(DHP3_SEQ_LEN, DHP3_BATCH))
    for _ in range(3):
        step(state, x, y, TRAIN_LR)
    profile_call(f"{dtype} 10 train steps of the 3dhp model (B={DHP3_BATCH}, "
                 f"L={DHP3_SEQ_LEN})", lambda: [step(state, x, y, TRAIN_LR) for _ in range(10)])
    del state, step, x, y
    for model in ("h36m", "3dhp"):
        pred = stream_predictor(model, dtype)
        sess = pred.stream(stride=1)
        warm = sess.lookahead + 3
        frames = np.random.default_rng(0).normal(size=(warm + 10, 17, 2)).astype(np.float32)
        sess.push(frames[:warm])
        profile_call(f"{dtype} 10 firing pushes of a {model} session (L={pred.seq_len}, "
                     f"stride 1)", lambda: [sess.push(f) for f in frames[warm:]])


def kernel_group(name: str) -> str:
    """Coarse class of a device kernel, by its (mangled) name."""
    for ours, device_names in DEVICE_KERNELS.items():
        if any(n in name for n in device_names):
            return ours
    low = name.lower()
    # nvjet_*: cuBLAS's own GEMM kernels, which it picks for bf16 on Hopper
    if any(s in low for s in ("gemm", "cutlass", "xmma", "sm90_", "cublas", "nvjet",
                              "gemv")):
        return "library GEMM (qkv, proj, embeddings, heads)"
    if "layer_norm" in low:
        return "LayerNorm"
    if "multi_tensor_apply" in low or "adam" in low:
        return "Adam update"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other elementwise / reductions"


def profile_call(label: str, fn):
    """``fn`` (warmed up already) under ``torch.profiler``: device time by
    kernel and by class, and the device's busy share of the call. Returns
    (wall ms, device busy ms; 0 when the profiler saw no device time).
    Only device activity is recorded: host events would slow the host-bound
    paths under the profiler and take a second a thousand to summarize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(ms for _, _, ms in rows)
    if busy_ms == 0.0:
        print(f"profile {label}: the profiler recorded no device time (not measured)")
        return wall_ms, 0.0
    groups = {}
    for key, count, ms in rows:
        g = groups.setdefault(kernel_group(key), [0, 0.0])
        g[0] += count
        g[1] += ms
    print(f"profile: {label}, wall {wall_ms:.2f} ms, "
          f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    for name, (count, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"  group {name:45s} launches {count:5d} {ms:9.3f} ms "
              f"{100 * ms / busy_ms:5.1f} %")
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:15]:
        print(f"  kernel {key[:90]:90s} launches {count:5d} {ms:9.3f} ms")
    return wall_ms, busy_ms


def phase_profile(dtype, predictor, train) -> None:
    """One flagship ``predict_video`` and one flagship train step in
    ``dtype`` under the profiler."""
    video = np.random.default_rng(0).normal(size=(16 * predictor.seq_len, 17, 2))
    video = video.astype(np.float32)
    predictor.predict_video(video)  # warm-up
    profile_call(f"{dtype} predict_video of {video.shape[0]} frames",
                 lambda: predictor.predict_video(video))
    state, step, (x, y) = train
    profile_call(f"{dtype} train step of {x.shape[0]} windows",
                 lambda: step(state, x, y, TRAIN_LR))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "manipose_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from manipose_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16_reduction = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    t_start = time.perf_counter()
    smi = cmd_output(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"])
    try:
        import triton  # only reported: the port has no Triton kernel

        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    nvcc_version = cmd_output([build.nvcc_path(), "--version"]).splitlines()[-1]
    print(f"host: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc '{nvcc_version}', triton "
          f"{triton_version}; TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}; bf16 GEMMs with reduced-precision "
          f"reductions allowed: {bf16_reduction} (torch's default, left as it is)",
          flush=True)

    phase_build(build)

    t0 = time.perf_counter()
    cases = phase_kernels()
    print(f"kernels phase: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    phase_bf16_accuracy(cases)
    print(f"bf16 accuracy phase: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    predictor, counts, fps = phase_flagship()
    print(f"flagship phase: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    phase_cpu_vs_card(predictor)
    print(f"cpu-card phase: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    state, step, batch, train_counts, seq_s, peak_gb = phase_train()
    print(f"train phase: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    weights = phase_cpu_vs_card_train(state)
    print(f"cpu-card train phase: {time.perf_counter() - t0:.1f} s; "
          f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    t0 = time.perf_counter()
    predictor16, counts16, fps16 = phase_flagship("bfloat16")
    print(f"bf16 flagship phase: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    phase_cpu_vs_card(predictor16)
    print(f"bf16 cpu-card phase: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    state16, step16, batch16, train_counts16, seq_s16, peak_gb16 = phase_train("bfloat16")
    print(f"bf16 train phase: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    phase_cpu_vs_card_train_bf16(weights)
    print(f"bf16 cpu-card train phase: {time.perf_counter() - t0:.1f} s; "
          f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    scratch = ROOT / "build" / "chip_smoke_h36m"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    try:
        write_h36m(scratch, eval_config("float32", scratch).run.seed)
        eval_counts, eval_fps = {}, {}
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            eval_counts[dtype], eval_fps[dtype] = phase_eval(dtype, scratch)
            print(f"eval {dtype} phase: {time.perf_counter() - t0:.1f} s", flush=True)
            t0 = time.perf_counter()
            phase_eval_cpu_vs_card(dtype, scratch)
            print(f"eval {dtype} cpu-card phase: {time.perf_counter() - t0:.1f} s; "
                  f"total {time.perf_counter() - t_start:.1f} s", flush=True)
        driver_counts, driver_epochs = {}, {}
        for dtype in ("bfloat16", "float32"):
            t0 = time.perf_counter()
            driver_counts[dtype], driver_epochs[dtype] = phase_train_driver(dtype, scratch)
            print(f"train driver {dtype} phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        phase_resume(scratch)
        print(f"resume phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        phase_serve_run_dir(scratch)
        print(f"run-directory serving phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        phase_loop_cpu_vs_card(scratch / "loop")
        print(f"loop cpu-card phase: {time.perf_counter() - t0:.1f} s; "
              f"total {time.perf_counter() - t_start:.1f} s", flush=True)
        if "--profile" in sys.argv[1:]:
            for dtype in ("bfloat16", "float32"):
                phase_profile_epoch(dtype, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    if "--profile" in sys.argv[1:]:
        phase_profile("fp32", predictor, (state, step, batch))
        phase_profile("bf16", predictor16, (state16, step16, batch16))
    del predictor, predictor16, state, step, batch, state16, step16, batch16
    torch.cuda.empty_cache()

    scratch = ROOT / "build" / "chip_smoke_3dhp"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    try:
        write_3dhp(scratch)
        dhp3_counts, dhp3_epochs, dhp3_fps = {}, {}, {}
        for dtype in ("bfloat16", "float32"):
            t0 = time.perf_counter()
            dhp3_counts[dtype], dhp3_epochs[dtype], dhp3_fps[dtype] = phase_dhp3_driver(
                dtype, scratch)
            print(f"3dhp driver {dtype} phase: {time.perf_counter() - t0:.1f} s", flush=True)
            t0 = time.perf_counter()
            phase_dhp3_cpu_vs_card(dtype, scratch)
            print(f"3dhp cpu-card {dtype} phase: {time.perf_counter() - t0:.1f} s; "
                  f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    t0 = time.perf_counter()
    stream_counts = phase_stream()
    print(f"stream phase: {time.perf_counter() - t0:.1f} s; "
          f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_stream_cpu_vs_card()
    print(f"stream cpu-card phase: {time.perf_counter() - t0:.1f} s; "
          f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    if "--profile" in sys.argv[1:]:
        for dtype in ("bfloat16", "float32"):
            phase_profile_l27(dtype)

    t0 = time.perf_counter()
    int8_rows = phase_int8_gemms()
    print(f"int8 gemm phase: {time.perf_counter() - t0:.1f} s", flush=True)
    int8_counts, int8_fps = {}, {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        int8_counts[dtype], int8_fps[dtype] = phase_int8_serving(dtype)
        print(f"int8 serving {dtype} phase: {time.perf_counter() - t0:.1f} s", flush=True)
    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.serving import Predictor

    t0 = time.perf_counter()
    plain = Predictor(cfg=load_config("config"), batch_size=16, tta=True)
    dp_counts = phase_data_parallel(plain)
    print(f"data-parallel phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    export_counts = phase_export(plain)
    print(f"export phase: {time.perf_counter() - t0:.1f} s", flush=True)
    state = {k: v.cpu() for k, v in plain.model.state_dict().items()}
    del plain
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    http_counts = phase_http(state)
    print(f"http phase: {time.perf_counter() - t0:.1f} s; "
          f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = []
    for name, meta in KERNELS.items():
        # this slice's main path is the bf16 training driver, which runs all
        # six kernels: each kernel's headline case is the rotations trunk in
        # bf16, its launches those of that run
        head = next(c for c in cases[name] if c["dtype"] == "bfloat16")
        by_path = {"serve": counts, "train_step": train_counts,
                   "serve_bf16": counts16, "train_step_bf16": train_counts16,
                   "eval": eval_counts["float32"], "eval_bf16": eval_counts["bfloat16"],
                   "train_driver": driver_counts["float32"],
                   "train_driver_bf16": driver_counts["bfloat16"],
                   "dhp3_driver": dhp3_counts["float32"],
                   "dhp3_driver_bf16": dhp3_counts["bfloat16"], "stream": stream_counts,
                   "serve_int8": int8_counts["float32"],
                   "serve_int8_bf16": int8_counts["bfloat16"],
                   "serve_data_parallel": dp_counts, "export": export_counts,
                   "http_serve": http_counts}
        kernels.append(dict(
            name=name, route="cuda", **meta,
            launches=driver_counts["bfloat16"][name],
            launches_by_path={path: c[name] for path, c in by_path.items()},
            max_abs_err=max(c["max_abs_err"] for c in cases[name]
                            if c["dtype"] == head["dtype"]),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            timed_case=f"{head['trunk']} {head['dtype']} {head['shape']}",
            cases=cases[name],
        ))
    loop_seq = {d: ", ".join(f"{r['seq_per_sec']:.2f}" for r in rows)
                for d, rows in driver_epochs.items()}
    dhp3_seq = {d: ", ".join(f"{r['seq_per_sec']:.2f}" for r in rows)
                for d, rows in dhp3_epochs.items()}
    print(f"flagship frames/s fp32 {fps:.1f}, bf16 {fps16:.1f}; train sequences/s "
          f"fp32 {seq_s:.2f} (peak {peak_gb:.2f} GB), bf16 {seq_s16:.2f} (peak "
          f"{peak_gb16:.2f} GB); eval frames/s fp32 {eval_fps['float32']:.1f}, bf16 "
          f"{eval_fps['bfloat16']:.1f}; train-loop sequences/s by epoch fp32 "
          f"{loop_seq['float32']}, bf16 {loop_seq['bfloat16']}; 3dhp train-loop sequences/s "
          f"by epoch fp32 {dhp3_seq['float32']}, bf16 {dhp3_seq['bfloat16']}; 3dhp test "
          f"valid frames/s fp32 {dhp3_fps['float32']:.1f}, bf16 {dhp3_fps['bfloat16']:.1f}; int8 "
          f"serving frames/s fp32 {int8_fps['float32']:.1f}, bf16 {int8_fps['bfloat16']:.1f}; "
          f"total {time.perf_counter() - t_start:.1f} s on {smi}")
    print("int8 gemms " + json.dumps(int8_rows))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
