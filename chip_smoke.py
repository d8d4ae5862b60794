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
              to launch is not counted. Then K5's two fp32 kernels at
              C = 512, H = 1024 (K5_PATH_ROWS): both timed at each M
              beside the bound, the kernel ``cuda_mlp.takes_wgmma`` picks
              no slower than the other; at K5_ACCURACY_ROWS each against
              an fp64 MLP, wgmma within TOL and 1.25 x mma.sync's error,
              and bit for bit the same on a second run. Then K6's two
              fp32 paths at C = 512, H = 1024 (K6_PATH_ROWS: the b16 and
              the b32 train step's rows) the same way: both timed beside
              the bound and the library's backward, the picked one no
              slower, its five gradients against fp64 within GRAD_TOL
              (dX, dW1 and dW2 also within 1.25 x mma.sync's error), bit
              for bit on a second run.
              Then the
              DSTformer's stream fusion kernels (``ops/cuda_fusion.py``)
              against ``fusion_plain`` and ``fusion_plain_bwd`` at the
              benchmark's FUSION_ROWS x FUSION_CHANNELS in fp32 (FUSION_TOL),
              the backward bit for bit the same on a second run, each
              timed beside its bound, its plain version and the library
              operations.
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
34. joint-major kernels - K3/K4 on the joint-major trunk's strided
              windows at the flagship's shapes (B = 16, L = 243; J = 17 at
              d = 64, S = 16 at d = 16; rows a frame's qkv row apart), fp32
              and bf16: against their plain versions (TOL, GRAD_TOL), bf16
              against fp64 within BF16_ACCURACY_RATIO x the plain version's
              error, and timed beside the fold layout's windows of the same
              shape, their bound and SDPA on the same views. The kernels
              line names them as K3's and K4's ``_strided`` variants.
35-36. joint-major serving and train step - ``predict_video`` (16 windows,
              TTA) and the train step (B = 16, drop-path 0.1) with
              model.layout=joint_major, fp32 then bf16: launches as in the
              fold layout, on the dtype's operands; frames/s and
              sequences/s beside the fold layout's; fold against
              joint-major on the card (fp32 MODEL_TOL of the magnitude,
              bf16 both branches within BF16_TOL); fp32 2 windows and one
              train-step window on the card against the CPU; bf16
              joint-major against fold gradients on the card, and the
              bf16 train step on one window against the CPU by phase 10's
              rules.
37. remat   - the flagship train step with model.remat=true against the
              plain step from the same weights and generator, fp32 and
              bf16: losses, gradients (GRAD_TOL) and the generator state;
              K1, K3 and K5 launched twice a layer; peak memory and
              sequences/s of both.
38. megastep - ``make_multi_train_step`` (one CUDA graph of K steps) on the
              3DHP bf16 step (L = 27, B = 25, K = 4), the flagship bf16
              step (K = 2) and the 3DHP step with remat (K = 4): one call
              against K single steps from the same weights and generator
              (losses 1e-4 relative, weights within 2 K lr (1 - b1) /
              sqrt(1 - b2), the generator alike), new masks at the second
              replay, replayed launches = captured x replays; sequences/s
              and the device's busy share beside single steps. Then (after
              phase 24) the 3DHP driver in bf16 with train.steps_per_call=4
              (the loop's megastep, protocol off): finite losses, replays
              made, sequences/s by epoch beside phase 21's.
39. toy     - ``toy.main`` on the card and on the CPU: hard-2 with
              constrained_rmcl, torus-2Dto3D with constrained_rmcl, hard-2
              with the plain MLP and the hard-2 diffusion baseline, their
              config groups cut to TOY_EPOCHS epochs: finite losses and
              metrics, printed side by side with each run's wall time.
40. rank probes - whether two ranks can share the one card: two
              processes of this script on cuda:0 over nccl, then over gloo
              with CUDA tensors, each trying parallel/'s all-reduce,
              all-gather and P2P hop; what each backend did is printed (no
              staging through host memory is added to make one work).
41. ring    - ``parallel.ring_attention`` at the flagship's temporal shape
              (272 x 8 heads x 243 x 64), fp32 and bf16, over a world-1
              nccl group: forward and dQ/dK/dV against the plain dense
              attention (TOL, GRAD_TOL), its ms beside K1's and K2's.
42. sharded steps - on that group, the pipelined flagship
              (``make_pipelined_apply``, M = 4) and the flagship under each
              ``shard_params`` mode (tp, dp, fsdp_dp, fsdp): one bf16 train
              step (B = 16, drop-path off) each against the plain step from
              the same weights (losses, gradients gathered into the
              single-device layout), K1-K6 launched inside on bf16
              operands, sequences/s beside phase 9's and peak memory.
43. figures - ``toy.paper_figures.train_figure_models`` (hard-2) on the
              card and on the CPU by phase 39's rules, then Figures 4 and 8
              where matplotlib imports (else reported as not drawn).
44. viz     - on H36M-format npz files from ``run.seed`` (phases 12-15's),
              the H36M driver with run.train=false run.test=false
              run.viz=true at the flagship (fp32, TTA): S11, walking,
              camera 0, 16 windows lifted on the card, K1, K3 and K5
              launched (printed); the animation drawn where matplotlib
              imports, else ``viz.driver.render_module`` must raise the
              ImportError naming it, and the phase records the panels
              instead of drawing them (reported as not drawn). Then
              ``lift_for_viz`` on the card against the CPU on
              VIZ_CPU_WINDOWS window(s) from the same seeded weights,
              (N*L, J, 3) and (N*L, H, J, 4), within MODEL_TOL of the
              magnitude; then the viz CLI (``tools.viz``) with rmcl_manifold
              and mixste from the seeded init, lifted on the card.
45. tools   - ``count_n_params`` (three counts); ``bench_eval`` and
              ``bench_eval --int8`` (its JSON lines beside phases 3's and
              29's frames/s, and which path ``quantize=True`` took);
              ``bench_sustained --epochs 1`` (bf16, 40 videos, through
              ``prefetch``) beside phase 9's blocked rate;
              ``synthetic_overfit --small`` (eval MPJPE below the
              predict-zero baseline); ``robustness_sweep`` on the npz files
              (2 miss types x 2 rates, every MPJPE finite);
              ``step_ablation`` (full, no_seg, no_decode, k1; bf16, B=16,
              L=243: ms per step and marginals, after K1-K6 counted on
              bf16 operands in ``full``); ``hp_search --driver toy`` (3
              trials at phase 39's cut, then a second call that resumes
              from the journal and runs none).
46. mlflow  - the training driver with run.mlflow_on=true, one short epoch
              (LOOP_OVERRIDES): no exception without mlflow, the history
              written as metrics.csv.
47. analysis - ``tools.eval_baselines`` on seeded (4, 243, 17, 3) dumps, on
              the card and with ``--device cpu``: the H36M skeleton with
              targets, then ``--skeleton=3dhp --pck`` under the three
              alignments, every printed number within ANALYSIS_TOL relative;
              then ``tools.plot_analysis`` on the fp32 eval run directory of
              phases 12-15: the figures' data printed (sweep rows, the
              spread matrix's shape and maximum, the scatter points), the
              figures drawn where matplotlib imports, else each drawing must
              raise the ImportError naming it (reported as not drawn). No
              kernel launches.
48. toy tables - ``tools.quantitative_comparison --setting toy2d`` and
              ``toy3d`` on the card, cut to TABLE_SEEDS at phase 39's
              TOY_EPOCHS, then ``tools.get_table_data`` over each setting's
              six run directories: three rows with n = 2, every cell finite.
              No kernel launches.
49. muP     - ``tools.mup_coord_check`` at MUP_WIDTHS for MUP_STEPS steps on
              the card and on the CPU from the same weights: step 0 within
              MODEL_TOL of the magnitude, the later steps' gaps printed;
              K3-K6 launched on fp32 operands, K1 and K2 not (L = 27); then
              ``tools.mup_lr_transfer.lr_transfer`` at MUP_WIDTHS, 40 steps,
              seeds (0, 1), under muP (transfer gap < 0.15, best-rate drift
              <= 1: tests/test_mup.py's assertion) and under the standard
              parametrization (its gap printed).
50. fast    - ``model=fast`` (configs/model/fast.yaml: the segments branch
              128 wide in 2 heads of 64) at the flagship: ``predict_video``
              on 16 windows in fp32 and one bf16 train step at B = 16, K1-K6
              launched with every attention at head dim 64 (no padding),
              frames/s and sequences/s beside phases 3's and 9's; 2 windows
              in fp32 on the card against the CPU within MODEL_TOL; then
              ``tools.seg_heads_ab`` at its protocol scale cut to one seed
              and SEG_AB_EPOCHS epochs: both arms finite.
51. dstformer - MotionBERT's DSTformer at the published sizes
              (``model=dstformer train=motionbert_ft``, fp32) with seeded
              weights, its fusions drawn away from 1/2: ``predict_video``
              with flip TTA on DSTFORMER_WINDOWS windows, then one AdamW
              step of the fine-tuning loss at that batch; K1-K6 and the
              fusion kernels (in ``ops.launch_counts()`` beside K1-K6)
              launched as the depths and streams say, five ``model.fuse``
              spans a forward of B*F*J rows, poses, losses and every
              gradient finite; frames/s and sequences/s.

What one card cannot show (collectives between cards, scaling over
cards, the pipeline's bubble) is not measured here. On a machine with N
cards ``python3 chip_smoke.py --ranks N`` builds the kernels, then runs N
ranks under torchrun over nccl, one card each: phase 41's ring on a ring
of N; phase 42's step under every layout (dp and fsdp_dp on N x 1; tp,
fsdp, ring and the pipeline on N/2 x 2 and 1 x N) against the plain
step, fp32 within the limits, bf16 finite and timed; and the H36M
training driver under dp x N and tp, fsdp, the pipeline and ring on
N/2 x 2, with its checkpoints, serving and resume (``rank_worker``).

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
# K5's two fp32 kernels at C = 512: timed at one row tile, a streaming
# push's rows (27 x 17), the 3DHP batch's, 16896, the lift's window
# batch's and the train step's; their largest errors against fp64, each
# held against the other's, at four row counts, one of them ragged
K5_PATH_ROWS = (64, 459, 11475, 16896, 33048, 66096)
K5_ACCURACY_ROWS = (16896, 33048, 66096, 66097)
# K5's launches on wgmma per flagship forward: the rotations trunk's 16
# MLPs (8 layers, C = 512) in fp32; the segments trunk's 4 (C = 128) and
# every bf16 launch run the mma.sync kernel. A train step's K6 launches
# follow its K5 launches: 16 of its 20 on wgmma in fp32.
WGMMA_PER_FORWARD = {"float32": 16, "bfloat16": 0}
# K6's two fp32 paths at C = 512, H = 1024: the rows of the flagship's
# B = 16 train step (16 x 243 x 17) and of the DSTformer's B = 32 one
K6_PATH_ROWS = (66096, 132192)

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

# the TPU kernel each of K1-K6 replaces; the DSTformer's stream fusion
# kernels replace none (the JAX package has no DSTformer). Each kernel's
# library, paths and device kernels are ``ops.launches.KERNELS``.
REPLACES = {
    "attention_dense": "manipose_tpu/ops/pallas_attention.py:97",
    "attention_dense_bwd": "manipose_tpu/ops/pallas_attention.py:119",
    "attention_packed": "manipose_tpu/ops/pallas_attention.py:224",
    "attention_packed_bwd": "manipose_tpu/ops/pallas_attention.py:248",
    "fused_mlp": "manipose_tpu/ops/pallas_mlp.py:95",
    "fused_mlp_bwd": "manipose_tpu/ops/pallas_mlp.py:172",
}
# the fusion at the benchmark's mb-h36m-train-b32 shape: 32 windows of 243
# frames x 17 joints, C = 512, fp32. Tolerances against the plain version on
# the same inputs, relative to its largest magnitude (sums in another
# order): out, alpha and the streams' gradients FUSION_TOL (a row's two
# dot products of 2C terms); dW and db, sums over every row, FUSION_TOL x
# sqrt(R / 1024). A kernel that drops one of the backward's 264 block
# partials moves dW by about 1/sqrt(264) of itself, 500 times that.
FUSION_ROWS = 32 * 243 * 17
FUSION_CHANNELS = 512
FUSION_TOL = 1e-5
# the DSTformer at the published sizes: per forward 5 depths x 2 streams of
# one temporal (K1) and one spatial (K3) attention and two MLPs (K5), and 5
# fusions; DSTFORMER_WINDOWS windows of 243 frames a batch
DSTFORMER_LAUNCHES_PER_FORWARD = {"attention_dense": 10, "attention_packed": 10,
                                  "fused_mlp": 20}
DSTFORMER_FUSIONS_PER_FORWARD = 5
DSTFORMER_WINDOWS = 4
DSTFORMER_LR = 5e-4  # configs/train/motionbert_ft.yaml

def kernel_table() -> dict:
    """{kernel: dict(source, replaces, device kernels of all its paths)}
    from the port's inventory."""
    from manipose_tpu_torch.ops import launches

    return {name: dict(source=f"manipose_tpu_torch/ops/csrc/{k['library']}.cu",
                       replaces=REPLACES.get(name),
                       device=tuple(d for ds in k["paths"].values() for d in ds))
            for name, k in launches.KERNELS.items()}


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
        plain = re.search(r"Compiling entry function '.*?\d([a-z_]+_kernel(?:_[a-z0-9]+)?)E",
                          line)
        if m:
            targs = m.group(2).replace("13__nv_bfloat16", "bf16").replace("S1_", "bf16")
            kernel = f"{m.group(1)}<{targs.replace('Li', ',').replace('E', '')}>"
        elif plain:  # not a template
            kernel = plain.group(1)
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
    tensor-core instructions (fatal where a library of matrix products has
    none, or a per-window attention kernel has none; the DSTformer's fusion
    kernels are bound by bytes and take none); K3's and K4's launch
    shapes."""
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
        if name != "fusion":
            require(sum(total.values()) > 0, f"the {name} kernels run on the tensor cores")
        for ours, meta in kernel_table().items():
            for device_name in meta["device"]:
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


def mlp_args(gen, m, c, h):
    """x (m, c) ~ N(0, 1) and torch-default-init weights, fp32 on the card."""
    def uniform(shape, fan_in):
        return (torch.rand(shape, generator=gen, device="cuda") * 2 - 1) / fan_in**0.5

    x = torch.randn((m, c), generator=gen, device="cuda")
    return x, uniform((h, c), c), uniform((h,), c), uniform((c, h), h), uniform((c,), h)


def mlp_case(trunk, m, c, h, dtype, gen):
    """K5 at one shape, torch-default-init scaled weights."""
    import torch.nn.functional as F

    from manipose_tpu_torch.ops import cuda_mlp as cm

    x, w1, b1, w2, b2 = (a.to(dtype) for a in mlp_args(gen, m, c, h))
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
    cases = {name: [] for name in REPLACES}
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


def phase_k5_paths() -> list:
    """K5's two fp32 kernels at the rotations trunk's widths: the path rule,
    both kernels' times at K5_PATH_ROWS beside the bound, and their errors
    against an fp64 MLP at K5_ACCURACY_ROWS, bit-for-bit repeats."""
    import torch.nn.functional as F

    from manipose_tpu_torch import ops
    from manipose_tpu_torch.ops import cuda_mlp as cm

    c, h = 512, 1024
    require(cm.takes_wgmma(torch.float32, c, h), "fp32 C=512 takes the wgmma kernel")
    picked, other = "wgmma", "mma.sync"
    require(not cm.takes_wgmma(torch.bfloat16, c, h) and not cm.takes_wgmma(
        torch.float32, 128, 256), "bf16 and C=128 take the mma.sync kernel")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for m in K5_PATH_ROWS + tuple(r for r in K5_ACCURACY_ROWS if r not in K5_PATH_ROWS):
        x, w1, b1, w2, b2 = mlp_args(gen, m, c, h)
        row = dict(m=m, picked=picked)
        if m in K5_PATH_ROWS:
            flops = 4.0 * m * c * h
            row["bound_ms"], row["bound_by"] = bound_ms((2 * m * c + 2 * c * h + h + c) * 4,
                                                        flops, torch.float32)
            for path in (picked, other):
                ms = time_ms(lambda: cm.K5_LAUNCHERS[path](x, w1, b1, w2, b2))
                row[f"{path}_ms"], row[f"{path}_tflops"] = ms, flops / ms * 1e-9
            require(row[f"{picked}_ms"] <= row[f"{other}_ms"],
                    f"K5 M={m}: the picked kernel is no slower ({row})")
        if m in K5_ACCURACY_ROWS:
            ref = F.linear(F.gelu(F.linear(x.double(), w1.double(), b1.double())),
                           w2.double(), b2.double())
            first, again, old = (cm.K5_LAUNCHERS[path](x, w1, b1, w2, b2)
                                 for path in ("wgmma", "wgmma", "mma.sync"))
            torch.cuda.synchronize()
            row["wgmma_err"] = (first.double() - ref).abs().max().item()
            row["mma.sync_err"] = (old.double() - ref).abs().max().item()
            row["bitwise_repeat"] = torch.equal(first, again)
            tol = TOL[("mlp", torch.float32)]
            require(row["wgmma_err"] <= tol and row["wgmma_err"] <= 1.25 * row["mma.sync_err"],
                    f"K5 M={m}: wgmma error within {tol} and 1.25 x mma.sync's ({row})")
            require(row["bitwise_repeat"], f"K5 M={m}: repeated runs agree bit for bit")
        print("k5 path " + " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                                    for k, v in row.items()), flush=True)
        rows.append(row)
        del x, w1, b1, w2, b2
    # through the wrapper: the counter shows the rule's pick
    x, w1, b1, w2, b2 = mlp_args(gen, 459, c, h)
    ops.reset_launch_counts()
    cm.fused_mlp(x, w1, b1, w2, b2)
    cm.fused_mlp(*(a.to(torch.bfloat16) for a in (x, w1, b1, w2, b2)))
    torch.cuda.synchronize()
    on_wgmma = ops.launch_counts(path="wgmma")
    require(on_wgmma["fused_mlp"] == ops.launch_counts(torch.float32, "wgmma")["fused_mlp"] == 1
            and ops.launch_counts()["fused_mlp"] == 2,
            f"K5's wgmma launches counted ({on_wgmma})")
    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    return rows


def phase_k6_paths() -> list:
    """K6's two fp32 paths at the rotations trunk's widths: the path rule,
    both paths' times at K6_PATH_ROWS beside the bound and the library's
    backward, their five gradients' errors against fp64, bit-for-bit
    repeats, and the wrapper's counts."""
    import torch.nn.functional as F

    from manipose_tpu_torch import ops
    from manipose_tpu_torch.ops import cuda_mlp as cm

    c, h = 512, 1024
    picked, other = "wgmma", "mma.sync"
    gen = torch.Generator(device="cuda").manual_seed(2)
    names = ("dx", "dw1", "db1", "dw2", "db2")
    rows = []
    for m in K6_PATH_ROWS:
        x, w1, b1, w2, b2 = mlp_args(gen, m, c, h)
        g = torch.randn((m, c), generator=gen, device="cuda")
        flops = 10.0 * m * c * h
        row = dict(m=m, picked=picked)
        row["bound_ms"], row["bound_by"] = bound_ms((3 * m * c + 4 * c * h + 2 * h + c) * 4,
                                                    flops, torch.float32)
        for path in (picked, other):
            ms = time_ms(lambda: cm.K6_LAUNCHERS[path](x, w1, b1, w2, g))
            row[f"{path}_ms"], row[f"{path}_tflops"] = ms, flops / ms * 1e-9
        require(row[f"{picked}_ms"] <= row[f"{other}_ms"],
                f"K6 M={m}: the picked path is no slower ({row})")
        leaves = [t.detach().requires_grad_() for t in (x, w1, b1, w2, b2)]
        lib_out = F.linear(F.gelu(F.linear(leaves[0], leaves[1], leaves[2])),
                           leaves[3], leaves[4])
        row["library_ms"] = median_ms(lambda: torch.autograd.grad(
            lib_out, leaves, g, retain_graph=True))
        del leaves, lib_out
        first, again, old = (cm.K6_LAUNCHERS[path](x, w1, b1, w2, g)
                             for path in (picked, picked, other))
        ref = cm.mlp_plain_bwd(*(t.double() for t in (x, w1, b1, w2, g)))
        torch.cuda.synchronize()
        for name, a, b, o, r in zip(names, first, again, old, ref):
            scale = max(1.0, r.abs().max().item())
            row[f"{name}_err"] = (a.double() - r).abs().max().item() / scale
            row[f"{name}_old_err"] = (o.double() - r).abs().max().item() / scale
            require(row[f"{name}_err"] <= GRAD_TOL[torch.float32],
                    f"K6 M={m} {name}: wgmma error within {GRAD_TOL[torch.float32]} ({row})")
            # the products' accumulation schemes differ; db1 and db2 are fp32
            # sums on both paths, in another order
            require(name.startswith("db") or row[f"{name}_err"] <= 1.25 * row[f"{name}_old_err"],
                    f"K6 M={m} {name}: wgmma error within 1.25 x mma.sync's ({row})")
            require(torch.equal(a, b), f"K6 M={m} {name}: repeated runs agree bit for bit")
        print("k6 path " + " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                                    for k, v in row.items()), flush=True)
        rows.append(row)
        del x, w1, b1, w2, b2, g, first, again, old, ref
        torch.cuda.empty_cache()
    # through the wrapper: the counter shows the rule's pick
    x, w1, b1, w2, _ = mlp_args(gen, 459, c, h)
    g = torch.randn((459, c), generator=gen, device="cuda")
    ops.reset_launch_counts()
    cm.fused_mlp_bwd(x, w1, b1, w2, g)
    cm.fused_mlp_bwd(*(a.to(torch.bfloat16) for a in (x, w1, b1, w2, g)))
    torch.cuda.synchronize()
    on_wgmma = ops.launch_counts(path="wgmma")
    require(ops.launch_counts(torch.float32, "wgmma")["fused_mlp_bwd"] == 1
            and on_wgmma["fused_mlp_bwd"] == 1 and on_wgmma["fused_mlp"] == 0
            and ops.launch_counts()["fused_mlp_bwd"] == 2,
            f"K6's wgmma launches counted ({on_wgmma})")
    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    return rows


def fusion_work(rows: int, c: int, backward: bool) -> tuple:
    """(FLOPs, bytes) of one fusion launch over ``rows`` rows of ``c``
    channels in fp32, each input byte read once and each output byte written
    once: the forward two logits of 2C products a row and the blend, reading
    x_st and x_ts, writing x and alpha; the backward two dot products with
    dx a row, the streams' gradients and dW's sums, reading dx, x_st, x_ts
    and alpha, writing dx_st and dx_ts; each reads W and b, and the backward
    writes dW and db (``benchmark/archs/dstformer.py``'s ``fusion_work``,
    one direction of one depth)."""
    if backward:
        return rows * (2 * 2 * c + 4 * c + 4 * c), 4 * (5 * rows * c + 2 * rows
                                                        + 2 * (4 * c + 2))
    return rows * (2 * 2 * 2 * c + 3 * c), 4 * (3 * rows * c + 2 * rows + 4 * c + 2)


def phase_fusion_kernels() -> dict:
    """Phase 2's stream fusion kernels at FUSION_ROWS x FUSION_CHANNELS:
    out and alpha against ``fusion_plain``, dx_st, dx_ts, dW and db against
    ``fusion_plain_bwd``, on the same card tensors; the backward bit for bit
    the same on a second run; each direction timed beside its bound, its
    plain version and the library operations (concatenation, Linear,
    softmax and blend; autograd's backward of them). Returns {kernel:
    [case]}."""
    import torch.nn.functional as F

    from manipose_tpu_torch.ops import cuda_fusion as cf

    r, c = FUSION_ROWS, FUSION_CHANNELS
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs, xt, g = (torch.randn((r, c), generator=gen, device="cuda") for _ in range(3))
    # logits of deviation about 1, so the alphas spread over (0, 1)
    w = torch.randn((2, 2 * c), generator=gen, device="cuda") / (2 * c) ** 0.5
    b = torch.randn((2,), generator=gen, device="cuda")

    def gap(got, want) -> float:
        return float((got.double() - want.double()).abs().max() / want.double().abs().max())

    out, alpha = cf.fusion_forward(xs, xt, w, b)
    want_out, want_alpha = cf.fusion_plain(xs, xt, w, b)
    a0 = want_alpha[:, 0]
    spread = float((a0 - 0.5).abs().mean())
    require(spread > 0.1, f"the fusion case's alphas spread from 1/2 ({spread:.3g})")
    fwd_errs = {"out": gap(out, want_out), "alpha": gap(alpha, want_alpha)}
    got = cf.fusion_backward(g, xs, xt, alpha, w)
    want = cf.fusion_plain_bwd(g, xs, xt, want_alpha, w)
    sums = FUSION_TOL * max(1.0, (r / 1024) ** 0.5)
    tols = {"out": FUSION_TOL, "alpha": FUSION_TOL, "dx_st": FUSION_TOL,
            "dx_ts": FUSION_TOL, "dW": sums, "db": sums}
    bwd_errs = {}
    for name, x, y in zip(("dx_st", "dx_ts", "dW", "db"), got, want):
        require(x.shape == y.shape, f"fusion {name} shape {tuple(x.shape)}, want {tuple(y.shape)}")
        bwd_errs[name] = gap(x, y)
    for name, err in {**fwd_errs, **bwd_errs}.items():
        require(err <= tols[name], f"stream fusion {name} within {tols[name]:.3g} of the "
                                   f"plain version ({err:.3g})")
    again = cf.fusion_backward(g, xs, xt, alpha, w)
    require(all(torch.equal(x, y) for x, y in zip(got, again)),
            "the fusion backward is bit for bit the same on a second run")

    def library_fwd():
        a = torch.softmax(F.linear(torch.cat([xs, xt], -1), w, b), -1)
        return a[:, :1] * xs + a[:, 1:] * xt

    leaves = [t.clone().requires_grad_(True) for t in (xs, xt, w, b)]

    def library_bwd():
        a = torch.softmax(F.linear(torch.cat(leaves[:2], -1), leaves[2], leaves[3]), -1)
        torch.autograd.grad(a[:, :1] * leaves[0] + a[:, 1:] * leaves[1], leaves, g)

    cases = {}
    for name, errs, run, plain, library, backward in (
            ("stream_fusion", fwd_errs, lambda: cf.fusion_forward(xs, xt, w, b),
             lambda: cf.fusion_plain(xs, xt, w, b), library_fwd, False),
            ("stream_fusion_bwd", bwd_errs, lambda: cf.fusion_backward(g, xs, xt, alpha, w),
             lambda: cf.fusion_plain_bwd(g, xs, xt, alpha, w), library_bwd, True)):
        flops, n_bytes = fusion_work(r, c, backward)
        ms = time_ms(run)
        b_ms, b_by = bound_ms(n_bytes, flops, torch.float32)
        cases[name] = [dict(
            trunk="dstformer-b32", dtype="float32", shape=[r, c],
            max_abs_err=max(errs.values()), errs=errs,
            tol={k: tols[k] for k in errs}, ms=ms, tflops=flops / ms * 1e-9,
            plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
            roofline_pct=100 * b_ms / ms,
            library_ms=median_ms(library),
        )]
    torch.cuda.empty_cache()
    for name, rows in cases.items():
        for k in rows:
            print(f"kernel {name:20s} {k['trunk']:23s} {k['dtype']:8s} shape={k['shape']} "
                  f"errs={json.dumps({e: float(f'{v:.3g}') for e, v in k['errs'].items()})} "
                  f"ms={k['ms']:.4f} plain_ms={k['plain_ms']:.4f} "
                  f"bound_ms={k['bound_ms']:.4f} ({k['bound_by']}; "
                  f"{k['roofline_pct']:.1f} % of it) library_ms={k['library_ms']:.4f}"
                  + (" (forward and backward)" if name.endswith("_bwd") else ""),
                  flush=True)
    return cases


def bone_lengths(poses: np.ndarray, parents) -> np.ndarray:
    js = [i for i, p in enumerate(parents) if p >= 0]
    ps = [parents[i] for i in js]
    return np.linalg.norm(poses[..., js, :] - poses[..., ps, :], axis=-1)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def require_counts(dtype: str, want: dict, what: str) -> dict:
    """The launches since the last reset, all on ``dtype`` operands: of each
    kernel ``want[kernel]`` (0 where not given), and ``want[kernel, path]``
    on each path given. Returns the counts by kernel."""
    from manipose_tpu_torch import ops

    counts = ops.launch_counts()
    on_dtype = ops.launch_counts(DTYPES[dtype])
    print(f"{what} launches {counts} ({dtype} operands: {on_dtype}; on wgmma: "
          f"{ops.launch_counts(path='wgmma')})")
    for name in counts:
        n = want.get(name, 0)
        require(counts[name] == n, f"{what}: {name} launched {counts[name]}, want {n}")
        require(on_dtype[name] == n, f"{what}: {name} launched {on_dtype[name]} "
                                     f"times on {dtype} operands, want {n}")
    for key, n in want.items():
        if isinstance(key, tuple):
            name, path = key
            got = ops.launch_counts(path=path)[name]
            require(got == n, f"{what}: {name} on {path} {got} times, want {n}")
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
        dtype, {**{k: 2 * n * n_batches for k, n in LAUNCHES_PER_FORWARD.items()},
                ("fused_mlp", "wgmma"): 2 * WGMMA_PER_FORWARD[dtype] * n_batches},
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
    counts = require_counts(dtype, {**LAUNCHES_PER_TRAIN_STEP,
                                    ("fused_mlp", "wgmma"): WGMMA_PER_FORWARD[dtype],
                                    ("fused_mlp_bwd", "wgmma"): WGMMA_PER_FORWARD[dtype]},
                            f"{dtype} train step")
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


def phase_cpu_vs_card_train_bf16(weights, extra=()) -> None:
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
    bf16 spread + GAP_SLACK where that is larger. ``extra``: overrides of
    the model (the joint-major layout in phase 36)."""
    from manipose_tpu_torch.config import load_config

    cfg = load_config("config", ["model.drop_path_rate=0.0", "model.dtype=bfloat16",
                                 *extra])
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
    want32 = branch_grads(load_config("config", ["model.drop_path_rate=0.0", *extra]),
                          "cpu", weights, x)
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
    print(f"cpu vs card bf16 train step {' '.join(extra)} (one flagship window, "
          f"drop-path off; the "
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
    for name in REPLACES:
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
    for name in REPLACES:
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
    counts = dict.fromkeys(ops.launch_counts(), 0)
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
    for ours, meta in kernel_table().items():
        if any(n in name for n in meta["device"]):
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


# ---- trunk variants and the toy experiments (phases 34-39) -------------------

def jm_views(gen, batch, l, j, heads, d, dtype):
    """q, k, v as (B, L, h, J, d) views of one joint-major (B, J, L, 3*h*d)
    qkv tensor (the joint-major trunk's spatial layer), and an output
    gradient in the joint-major output's layout."""
    from manipose_tpu_torch.ops import cuda_attention as ca

    qkv = torch.randn((batch, j, l, 3 * heads * d), generator=gen, device="cuda").to(dtype)
    dout = torch.randn((batch, j, l, heads, d), generator=gen, device="cuda").to(dtype)
    return ca.split_heads(qkv, heads), dout.permute(0, 2, 3, 1, 4)


def jm_fp64(q, k, v, dout, scale):
    """out, dq, dk, dv in fp64 from the same (bf16) values."""
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, dout))
    p = torch.softmax(q64 @ k64.transpose(-1, -2) * scale, -1)
    dp = do64 @ v64.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return [p @ v64, ds @ k64 * scale, ds.transpose(-1, -2) @ q64 * scale,
            p.transpose(-1, -2) @ do64]


def phase_joint_major_kernels():
    """K3/K4 on the joint-major trunk's strided windows at the flagship's
    shapes (B = 16, L = 243: windows (b, l, h) of J = 17 joints at d = 64
    and of S = 16 bones at d = 16, rows a frame's qkv row apart), fp32 and
    bf16: against their plain versions (TOL, GRAD_TOL), in bf16 against
    fp64 within BF16_ACCURACY_RATIO x the plain version's error, and timed
    beside the fold layout's windows of the same shape, their bound and
    SDPA (forward, and its autograd backward) on the same views. Returns
    {kernel: [case]}."""
    import torch.nn.functional as F

    from manipose_tpu_torch.ops import cuda_attention as ca

    gen = torch.Generator(device="cuda").manual_seed(11)
    b, l = TRAIN_BATCH, 243
    out = {"attention_packed": [], "attention_packed_bwd": []}
    for dtype in (torch.float32, torch.bfloat16):
        for trunk, j, d in (("rotations", 17, 64), ("segments", 16, 16)):
            (q, k, v), dout = jm_views(gen, b, l, j, 8, d, dtype)
            scale = d**-0.5
            fwd = ca.attention_packed(q, k, v, scale)
            bwd = ca.attention_packed_bwd(q, k, v, dout, scale)
            require(fwd.permute(0, 3, 1, 2, 4).is_contiguous(),
                    "K3 writes the joint-major output in place")
            require(bwd.shape == (b, j, l, 3, 8, d) and bwd.is_contiguous(),
                    "K4 writes the joint-major qkv gradient in place")
            plain_out = ca.attention_plain(q, k, v, scale)
            plain_grads = ca.attention_plain_bwd(q, k, v, dout, scale)
            want = torch.stack([g.permute(0, 3, 1, 2, 4) for g in plain_grads], dim=3)
            torch.cuda.synchronize()
            f_err = (fwd.float() - plain_out.float()).abs().max().item()
            b_err = (bwd.float() - want.float()).abs().max().item()
            f_tol, b_tol = TOL[("attention", dtype)], grad_tol(want, dtype, relative=False)
            require(f_err <= f_tol, f"joint-major K3 {trunk} {dtype}: {f_err} > {f_tol}")
            require(b_err <= b_tol, f"joint-major K4 {trunk} {dtype}: {b_err} > {b_tol}")
            accuracy = ""
            if dtype == torch.bfloat16:
                ref = jm_fp64(q, k, v, dout, scale)
                got = [fwd] + [t.permute(0, 2, 3, 1, 4) for t in bwd.unbind(3)]
                ratios = []
                for name, g, pl, w in zip(("out", "dq", "dk", "dv"), got,
                                          [plain_out, *plain_grads], ref):
                    e_k = ((g.double() - w).norm() / w.norm()).item()
                    e_p = ((pl.double() - w).norm() / w.norm()).item()
                    bound = BF16_ACCURACY_RATIO * e_p + BF16_ACCURACY_SLACK
                    require(e_k <= bound, f"joint-major bf16 {trunk} {name}: error against "
                                          f"fp64 {e_k} > {BF16_ACCURACY_RATIO} x plain {e_p}")
                    ratios.append(f"{name} {e_k / e_p:.4f}")
                del ref, got
                accuracy = "; bf16 error against fp64 / plain's: " + ", ".join(ratios)
            del plain_out, plain_grads, want
            windows = b * l * 8
            elem = q.element_size()
            # fold layout: the same windows as strided (B*L, h, J, d) views
            fold_qkv = torch.randn((b * l, j, 3, 8, d), generator=gen, device="cuda").to(dtype)
            fq, fk, fv = (t.transpose(1, 2) for t in fold_qkv.unbind(2))
            fdout = torch.randn((b * l, j, 8, d), generator=gen,
                                device="cuda").to(dtype).transpose(1, 2)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*leaves, scale=scale)
            for kind, run, fold_run, plain_run, lib, n_bytes, flops, err, tol in (
                ("attention_packed", lambda: ca.attention_packed(q, k, v, scale),
                 lambda: ca.attention_packed(fq, fk, fv, scale),
                 lambda: ca.attention_plain(q, k, v, scale),
                 lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                 4 * windows * j * d * elem, 4.0 * windows * j * j * d, f_err, f_tol),
                ("attention_packed_bwd", lambda: ca.attention_packed_bwd(q, k, v, dout, scale),
                 lambda: ca.attention_packed_bwd(fq, fk, fv, fdout, scale),
                 lambda: ca.attention_plain_bwd(q, k, v, dout, scale),
                 lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True),
                 7 * windows * j * d * elem, 10.0 * windows * j * j * d, b_err, b_tol),
            ):
                b_ms, b_by = bound_ms(n_bytes, flops, dtype)
                ms, fold_ms = time_ms(run), time_ms(fold_run)
                case = dict(trunk=f"joint-major {trunk}", dtype=str(dtype)[6:],
                            shape=[b, l, 8, j, d], max_abs_err=err, tol=tol, ms=ms,
                            tflops=flops / ms * 1e-9, fold_ms=fold_ms,
                            plain_ms=time_ms(plain_run), bound_ms=b_ms, bound_by=b_by,
                            library_ms=median_ms(lib))
                out[kind].append(case)
                print(f"kernel {kind:20s} joint-major {trunk:9s} {case['dtype']:8s} "
                      f"(B, L, h, J, d)={case['shape']} row stride "
                      f"{l * 3 * 8 * d * elem} B: err={err:.3g} ms={ms:.4f} "
                      f"({case['tflops']:.1f} TFLOP/s) fold_ms={fold_ms:.4f} "
                      f"plain_ms={case['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                      f"library_ms={case['library_ms']:.4f}"
                      + (accuracy if kind == "attention_packed" else ""), flush=True)
            del q, k, v, dout, fwd, bwd, fold_qkv, fq, fk, fv, fdout, leaves, lib_out
            torch.cuda.empty_cache()
    return out


def serving_fps(predictor, video, reps: int = 3) -> float:
    predictor.predict_video(video)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        predictor.predict_video(video)
    return video.shape[0] * reps / (time.perf_counter() - t0)


def phase_joint_major_serving(dtype: str, fold_predictor):
    """``predict_video`` of the flagship in the joint-major layout (16
    windows of 243, TTA, the fold predictor's weights) on the card: K1, K3
    and K5 launched per window batch as in fold serving, all on the dtype's
    operands; frames/s beside the fold predictor's in this phase; fold
    against joint-major on the card (fp32: poses, hypotheses and scores
    within MODEL_TOL of the magnitude; bf16: both branches' outputs before
    FK within BF16_TOL); and in fp32, 2 windows (TTA off) on the card
    against the CPU within MODEL_TOL of the magnitude. Returns (launch
    counts, frames/s)."""
    from manipose_tpu_torch import ops
    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.serving import Predictor

    cfg = load_config("config", [f"model.dtype={dtype}", "model.layout=joint_major"])
    state = {k: v.cpu() for k, v in fold_predictor.model.state_dict().items()}
    jm = Predictor(cfg=cfg, state_dict=state, batch_size=16, tta=True)
    video = np.random.default_rng(0).normal(size=(16 * 243, 17, 2)).astype(np.float32)
    jm.predict_video(video)
    ops.reset_launch_counts()
    got = jm.predict_video(video, return_hypotheses=True)
    counts = require_counts(dtype, {k: 2 * n for k, n in LAUNCHES_PER_FORWARD.items()},
                            f"joint-major {dtype} serving (1 window batch)")
    want = fold_predictor.predict_video(video, return_hypotheses=True)
    errs = []
    if dtype == "float32":
        for name, g, w in zip(("poses", "hyps", "scores"), got, want):
            err, tol = float(np.abs(g - w).max()), MODEL_TOL * max(1.0, float(np.abs(w).max()))
            require(err <= tol, f"fold vs joint-major {name}: {err} > {tol}")
            errs.append(f"{name} {err:.3g} (tol {tol:.3g})")
    else:
        x = torch.from_numpy(video[:243 * 2].reshape(2, 243, 17, 2)).cuda()
        with torch.inference_mode():
            outs = [(*p.model.rotations_module(x), p.model.segments_module(x))
                    for p in (jm, fold_predictor)]
        for name, g, w in zip(("hypotheses (6D)", "scores", "lengths"), *outs):
            err = rel_err(g.float().cpu().numpy(), w.float().cpu().numpy())
            require(err <= BF16_TOL, f"bf16 fold vs joint-major {name}: {err} > {BF16_TOL}")
            errs.append(f"{name} {err:.3g} (tol {BF16_TOL})")
    fps_fold, fps_jm = serving_fps(fold_predictor, video), serving_fps(jm, video)
    fps_jm = max(fps_jm, serving_fps(jm, video))
    fps_fold = max(fps_fold, serving_fps(fold_predictor, video))
    print(f"joint-major {dtype} serving: {fps_jm:.1f} frames/s, fold {fps_fold:.1f} "
          f"frames/s (best of 2 x 3 calls each, fold, jm, jm, fold; 16 windows, TTA); "
          f"fold vs joint-major on the card: " + ", ".join(errs), flush=True)
    if dtype == "float32":
        window = video[:2 * 243]
        outs = {}
        for device in ("cpu", "cuda"):
            pred = Predictor(cfg=cfg, state_dict=state, batch_size=2, tta=False,
                             device=device)
            outs[device] = pred.predict_video(window, return_hypotheses=True)
        errs = []
        for name, g, w in zip(("poses", "hyps", "scores"), outs["cuda"], outs["cpu"]):
            err, tol = float(np.abs(g - w).max()), MODEL_TOL * max(1.0, float(np.abs(w).max()))
            require(err <= tol, f"joint-major cpu vs card {name}: {err} > {tol}")
            errs.append(f"{name} {err:.3g} (tol {tol:.3g})")
        print("joint-major cpu vs card (2 flagship windows, TTA off, fp32): "
              + ", ".join(errs), flush=True)
    del jm
    torch.cuda.empty_cache()
    return counts, fps_jm


def timed_steps(step, state, x, y, n: int) -> float:
    """sequences/s of ``n`` steps after two warm-ups."""
    for _ in range(2):
        step(state, x, y, TRAIN_LR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, x, y, TRAIN_LR)
    torch.cuda.synchronize()
    return x.shape[0] * n / (time.perf_counter() - t0)


def phase_joint_major_train(dtype: str, fold_seq_s: float, weights):
    """The flagship train step in the joint-major layout (B = 16, drop-path
    0.1): all six kernels launched once a layer, on the dtype's operands;
    sequences/s beside the fold step's (phase 5/9). Then one window,
    drop-path off, from the fold phases' weights: fp32 on the card against
    the CPU (loss terms within TRAIN_LOSS_TOL, every gradient within
    GRAD_TOL of its magnitude); bf16 joint-major against fold on the card
    (the gradients of both branches' outputs under a fixed cotangent within
    BF16_TOL relative in norm), and on the card against the CPU by phase
    10's rules. Returns (launch counts, sequences/s)."""
    from manipose_tpu_torch import ops
    from manipose_tpu_torch.config import load_config

    cfg = load_config("config", [f"model.dtype={dtype}", "model.layout=joint_major"])
    state, step = make_trainer(cfg, "cuda")
    x, y = (t.cuda() for t in flagship_batch(cfg.data.seq_len, TRAIN_BATCH))
    ops.reset_launch_counts()
    require_finite(step(state, x, y, TRAIN_LR), "joint-major train step")
    torch.cuda.synchronize()
    counts = require_counts(dtype, LAUNCHES_PER_TRAIN_STEP, f"joint-major {dtype} train step")
    seq_s = timed_steps(step, state, x, y, 5)
    del state, step
    torch.cuda.empty_cache()
    cfg0 = load_config("config", [f"model.dtype={dtype}", "model.layout=joint_major",
                                  "model.drop_path_rate=0.0"])
    x1, y1 = (t[:1] for t in flagship_batch(cfg0.data.seq_len, 1))
    if dtype == "float32":
        metrics, grads = {}, {}
        for device in ("cpu", "cuda"):
            metrics[device], grads[device] = train_step_on(cfg0, device, weights, x1, y1)
        for k, want in metrics["cpu"].items():
            require(abs(metrics["cuda"][k] - want) <= TRAIN_LOSS_TOL * abs(want),
                    f"joint-major cpu vs card train {k}: {metrics['cuda'][k]} vs {want}")
        worst = max(((g - grads["cpu"][n]).abs().max().item()
                     / max(1.0, grads["cpu"][n].abs().max().item()), n)
                    for n, g in grads["cuda"].items())
        require(worst[0] <= GRAD_TOL[torch.float32],
                f"joint-major cpu vs card gradient {worst[1]}: {worst[0]}")
        check = (f"cpu vs card (one window, drop-path off): loss {metrics['cpu']['loss']:.6f} "
                 f"cpu, {metrics['cuda']['loss']:.6f} card; worst gradient err / max(1, "
                 f"|g|max) {worst[0]:.3g} at {worst[1]} (tol {GRAD_TOL[torch.float32]})")
    else:
        fold_cfg = load_config("config", [f"model.dtype={dtype}", "model.drop_path_rate=0.0"])
        jm_g = branch_grads(cfg0, "cuda", weights, x1)
        fold_g = branch_grads(fold_cfg, "cuda", weights, x1)
        worst = max(((jm_g[n] - g).norm().item() / max(g.norm().item(), 1e-12), n)
                    for n, g in fold_g.items())
        require(worst[0] <= BF16_TOL, f"bf16 joint-major vs fold gradient {worst[1]}: "
                                      f"{worst[0]} > {BF16_TOL}")
        check = (f"joint-major vs fold on the card (one window, drop-path off): worst "
                 f"branch-output gradient rel err in norm {worst[0]:.3g} at {worst[1]} "
                 f"(tol {BF16_TOL})")
        phase_cpu_vs_card_train_bf16(weights, ["model.layout=joint_major"])
    print(f"joint-major {dtype} train step: {seq_s:.2f} sequences/s, fold {fold_seq_s:.2f} "
          f"(B={TRAIN_BATCH}, drop-path 0.1, mean of 5 after 2 warm-ups); {check}",
          flush=True)
    return counts, seq_s


def phase_remat(dtype: str):
    """The flagship train step with remat (model.remat=true: every block
    recomputed in the backward pass) against the plain step from the same
    weights and generator seed (B = 16, drop-path 0.1): the same loss terms
    (5e-5 relative), every gradient within the gradient limit (GRAD_TOL of
    max(1, |g|max)) and the generator left in the same state; the
    recomputed forward launches K1, K3 and K5 twice a layer; peak device
    memory and sequences/s of both. Returns the remat step's launch counts."""
    from manipose_tpu_torch import ops
    from manipose_tpu_torch.config import load_config

    x, y = (t.cuda() for t in flagship_batch(243, TRAIN_BATCH))
    runs = {}
    for remat in ("false", "true"):
        cfg = load_config("config", [f"model.dtype={dtype}", f"model.remat={remat}"])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        state, step = make_trainer(cfg, "cuda")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        metrics = {k: float(v) for k, v in step(state, x, y, TRAIN_LR).items()}
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak = (torch.cuda.max_memory_allocated() - before) / 1e9
        grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
        gen_state = state.generator.get_state()
        seq_s = timed_steps(step, state, x, y, 5)
        runs[remat] = (metrics, grads, gen_state, peak, seq_s, counts)
        del state, step
    (m0, g0, s0, p0, q0, _), (m1, g1, s1, p1, q1, c1) = runs["false"], runs["true"]
    require(torch.equal(s0, s1), "remat leaves the generator where the plain step does")
    for k, want in m0.items():
        require(abs(m1[k] - want) <= TRAIN_LOSS_TOL * max(1.0, abs(want)),
                f"remat {dtype} loss {k}: {m1[k]} vs {want}")
    tol = GRAD_TOL[DTYPES[dtype]]
    worst = max(((g1[n] - g).abs().max().item() / max(1.0, g.abs().max().item()), n)
                for n, g in g0.items())
    require(worst[0] <= tol, f"remat {dtype} gradient {worst[1]}: {worst[0]} > {tol}")
    for name, n in LAUNCHES_PER_FORWARD.items():
        require(c1[name] == 2 * n, f"remat {dtype}: {name} launched {c1[name]}, want {2 * n}")
    print(f"remat {dtype} train step (B={TRAIN_BATCH}): peak {p1:.2f} GB vs plain "
          f"{p0:.2f} GB; {q1:.2f} sequences/s vs plain {q0:.2f}; worst gradient err / "
          f"max(1, |g|max) {worst[0]:.3g} at {worst[1]} (tol {tol}); generator state equal; "
          f"launches {c1}", flush=True)
    del runs
    torch.cuda.empty_cache()
    return c1


def phase_megastep(label: str, overrides, batch: int, seq_len: int, k: int, calls: int):
    """``train.steps_per_call = k`` (the megastep, one CUDA graph of k
    steps) against k single steps from the same weights and generator seed
    (drop-path on): the losses within 1e-4 relative, every parameter within
    2 k lr (1 - b1) / sqrt(1 - b2), the generator left alike; a second
    replay on the same batches gives other losses (new masks); one capture,
    the replay counter and the replays' launches (the capture's times the
    replays). Then sequences/s and the device's busy share of ``calls``
    megastep calls beside ``calls * k`` single steps. Returns (sequences/s
    single, megastep; busy share single, megastep; replayed launches)."""
    from manipose_tpu_torch import ops
    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.geometry import h36m_skeleton_17
    from manipose_tpu_torch.train import LossConfig, make_multi_train_step

    cfg = load_config("config", list(overrides))
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.normal(size=(k, batch, seq_len, 17, 2)).astype(np.float32))
    ys = torch.from_numpy((0.1 * rng.normal(size=(k, batch, seq_len, 17, 3)))
                          .astype(np.float32))
    xs_d, ys_d = xs.cuda(), ys.cuda()
    state, step = make_trainer(cfg, "cuda")
    weights = {n: v.detach().clone() for n, v in state.model.state_dict().items()}
    singles = [step(state, xs_d[i], ys_d[i], TRAIN_LR) for i in range(k)]
    want_w = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    want_gen = state.generator.get_state()
    state2, _ = make_trainer(cfg, "cuda", state_dict=weights)
    t = cfg.train
    loss_cfg = LossConfig(sq_loss=t.sq_loss, w_loss=t.w_loss, vel_loss=t.vel_loss,
                          smooth_reg=t.smooth_reg, rmcl_score_reg=t.rmcl_score_reg,
                          rigid_seg_reg=t.rigid_seg_reg, rmcl=True)
    multi = make_multi_train_step(state2.model, loss_cfg, h36m_skeleton_17(),
                                  state2.optimizer, k)
    ops.reset_launch_counts()
    got = multi(state2, xs_d, ys_d, TRAIN_LR)
    torch.cuda.synchronize()
    require(multi.captures == 1 and multi.replays == 1, f"{label}: one capture, one replay")
    # the launches the capture recorded (the wrappers counted them there;
    # the warm-up step before it launched one step's worth eagerly)
    (graph,) = multi.graphs.values()
    captured = ops.by_kernel(graph.launches)
    require(torch.equal(state2.generator.get_state(), want_gen),
            f"{label}: the generator advanced as {k} single steps advance it")
    for key, v in got.items():
        for i in range(k):
            ref = float(singles[i][key])
            require(abs(float(v[i]) - ref) <= 1e-4 * max(1.0, abs(ref)),
                    f"{label} step {i} {key}: {float(v[i])} vs {ref}")
    b1, b2 = ADAM_BETAS
    envelope = 2 * k * TRAIN_LR * (1 - b1) / (1 - b2) ** 0.5
    worst = max(((p - want_w[n]).abs().max().item(), n)
                for n, p in state2.model.named_parameters())
    require(worst[0] <= envelope, f"{label} weights: {worst} > {envelope}")
    again = multi(state2, xs_d, ys_d, TRAIN_LR)
    torch.cuda.synchronize()
    require(not torch.equal(again["loss"], got["loss"]), f"{label}: new masks every replay")
    replayed = ops.replayed_counts()
    require(ops.graph_replays() == 2 and all(
        replayed[n] == 2 * c for n, c in captured.items()),
        f"{label}: replayed launches {replayed} = 2 x captured {captured}")
    require(all(captured[n] > 0 for n in captured if n in LAUNCHES_PER_TRAIN_STEP
                and (seq_len > 32 or not n.startswith("attention_dense"))),
            f"{label}: every kernel of the step captured {captured}")
    # timing: calls megastep calls against calls * k single steps, same batches
    for _ in range(2):
        step(state, xs_d[0], ys_d[0], TRAIN_LR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        for i in range(k):
            step(state, xs_d[i], ys_d[i], TRAIN_LR)
    torch.cuda.synchronize()
    single_s = batch * k * calls / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(calls):
        multi(state2, xs_d, ys_d, TRAIN_LR)
    torch.cuda.synchronize()
    multi_s = batch * k * calls / (time.perf_counter() - t0)
    wall, busy = profile_call(f"{label}: {calls * k} single steps",
                              lambda: [step(state, xs_d[i], ys_d[i], TRAIN_LR)
                                       for _ in range(calls) for i in range(k)])
    wall_m, busy_m = profile_call(f"{label}: {calls} megastep calls of {k}",
                                  lambda: [multi(state2, xs_d, ys_d, TRAIN_LR)
                                           for _ in range(calls)])
    share = busy / wall if busy else float("nan")
    share_m = busy_m / wall_m if busy_m else float("nan")
    print(f"megastep {label}: {multi_s:.2f} sequences/s ({k} steps a call) vs single "
          f"steps {single_s:.2f}; device busy {100 * share_m:.1f} % vs "
          f"{100 * share:.1f} %; captured launches {captured}, 2 replays -> {replayed}; "
          f"losses within 1e-4 of the single steps', worst weight gap {worst[0]:.3g} at "
          f"{worst[1]} (envelope {envelope:.3g})", flush=True)
    del state, state2, step, multi
    torch.cuda.empty_cache()
    return single_s, multi_s, share, share_m, replayed


def phase_dhp3_megastep(data_dir: Path, single_epochs) -> None:
    """The 3DHP driver in bf16 with train.steps_per_call=4 (the megastep
    inside the train loop: four full batches a graph replay, the epoch's
    leftover as single steps), test protocol off: finite losses, graph
    replays made, and the meter's sequences/s by epoch beside the
    steps_per_call=1 run of phase 21."""
    from manipose_tpu_torch import ops
    from manipose_tpu_torch.drivers import dhp3
    from manipose_tpu_torch.utils.logging import MetricLogger

    cfg = dhp3_config("bfloat16", data_dir, ["train.steps_per_call=4", "run.test=false",
                                             "run.experiment=dhp3_megastep"])
    logger = MetricLogger()
    ops.reset_launch_counts()
    dhp3.main(cfg, logger=logger)
    torch.cuda.synchronize()
    replays = ops.graph_replays()
    require(replays > 0, "3dhp megastep driver: no graph replayed")
    losses = np.load(run_dir(cfg) / "train_loss.npy")
    require(losses.shape == (DRIVER_EPOCHS,) and bool(np.isfinite(losses).all()),
            f"3dhp megastep driver losses {losses}")
    epochs = epoch_rows(logger)
    print_epochs("3dhp megastep driver bf16", epochs)
    by_epoch = {name: ", ".join(f"{r['seq_per_sec']:.2f}" for r in rows)
                for name, rows in (("megastep", epochs), ("single", single_epochs))}
    print(f"3dhp megastep driver bf16 (steps_per_call=4): {replays} graph replays; train "
          f"sequences/s by epoch {by_epoch['megastep']} against steps_per_call=1 "
          f"{by_epoch['single']}; train losses {losses}", flush=True)


TOY_RUNS = (  # (label, overrides): configs/toy.yaml's groups, epochs cut
    ("hard-2 constrained_rmcl", ["data.scenario=hard-2", "model.arch=constrained_rmcl",
                                 "train=rmcl_constrained_hard2"]),
    ("torus-2Dto3D constrained_rmcl", ["data=3D_setup", "train=3D_setup",
                                       "model.arch=constrained_rmcl"]),
    ("hard-2 mlp", ["data.scenario=hard-2", "model.arch=mlp", "train=mlp_hard2"]),
    ("hard-2 diffusion", ["data.scenario=hard-2", "diffusion.enabled=true",
                          "train=diff_hard2"]),
)
TOY_EPOCHS = 3


def phase_toy(out_dir: Path) -> dict:
    """``toy.main`` (the paper's toy experiments) on the card and on the
    CPU for TOY_RUNS, TOY_EPOCHS epochs each from run.seed: the loss
    history and every metric finite on both, printed side by side with the
    wall time of each. Returns {label: card wall seconds}."""
    import contextlib
    import io

    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.toy import main as toy_main

    seconds = {}
    for label, overrides in TOY_RUNS:
        rows = {}
        for device in ("cuda", "cpu"):
            run = out_dir / f"{label.replace(' ', '_')}_{device}"
            cfg = load_config("toy", [*overrides, f"train.epochs={TOY_EPOCHS}",
                                      f"run.output_dir={run}", f"device={device}"])
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                toy_main.main(cfg)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            losses = np.load(run / "default" / "train_loss.npy")
            metrics = {k: float(v) for k, v in (
                line.split(": ") for line in
                (run / "default" / "metrics.txt").read_text().splitlines())}
            require(losses.shape == (TOY_EPOCHS,) and bool(np.isfinite(losses).all()),
                    f"toy {label} {device} losses {losses}")
            require(all(np.isfinite(v) for v in metrics.values()),
                    f"toy {label} {device} metrics {metrics}")
            rows[device] = (wall, losses, metrics)
        seconds[label] = rows["cuda"][0]
        print(f"toy {label} ({TOY_EPOCHS} epochs): " + "; ".join(
            f"{dev} {wall:.2f} s, losses {', '.join(f'{v:.5f}' for v in losses)}, "
            + ", ".join(f"{k} {v:.5f}" for k, v in metrics.items())
            for dev, (wall, losses, metrics) in rows.items()), flush=True)
    return seconds


# ---- parallel/ on one card (phases 40-43) ----------------------------------

# the ranks of phase 40's probes, each a process of this script
RANK_PROBE_TIMEOUT_S = 120
# phase 42: the flagship's microbatches (configs/config.yaml parallel.microbatches)
PIPE_MICROBATCHES = 4
SHARD_MODES = ("tp", "dp", "fsdp_dp", "fsdp")
# phase 42's loss terms against the plain step, relative (the pipeline's
# microbatches and the sharded reductions sum in other orders)
SHARDED_LOSS_TOL = 1e-4
# phase 43: the figure models' epochs on each device (the JAX default is 50)
FIGURE_EPOCHS = 5


def rank_probe(backend: str, rank: int, port: int, out: Path) -> int:
    """One of two ranks on the one card (cuda:0): which collectives of the
    port's ``parallel/`` run on CUDA tensors over ``backend``. Writes
    {op: "ok" | the error} to ``out``."""
    import torch.distributed as dist

    results = {}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank)
    except Exception as exc:  # noqa: BLE001 - the finding is the failure
        results["init"] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:300]}"
        out.write_text(json.dumps(results))
        return 0
    results["init"] = "ok"
    x = torch.full((4,), float(rank + 1), device="cuda")

    def all_reduce():
        t = x.clone()
        dist.all_reduce(t)
        return torch.equal(t.cpu(), torch.full((4,), 3.0))

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        return torch.equal(torch.cat(parts).cpu(), torch.tensor([1.0] * 4 + [2.0] * 4))

    def send_recv():  # the ring's and the pipeline's hop (parallel/comm.py)
        got = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                       dist.P2POp(dist.irecv, got, 1 - rank)])
        for req in reqs:
            req.wait()
        return torch.equal(got.cpu(), torch.full((4,), float(2 - rank)))

    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("send_recv", send_recv)):
        try:
            results[name] = "ok" if fn() else "wrong result"
        except Exception as exc:  # noqa: BLE001 - the finding is the failure
            results[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:300]}"
    torch.cuda.synchronize()
    out.write_text(json.dumps(results))
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_rank_probes(scratch: Path) -> dict:
    """Whether two ranks can share the one card: two processes of this
    script on cuda:0 over nccl and two over gloo with CUDA tensors (the
    pairs at once, on ports of their own), each trying the port's collectives (all-reduce, all-gather, the P2P hop).
    Nothing stages through host memory here; a backend that refuses, or
    hangs past RANK_PROBE_TIMEOUT_S, is the finding. Returns {backend:
    {op: outcome}} (rank 0's, or "timeout")."""
    scratch.mkdir(parents=True, exist_ok=True)
    runs, ports = {}, set()  # both backends' pairs start together
    for backend in ("nccl", "gloo"):
        port = free_port()
        while port in ports:
            port = free_port()
        ports.add(port)
        outs = [scratch / f"{backend}_{r}.json" for r in range(2)]
        runs[backend] = (outs, [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank-probe", backend, str(r),
             str(port), str(outs[r])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)])
    findings = {}
    for backend, (outs, procs) in runs.items():
        timed_out = False
        for p in procs:
            try:
                p.communicate(timeout=RANK_PROBE_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                timed_out = True
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        found = json.loads(outs[0].read_text()) if outs[0].exists() else {}
        if timed_out:
            found["timeout"] = f"a rank was still running after {RANK_PROBE_TIMEOUT_S} s"
        findings[backend] = found
        print(f"ranks on one card, {backend}, two processes on cuda:0: "
              + json.dumps(found), flush=True)
    return findings


def carries_ring(found: dict) -> bool:
    return all(found.get(op) == "ok" for op in ("init", "all_reduce", "all_gather",
                                                "send_recv"))


def dense_attention(q, k, v, scale):
    """The plain attention the ring is held against: fp32 from the inputs'
    values, the result in their dtype."""
    q32, k32, v32 = (t.float() for t in (q, k, v))
    p = torch.softmax(torch.einsum("bhnd,bhmd->bhnm", q32, k32) * scale, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", p, v32).to(q.dtype)


def phase_ring(mesh, cases=None) -> dict:
    """Ring attention (``parallel.ring_attention``) at the flagship's
    temporal shape (B*J = 16*17 windows x 8 heads x 243 frames x d 64), fp32
    and bf16, over the nccl group's ``model`` axis (a ring of 1 in the main
    run, of every rank under ``--ranks``): forward and dQ/dK/dV against the
    plain dense attention (TOL and GRAD_TOL of the attention kernels), then
    the ring's forward and forward+backward ms, beside K1's and K2's at
    that shape (phase 2's ``cases``) where given. Returns {dtype: ms}."""
    from manipose_tpu_torch.parallel import ring_attention
    from manipose_tpu_torch.parallel.mesh import axis_size

    ring_size = axis_size(mesh, "model")
    b, h, n, d = TRAIN_BATCH * 17, 8, 243, 64
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = {}
    for dtype in ("float32", "bfloat16"):
        dt = DTYPES[dtype]
        q, k, v, dout = (torch.randn(b, h, n, d, device="cuda", generator=gen).to(dt)
                         for _ in range(4))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ring_attention(*leaves, scale, mesh, "model", "data")
        out.backward(dout)
        ref_leaves = [t.float().clone().requires_grad_() for t in (q, k, v)]
        ref = dense_attention(*ref_leaves, scale)
        ref.backward(dout.float())
        err = (out.float() - ref).abs().max().item()
        tol = TOL[("attention", dt)]
        require(err <= tol, f"ring {dtype} forward: {err} > {tol}")
        grad_errs = {}
        for name, got, want in zip(("dq", "dk", "dv"), leaves, ref_leaves):
            g, w = got.grad.float(), want.grad
            limit = GRAD_TOL[dt] * max(1.0, w.abs().max().item())
            grad_errs[name] = (g - w).abs().max().item()
            require(grad_errs[name] <= limit,
                    f"ring {dtype} {name}: {grad_errs[name]} > {limit}")

        def forward():
            with torch.no_grad():
                ring_attention(q, k, v, scale, mesh, "model", "data")

        def train():
            ring_attention(*leaves, scale, mesh, "model", "data").backward(dout)

        fwd_ms, train_ms = time_ms(forward, reps=5), time_ms(train, reps=5)
        times[dtype] = {"forward_ms": fwd_ms, "forward_backward_ms": train_ms}
        beside = ""
        if cases is not None:
            head = {name: next(c for c in cases[name] if c["dtype"] == dtype
                               and c["trunk"] == "rotations")
                    for name in ("attention_dense", "attention_dense_bwd")}
            times[dtype].update(k1_ms=head["attention_dense"]["ms"],
                                k2_ms=head["attention_dense_bwd"]["ms"])
            beside = (f"; K1 {head['attention_dense']['ms']:.4f} ms, K2 "
                      f"{head['attention_dense_bwd']['ms']:.4f} ms at "
                      f"{head['attention_dense']['shape']}")
        print(f"ring attention {dtype} ({b}x{h}x{n}x{d}, ring of {ring_size} over nccl): "
              f"forward err {err:.3g} (tol {tol}), grad errs "
              + ", ".join(f"{k} {v:.3g}" for k, v in grad_errs.items())
              + f"; forward {fwd_ms:.3f} ms, forward+backward {train_ms:.3f} ms" + beside,
              flush=True)
        del leaves, ref_leaves, out, ref
    torch.cuda.empty_cache()
    return times


def sharded_trainer(cfg, weights, net_of, mesh=None):
    """A flagship trainer on the card whose model is ``net_of(model)``
    (sharded or pipelined), from ``weights`` (None: the seeded init);
    ``mesh``: the run's mesh, which ring attention needs."""
    from manipose_tpu_torch.drivers import instantiate_model
    from manipose_tpu_torch.geometry import h36m_skeleton_17
    from manipose_tpu_torch.parallel.mesh import GradSync, layout_of
    from manipose_tpu_torch.train import (
        LossConfig,
        TrainState,
        make_train_step,
        optimizer_from_config,
    )

    skeleton = h36m_skeleton_17()
    model, _ = instantiate_model(cfg, skeleton, mesh=mesh)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    net = net_of(model.cuda())
    opt = optimizer_from_config(net, cfg)
    if layout_of(net) is not None:
        opt.sharding = GradSync(net, opt.params)
    state = TrainState.create(net, opt, seed=cfg.run.seed, device="cuda")
    t = cfg.train
    loss_cfg = LossConfig(sq_loss=t.sq_loss, w_loss=t.w_loss, vel_loss=t.vel_loss,
                          smooth_reg=t.smooth_reg, rmcl_score_reg=t.rmcl_score_reg,
                          rigid_seg_reg=t.rigid_seg_reg, rmcl=True)
    return state, make_train_step(net, loss_cfg, skeleton, opt)


def sharded_legs(world: int, pipe_mesh=None, mesh=None) -> list:
    """[(label, mesh, net_of, config overrides)]: at world 1 the pipelined
    flagship (M = PIPE_MICROBATCHES) on ``pipe_mesh`` and each
    ``shard_params`` mode on ``mesh``; at world N (``--ranks``) dp and
    fsdp_dp on (N, 1), then tp, fsdp, ring (``model.attn_impl=ring``, mode
    dp) and the pipeline (mode dp) on (N/2, 2) and (1, N) meshes, built
    here."""
    from manipose_tpu_torch.parallel import make_mesh, shard_params
    from manipose_tpu_torch.parallel.flagship import make_pipelined_apply, pick_microbatches

    def pipelined(pmesh, n_data):
        m = pick_microbatches(TRAIN_BATCH, n_data, PIPE_MICROBATCHES)
        return lambda model: shard_params(make_pipelined_apply(
            model, pmesh, data_axis="data", microbatches=m), pmesh, "dp")

    def sharded(smesh, mode):
        return lambda model: shard_params(model, smesh, mode)

    if world == 1:
        return ([("pipeline", pipe_mesh, pipelined(pipe_mesh, 1), [])]
                + [(mode, mesh, sharded(mesh, mode), []) for mode in SHARD_MODES])
    wide = make_mesh(world, 1)
    legs = [("dp", wide, sharded(wide, "dp"), []),
            ("fsdp_dp", wide, sharded(wide, "fsdp_dp"), [])]
    for width in sorted({2, world}):
        n_data = world // width
        smesh, pmesh = make_mesh(n_data, width), make_mesh(n_data, pipe=width)
        legs += [(f"tp{width}", smesh, sharded(smesh, "tp"), []),
                 (f"fsdp{width}", smesh, sharded(smesh, "fsdp"), []),
                 (f"ring{width}", smesh, sharded(smesh, "dp"),
                  ["model.attn_impl=ring", f"parallel.data={n_data}",
                   f"parallel.model={width}"]),
                 (f"pipeline{width}", pmesh, pipelined(pmesh, n_data), [])]
    return legs


def run_sharded_legs(legs, dtype: str, plain_seq_s, strict: bool = True,
                     per_step=None) -> dict:
    """One train step of the flagship (B = TRAIN_BATCH, drop-path off) under
    each leg of ``sharded_legs``, from the plain step's weights, each rank on
    its rows: the loss terms (averaged over ``data``) against the plain
    step's within SHARDED_LOSS_TOL relative and every gradient, gathered
    into the single-device layout, within GRAD_TOL of max(1, |g|max); with
    ``strict`` False (bf16 on a split batch: another split is another
    rounding) only finite. The launches of that step: ``per_step[label]``
    on ``dtype`` operands, or without ``per_step`` every kernel launched
    (K1/K2 not under ring, whose temporal attention is the ring). Then sequences/s of 5 steps (the whole
    batch) and rank 0's peak memory. Returns {label: launch counts}."""
    import torch.distributed as dist

    from manipose_tpu_torch import ops
    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.parallel import shard_batch
    from manipose_tpu_torch.parallel.mesh import axis_size, full_grads, mesh_shape

    base = [f"model.dtype={dtype}", "model.drop_path_rate=0.0"]
    x, y = (t.cuda() for t in flagship_batch(243, TRAIN_BATCH))
    state, step = sharded_trainer(load_config("config", base), None, lambda m: m)
    weights = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    plain = {k: float(v) for k, v in step(state, x, y, TRAIN_LR).items()}
    plain_grads = {n: p.grad.detach().float().clone()
                   for n, p in state.model.named_parameters()}
    if plain_seq_s is None:
        plain_seq_s = timed_steps(step, state, x, y, 5)
    del state, step
    counts = {}
    for label, mesh, net_of, extra in legs:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        cfg = load_config("config", base + extra)
        state, step = sharded_trainer(cfg, weights, net_of, mesh)
        xs, ys = shard_batch((x, y), mesh)
        n_data = axis_size(mesh, "data")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        terms = step(state, xs, ys, TRAIN_LR)
        torch.cuda.synchronize()
        names = sorted(terms)
        mean = torch.stack([terms[k].detach().float() for k in names])
        if n_data > 1:
            dist.all_reduce(mean, group=mesh.get_group("data"))
        got = dict(zip(names, (mean / n_data).tolist()))
        if per_step is not None:
            counts[label] = require_counts(dtype, per_step[label],
                                           f"{label} {dtype} train step")
        else:
            counts[label] = ops.launch_counts()
            ring = "attn_impl=ring" in " ".join(extra)
            for name in LAUNCHES_PER_TRAIN_STEP:
                if not (ring and name.startswith("attention_dense")):
                    require(counts[label][name] > 0, f"{label} {dtype}: {name} launched")
        grads = full_grads(state.model)
        require(set(grads) == set(plain_grads), f"{label}: gradients of other parameters")
        worst = max(((grads[n].float() - g).abs().max().item()
                     / max(1.0, g.abs().max().item()), n) for n, g in plain_grads.items())
        loss_err = max(abs(got[k] - want) / max(1.0, abs(want)) for k, want in plain.items())
        finite = (all(np.isfinite(v) for v in got.values())
                  and all(bool(torch.isfinite(g).all()) for g in grads.values()))
        require(finite, f"{label} {dtype}: loss or gradients not finite")
        tol = GRAD_TOL[DTYPES[dtype]]
        if strict:
            require(loss_err <= SHARDED_LOSS_TOL,
                    f"{label} {dtype} loss: {got} vs {plain}")
            require(worst[0] <= tol, f"{label} {dtype} gradient {worst[1]}: {worst[0]} > {tol}")
        peak = (torch.cuda.max_memory_allocated() - before) / 1e9
        seq_s = timed_steps(step, state, xs, ys, 5) * n_data
        print(f"{label} {dtype} train step (B={TRAIN_BATCH}, mesh {mesh_shape(mesh)} over "
              f"nccl): loss {got['loss']:.6f} vs plain {plain['loss']:.6f} (largest relative "
              f"term error {loss_err:.3g}{'' if strict else ', held to finiteness only'}); "
              f"worst gradient err / max(1, |g|max) {worst[0]:.3g} at {worst[1]} "
              f"({'tol ' + str(tol) if strict else 'not held'}); {seq_s:.2f} sequences/s vs "
              f"plain {plain_seq_s:.2f} on one rank; peak {peak:.2f} GB on rank 0", flush=True)
        del state, step, grads
    torch.cuda.empty_cache()
    return counts


def phase_sharded_steps(mesh, pipe_mesh, plain_seq_s: float) -> dict:
    """The pipelined flagship (``make_pipelined_apply``, M =
    PIPE_MICROBATCHES) and the flagship under each ``shard_params`` mode, on
    the world-1 nccl group: one bf16 train step each against the plain step
    (``run_sharded_legs``, strict), K1-K6 launched inside on bf16 operands
    (the pipeline's trunk once a microbatch), sequences/s beside phase 9's
    plain step. Returns {path: launch counts}."""
    m = PIPE_MICROBATCHES
    per_step = {mode: LAUNCHES_PER_TRAIN_STEP for mode in SHARD_MODES}
    per_step["pipeline"] = {
        "attention_dense": 8 * m + 2, "attention_packed": 8 * m + 2, "fused_mlp": 16 * m + 4,
        "attention_dense_bwd": 8 * m + 2, "attention_packed_bwd": 8 * m + 2,
        "fused_mlp_bwd": 16 * m + 4}
    return run_sharded_legs(sharded_legs(1, pipe_mesh, mesh), "bfloat16", plain_seq_s,
                            per_step=per_step)


def phase_figures(out_dir: Path) -> None:
    """``toy.paper_figures.train_figure_models`` (hard-2, FIGURE_EPOCHS
    epochs) on the card and on the CPU from the same seed, by phase 39's
    rules: finite losses and predictions on both, printed side by side with
    their gap and wall times. Then Figures 4 and 8 where matplotlib
    imports; where it does not, the figures are reported as not drawn (the
    training above still ran)."""
    from manipose_tpu_torch.toy import paper_figures
    from manipose_tpu_torch.toy.distributions import HardBimodalDist

    runs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        _, _, preds, hyps, trainers = paper_figures.train_figure_models(
            HardBimodalDist(radius=1.0, random_state=0), seed=0, epochs=FIGURE_EPOCHS,
            device=device)
        runs[device] = (time.perf_counter() - t0, preds, hyps, trainers)
        for name, p in preds.items():
            losses = trainers[name].loss_list
            require(bool(np.isfinite(p).all()) and bool(np.isfinite(losses).all()),
                    f"figure model {name} on {device}: not finite")
    gaps = {name: float(np.abs(runs["cuda"][1][name] - p).max())
            for name, p in runs["cpu"][1].items()}
    print(f"figure models (hard-2, {FIGURE_EPOCHS} epochs): card {runs['cuda'][0]:.2f} s, "
          f"cpu {runs['cpu'][0]:.2f} s; final losses card "
          + ", ".join(f"{n} {t.loss_list[-1]:.5f}" for n, t in runs["cuda"][3].items())
          + "; cpu " + ", ".join(f"{n} {t.loss_list[-1]:.5f}" for n, t in runs["cpu"][3].items())
          + "; prediction gap card-cpu " + ", ".join(f"{n} {g:.3g}" for n, g in gaps.items()),
          flush=True)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("figures: matplotlib is not installed here; Figures 4 and 8 not drawn "
              "(the figure models trained on the card above)", flush=True)
        return
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    paths = [paper_figures.figure4(out_dir / "figure4.png", epochs=FIGURE_EPOCHS,
                                   device="cuda"),
             paper_figures.figure8(out_dir / "figure8.png")]
    for path in paths:
        require(Path(path).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is no PNG")
    print(f"figures: {', '.join(Path(p).name for p in paths)} drawn in "
          f"{time.perf_counter() - t0:.2f} s (figure 4's six models trained on the card)",
          flush=True)


def phases_parallel(cases, plain_seq_s: float) -> dict:
    """Phases 40-43. Returns {path: launch counts} of phase 42."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from manipose_tpu_torch.parallel import make_mesh

    scratch = ROOT / "build" / "chip_smoke_parallel"
    shutil.rmtree(scratch, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        findings = phase_rank_probes(scratch / "probes")
        gloo_ring = carries_ring(findings.get("gloo", {}))
        print(f"rank probes phase: {time.perf_counter() - t0:.1f} s; two ranks on the one "
              f"card: nccl {'runs' if carries_ring(findings['nccl']) else 'refused'}, gloo "
              f"with CUDA tensors {'carries' if gloo_ring else 'does not carry'} the "
              "collectives and the hop of parallel/", flush=True)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh(1, 1)
            pipe_mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "pipe"))
            t0 = time.perf_counter()
            ring = phase_ring(mesh, cases)
            print(f"ring phase: {time.perf_counter() - t0:.1f} s", flush=True)
            t0 = time.perf_counter()
            counts = phase_sharded_steps(mesh, pipe_mesh, plain_seq_s)
            print(f"sharded steps phase: {time.perf_counter() - t0:.1f} s", flush=True)
        finally:
            dist.destroy_process_group()
        t0 = time.perf_counter()
        phase_figures(scratch / "figures")
        print(f"figures phase: {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    print("parallel " + json.dumps({"rank_probes": findings, "ring_ms": ring}), flush=True)
    return counts


# ---- parallel/ across cards (``--ranks N``) ---------------------------------


def phase_rank_drivers(world: int, scratch: Path) -> dict:
    """The H36M training driver (``drivers.h36m.main``, bf16, the phases'
    npz files) on the whole world of ranks under each layout: data
    parallel over all of them; tp, fsdp, the GPipe trunk and ring
    attention on (N/2, 2). Each trains DRIVER_EPOCHS epochs and runs the
    test protocol, with every kernel launched (K1/K2 not under ring); its
    best validation MPJPE is finite; rank 0 alone wrote the run, whose
    tags hold the single-device model's keys and shapes and serve through
    ``Predictor.from_any``; then the run is relaunched with
    run.auto_resume=true and one more epoch, which resumes from the saved
    train state and trains that one epoch. Returns {layout: launch
    counts}."""
    import torch.distributed as dist

    from manipose_tpu_torch import ops
    from manipose_tpu_torch.drivers import h36m, instantiate_model
    from manipose_tpu_torch.geometry import h36m_skeleton_17
    from manipose_tpu_torch.parallel import is_primary
    from manipose_tpu_torch.serving import Predictor
    from manipose_tpu_torch.utils.logging import MetricLogger
    from manipose_tpu_torch.weights import load_torch_checkpoint

    half = [f"parallel.data={world // 2}"]
    layouts = {"dp": [f"parallel.data={world}"],
               "tp": half + ["parallel.model=2"],
               "fsdp": half + ["parallel.model=2", "parallel.mode=fsdp"],
               "pipeline": half + ["parallel.pipe=2"],
               "ring": half + ["model.attn_impl=ring", "parallel.model=2"]}
    if is_primary():
        scratch.mkdir(parents=True, exist_ok=True)
        write_h36m(scratch, train_config("bfloat16", scratch).run.seed)
    dist.barrier()
    plain_cfg = train_config("bfloat16", scratch)
    want = {k: tuple(v.shape) for k, v in
            instantiate_model(plain_cfg, h36m_skeleton_17())[0].state_dict().items()}
    counts = {}
    for label, extra in layouts.items():
        common = [f"run.experiment=ranks_{label}", f"train.batch_size_test={TRAIN_BATCH}",
                  *extra]
        cfg = train_config("bfloat16", scratch, common)
        logger = MetricLogger()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        best = h36m.main(cfg, logger=logger)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        counts[label] = ops.launch_counts()
        for name in REPLACES:
            if not (label == "ring" and name.startswith("attention_dense")):
                require(counts[label][name] > 0, f"driver {label}: {name} launched")
        require(best is not None and bool(np.isfinite(best)), f"driver {label}: best {best}")
        epochs = epoch_rows(logger)
        print_epochs(f"driver {label} ({world} ranks)", epochs)
        dist.barrier()
        out = run_dir(cfg)
        if is_primary():
            for tag in RUN_TAGS:
                got = {k: tuple(v.shape)
                       for k, v in load_torch_checkpoint(out / tag / "model.pth").items()}
                require(got == want, f"driver {label}: tag {tag} is not the single-device "
                                     "layout")
            require(not list(out.parent.glob("manipose-rank-*")), "a rank's files left")
            pred = Predictor.from_any(str(out), tag="best_mpjpe", cfg=plain_cfg,
                                      batch_size=1, tta=True)
            pose_2d, _ = eval_windows(plain_cfg)
            poses = pred.predict_video(pose_2d[:plain_cfg.data.seq_len])
            require(bool(np.isfinite(poses).all()), f"driver {label}: served poses")
            del pred
        resumed = MetricLogger()
        h36m.main(train_config("bfloat16", scratch, common + [
            f"train.epochs={DRIVER_EPOCHS + 1}", "run.auto_resume=true", "run.test=false"]),
            logger=resumed)
        steps = [r["step"] for r in epoch_rows(resumed)]
        require(steps == [DRIVER_EPOCHS], f"driver {label}: resumed epochs {steps}")
        print(f"driver {label} ({world} ranks, mesh of {' '.join(extra)}): main {main_s:.1f} "
              f"s, best validation MPJPE {best:.4f} mm, tags in the single-device layout, "
              f"served; resumed at epoch {steps[0]}; launches {counts[label]}", flush=True)
        dist.barrier()
        torch.cuda.empty_cache()
    return counts


# ---- viz, the run-the-model tools, MLflow (phases 44-46) --------------------

# phase 44's lift on the card against the CPU: the first VIZ_CPU_WINDOWS
# windows of the video (the CPU runs the flagship with TTA)
VIZ_CPU_WINDOWS = 1
# phase 45: the sweep's grid (2 miss types x 2 rates, and the clean row),
# step_ablation's timed steps, hp_search's trials at phase 39's cut
SWEEP_MISS_TYPES, SWEEP_RATES = ("random", "structured_joint"), ("0.1", "0.2")
ABLATION_STEPS = 10
HP_TRIALS = 3


def matplotlib_imports() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


class RecordedRender:
    """Stands in for ``viz.render`` where matplotlib does not import: each
    drawing call keeps its arguments and draws nothing (reported as not
    drawn)."""

    def __init__(self):
        self.calls = []

    def _record(self, kind, *args, **kw):
        self.calls.append((kind, args, kw))
        return kw.get("output", "")

    def render_animation(self, *args, **kw):
        return self._record("animation", *args, **kw)

    def render_frame_prediction(self, *args, **kw):
        return self._record("frame", *args, **kw)


def viz_config(data_dir: Path, extra=()):
    """The flagship (``configs/config.yaml``) eval-free viz run on the
    phases' npz files: S11, walking, camera 0, the animation cut to a few
    frames where it is drawn."""
    from manipose_tpu_torch.config import load_config

    return load_config("config", [
        f"data.data_dir={data_dir}", f"run.output_dir={data_dir / 'viz'}", "run.train=false",
        "run.test=false", "run.viz=true", "viz.viz_subject=S11", "viz.viz_action=walking",
        "viz.viz_camera=0", "viz.viz_limit=8", "viz.viz_size=2", "viz.extension=gif",
        *extra])


def phase_viz(data_dir: Path) -> dict:
    """Phase 44. Returns the launch counts of the driver's run.viz=true.
    Where matplotlib does not import, ``viz.driver.render_module`` must
    raise the ImportError that names it; the phase then puts a
    :class:`RecordedRender` in its place for its runs, and puts the real
    one back after them."""
    from manipose_tpu_torch.viz import driver as viz_driver

    drawn = matplotlib_imports()
    recorded, render_module = None, viz_driver.render_module
    if not drawn:
        try:
            render_module()
            require(False, "render_module imported without matplotlib")
        except ImportError as e:
            require("matplotlib" in str(e), f"the ImportError names matplotlib: {e}")
        recorded = RecordedRender()
        viz_driver.render_module = lambda: recorded
    try:
        return viz_phases(data_dir, drawn, recorded)
    finally:
        viz_driver.render_module = render_module


def viz_phases(data_dir: Path, drawn: bool, recorded) -> dict:
    from manipose_tpu_torch import ops
    from manipose_tpu_torch.data import PoseSequenceDataset, SequenceLoader
    from manipose_tpu_torch.drivers import h36m
    from manipose_tpu_torch.tools import viz as viz_cli
    from manipose_tpu_torch.viz import driver as viz_driver
    from manipose_tpu_torch.viz.prepare import prep_data_for_viz

    cfg = viz_config(data_dir)
    l, n_hyp = cfg.data.seq_len, cfg.multi_hyp.n_hyp
    n_frames = EVAL_FRAMES
    n_batches = -(-(n_frames // l) // cfg.train.batch_size_test)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    require(h36m.main(cfg) is None, "run.viz=true without training returns None")
    wall = time.perf_counter() - t0
    counts = require_counts("float32", {k: 2 * n * n_batches for k, n in
                                        LAUNCHES_PER_FORWARD.items()},
                            f"viz driver (run.viz=true, {n_batches} batches, TTA)")
    name = f"rmcl_manifold_hyps_S11_walking_0.{cfg.viz.extension}"
    figure = Path(cfg.run.output_dir) / "figures" / name
    if drawn:
        require(figure.read_bytes()[:4] == b"GIF8", f"{figure} is no GIF")
        what = f"drawn: {figure.name}"
    else:
        (kind, _, kw), = recorded.calls
        poses = kw["poses"]
        require(kind == "animation" and kw["output"] == str(figure), f"{kind} {kw['output']}")
        require(poses["prediction"].shape == (n_frames, n_hyp, 17, 4)
                and poses["Ground truth"].shape == (n_frames, 17, 3),
                f"panels {[p.shape for p in poses.values()]}")
        require(all(bool(np.isfinite(p).all()) for p in poses.values()), "panels not finite")
        what = (f"not drawn (matplotlib does not import here; render_module raised the "
                f"ImportError that names it): panels {[p.shape for p in poses.values()]} "
                f"for {figure.name}")
    print(f"viz driver (run.viz=true, flagship fp32, TTA): lifted {n_frames} frames on the "
          f"card in {wall:.2f} s (main); figure {what}", flush=True)

    # lift_for_viz on the card against the CPU, both layouts
    keypoints, dataset = h36m.fetch_and_prepare_data(cfg)
    loader = prep_data_for_viz(cfg, dataset, keypoints)[0]
    first = next(iter(loader))
    w = VIZ_CPU_WINDOWS
    cut = SequenceLoader(PoseSequenceDataset(
        [first.pose_3d[:w].reshape(-1, 17, 3)], [first.pose_2d[:w].reshape(-1, 17, 2)],
        seq_len=l, drop_last=False), batch_size=w)
    models = {d: eval_model(cfg, d) for d in ("cuda", "cpu")}
    for multihyp in (False, True):
        lifted = {d: viz_driver.lift_for_viz(m, cut, dataset.skeleton, cfg, True, multihyp)
                  for d, m in models.items()}
        want_shape = (w * l, n_hyp, 17, 4) if multihyp else (w * l, 17, 3)
        require(lifted["cuda"].shape == lifted["cpu"].shape == want_shape,
                f"lift shapes {lifted['cuda'].shape} {lifted['cpu'].shape}")
        err = rel_err(lifted["cuda"], lifted["cpu"])
        require(err <= MODEL_TOL, f"lift_for_viz card vs CPU ({multihyp=}): {err}")
        print(f"lift_for_viz {'(N*L, H, J, 4)' if multihyp else '(N*L, J, 3)'} "
              f"{want_shape}: card vs CPU {err:.3g} of the magnitude (tol {MODEL_TOL})",
              flush=True)
    del models

    # the viz CLI: two archs from the seeded init, lifted on the card
    cli_cfg = viz_config(data_dir, ["model.arch=rmcl_manifold,mixste",
                                    "run.checkpoint_model=','"])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = viz_cli.main(cli_cfg)
    wall = time.perf_counter() - t0
    cli_counts = ops.launch_counts()
    on_fp32 = ops.launch_counts(torch.float32)
    require(all(cli_counts[k] > 0 and on_fp32[k] == cli_counts[k]
                for k in LAUNCHES_PER_FORWARD), f"viz CLI launches {cli_counts}")
    require(all(cli_counts[k] == 0 for k in LAUNCHES_PER_TRAIN_STEP
                if k not in LAUNCHES_PER_FORWARD), f"viz CLI launches {cli_counts}")
    if drawn:
        require(Path(out).read_bytes()[:4] == b"GIF8", f"{out} is no GIF")
        what = f"drawn: {Path(out).name}"
    else:
        (_, _, kw), = recorded.calls[1:]
        poses = kw["poses"]
        require(list(poses) == ["MHMC", "MixSTE", "Ground truth"], f"panels {list(poses)}")
        require(poses["MHMC"].shape == (n_frames, n_hyp, 17, 4)
                and poses["MixSTE"].shape == (n_frames, 17, 3), "panel shapes")
        require(all(bool(np.isfinite(p).all()) for p in poses.values()), "panels not finite")
        what = f"not drawn (no matplotlib): panels {list(poses)} for {Path(out).name}"
    print(f"viz CLI (rmcl_manifold,mixste, seeded init) on the card in {wall:.2f} s: "
          f"launches {cli_counts}; {what}", flush=True)
    return counts


def phase_tools(data_dir: Path, serve_fps: float, int8_fps: float,
                blocked_seq_s: float) -> dict:
    """Phase 45. Returns the launch counts of step_ablation's ``full``."""
    import contextlib
    import io

    from manipose_tpu_torch import ops
    from manipose_tpu_torch.geometry import h36m_skeleton_17
    from manipose_tpu_torch.models import ManifoldConfig
    from manipose_tpu_torch.serving import INT8_MIN_SPEEDUP, Predictor
    from manipose_tpu_torch.tools import (
        bench_eval,
        bench_sustained,
        count_n_params,
        hp_search,
        robustness_sweep,
        step_ablation,
        synthetic_overfit,
    )

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"  {label}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    counts = timed("count_n_params", count_n_params.main, [])
    require(all(n > 0 for n in counts.values()) and len(counts) == 3, f"counts {counts}")

    fp32 = timed("bench_eval", bench_eval.main, [])
    int8 = timed("bench_eval --int8", bench_eval.main, ["--int8"])
    ratio = Predictor._int8_probe_cache["cuda"]
    path = ("int8" if ratio >= INT8_MIN_SPEEDUP else
            f"float (int8_speedup() {ratio:.4f} < {INT8_MIN_SPEEDUP})")
    require(all(np.isfinite(r["value"]) and r["value"] > 0 for r in (fp32, int8)),
            f"bench_eval {fp32} {int8}")
    print(f"bench_eval: {fp32['value']} frames/s (phase 3's predict_video "
          f"{serve_fps:.1f}); --int8 {int8['value']} frames/s, served on the {path} path "
          f"(phase 29's forced int8 {int8_fps:.1f})", flush=True)

    sustained = timed("bench_sustained", bench_sustained.main, ["--epochs", "1"])
    require(sustained["n_sequences"] > 0 and np.isfinite(sustained["value"]),
            f"bench_sustained {sustained}")
    print(f"bench_sustained (bf16, 1 epoch of 40 videos, prefetch): {sustained['value']} "
          f"sequences/s over {sustained['n_sequences']} (phase 9's blocked step "
          f"{blocked_seq_s:.2f})", flush=True)

    report = timed("synthetic_overfit --small", synthetic_overfit.main, ["--small"])
    require(report["mpjpe_mm"] < report["zero_baseline_mm"],
            f"synthetic_overfit {report}")
    print(f"synthetic_overfit --small: eval MPJPE {report['mpjpe_mm']:.2f} mm against the "
          f"predict-zero baseline {report['zero_baseline_mm']:.2f} (untrained "
          f"{report['untrained_mpjpe_mm']:.2f}), oracle {report['oracle_mm']:.2f}", flush=True)

    rows = timed("robustness_sweep", robustness_sweep.main, [
        "--miss-types", *SWEEP_MISS_TYPES, "--miss-rates", *SWEEP_RATES,
        "--out", str(data_dir / "sweep.csv"), f"data.data_dir={data_dir}",
        "data.actions=walking"])
    require(len(rows) == 1 + len(SWEEP_MISS_TYPES) * len(SWEEP_RATES)
            and all(np.isfinite(v) for r in rows for k, v in r.items() if k.endswith("_mm")),
            f"sweep rows {rows}")
    print("robustness_sweep (flagship fp32, seeded init, S11 walking): " + "; ".join(
        f"{r['miss_type']} {r['miss_rate']}: {r['mpjpe_mm']} mm (oracle "
        f"{r['oracle_mpjpe_mm']})" for r in rows), flush=True)

    skel = h36m_skeleton_17()
    abl_cfg = ManifoldConfig(num_frame=243, n_hyp=5, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(TRAIN_BATCH, 243, 17, 2)).astype(np.float32)).cuda()
    y = torch.from_numpy(
        0.1 * rng.normal(size=(TRAIN_BATCH, 243, 17, 3)).astype(np.float32)).cuda()
    ops.reset_launch_counts()
    step_ablation.time_ablation("full", abl_cfg, skel, x, y, 1, torch.device("cuda"))
    steps = step_ablation.WARMUP_STEPS + 1
    full_counts = require_counts("bfloat16", {k: steps * n for k, n in
                                              LAUNCHES_PER_TRAIN_STEP.items()},
                                 f"step_ablation full ({steps} steps)")
    del x, y
    ablations = timed("step_ablation", step_ablation.main,
                      ["--steps", str(ABLATION_STEPS)])
    require(all(np.isfinite(r["ms_per_step"]) for r in ablations.values()),
            f"ablations {ablations}")

    journal = data_dir / "hp_search.jsonl"
    argv = ["--driver", "toy", "--trials", str(HP_TRIALS), "--journal", str(journal),
            "--space", "train.lr=loguniform:1e-4,1e-2", "--", *TOY_RUNS[0][1],
            f"train.epochs={TOY_EPOCHS}", f"run.output_dir={data_dir / 'hp_search'}"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # each trial prints its config
        best_params, best, history = hp_search.main(argv)
        again = hp_search.main(argv)
    print(f"  hp_search (twice): {time.perf_counter() - t0:.1f} s", flush=True)
    require(len(history) == HP_TRIALS and best is not None and np.isfinite(best),
            f"hp_search {best} {history}")
    require(again[2] == history and len(journal.read_text().splitlines()) == HP_TRIALS,
            "hp_search resumed from its journal without a new trial")
    print(f"hp_search --driver toy ({TOY_RUNS[0][0]}, {TOY_EPOCHS} epochs, {HP_TRIALS} "
          f"trials): best objective {best:.5f} at {best_params}; a second call resumed "
          f"{len(again[2])} trials and ran none", flush=True)
    return full_counts


def phase_mlflow(data_dir: Path) -> None:
    """Phase 46: the training driver with run.mlflow_on=true, one short
    epoch (LOOP_OVERRIDES on LOOP_FRAMES-frame videos, MPJPE evaluated,
    protocol off) on the card: no exception without mlflow, and the history
    written as the run's metrics.csv."""
    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.drivers import h36m

    try:
        import mlflow  # noqa: F401

        has_mlflow = True
    except ImportError:
        has_mlflow = False
    data_dir = data_dir / "mlflow"
    data_dir.mkdir()
    write_h36m(data_dir, 0, frames=LOOP_FRAMES, train_frames=LOOP_FRAMES,
               s9_frames=LOOP_FRAMES)
    cfg = load_config("config", [
        f"data.data_dir={data_dir}", f"run.output_dir={data_dir / 'outputs'}",
        "run.experiment=mlflow_on", "run.mlflow_on=true", "data.data=one",
        f"data.actions={','.join(EVAL_ACTIONS.values())}", f"train.batch_size={TRAIN_BATCH}",
        *LOOP_OVERRIDES, "train.mpjpe_epoch_interval=1"])
    best = h36m.main(cfg)
    history = (run_dir(cfg) / "metrics.csv").read_text().splitlines()
    require(best is not None and np.isfinite(best) and len(history) >= 2
            and "tr_loss" in history[0], f"mlflow_on run: {best}, {history[:2]}")
    print(f"run.mlflow_on=true (mlflow {'installed' if has_mlflow else 'not installed'}): "
          f"one epoch trained, best validation MPJPE {best:.4f} mm, metrics.csv "
          f"{len(history) - 1} rows", flush=True)


# ---- the offline-analysis and muP tools, model=fast (phases 47-50) ---------

# phase 47: eval_baselines on the card against the CPU, each printed number
# relative (fp32 sums in another order on each side; a PCK moves by one
# joint-frame in 16524, 6e-5 of it)
ANALYSIS_TOL = 1e-4
ANALYSIS_DUMP = (4, 243, 17, 3)
ALIGNMENTS = ("none", "scale", "procrustes")
# phase 48: the toy tables' seeds (the scripts run 42-46)
TABLE_SEEDS = (42, 43)
# phase 49: the widths of the coordinate check and the transfer sweep, the
# check's steps, the sweep's steps and its limit (tests/test_mup.py)
MUP_WIDTHS = (32, 64, 128)
MUP_STEPS = 5
MUP_TRANSFER_STEPS = 40
MUP_GAP_LIMIT = 0.15
# phase 50: model=fast's windows on the card against the CPU; the epochs of
# seg_heads_ab's one seed
FAST_CPU_WINDOWS = 2
SEG_AB_EPOCHS = 3


def printed_numbers(text: str) -> dict:
    """{label: numbers} of a tool's ``label: value`` lines (a numpy array
    may wrap lines)."""
    entries, key = {}, None
    for line in text.splitlines():
        m = re.match(r"^([A-Za-z3][^:\[]*?):\s*(.*)$", line)
        if m:
            key = m.group(1)
            entries[key] = m.group(2)
        elif key is not None:
            entries[key] += " " + line
    num = r"[-+]?\d+(?:\.\d*)?(?:[eE][-+]?\d+)?|nan|inf"
    return {k: [float(v) for v in re.findall(num, rest)] for k, rest in entries.items()}


def printed_by(fn, argv) -> str:
    """What ``fn(argv)`` prints."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def require_no_launches(what: str) -> dict:
    from manipose_tpu_torch import ops

    counts = ops.launch_counts()
    require(not any(counts.values()), f"{what} launched kernels: {counts}")
    return counts


def phase_analysis(data_dir: Path, run: Path) -> dict:
    """Phase 47. ``run``: the fp32 eval run directory of phases 12-15.
    Returns the launch counts (none)."""
    from manipose_tpu_torch import ops
    from manipose_tpu_torch.tools import eval_baselines, plot_analysis

    rng = np.random.default_rng(47)
    targets = rng.normal(scale=100, size=ANALYSIS_DUMP).astype(np.float32)
    preds = targets + rng.normal(scale=40, size=ANALYSIS_DUMP).astype(np.float32)
    np.save(data_dir / "preds.npy", preds)
    np.save(data_dir / "targets.npy", targets)
    paths = [str(data_dir / "preds.npy"), str(data_dir / "targets.npy")]
    ops.reset_launch_counts()
    cases = [("h36m", [])] + [(f"3dhp --pck --alignment={a}",
                               ["--skeleton=3dhp", "--pck", f"--alignment={a}"])
                              for a in ALIGNMENTS]
    for label, flags in cases:
        out = {dev: printed_numbers(printed_by(eval_baselines.main,
                                               paths + flags + ["--device", dev]))
               for dev in ("cuda", "cpu")}
        card, cpu = out["cuda"], out["cpu"]
        require(list(card) == list(cpu) and len(cpu) == (10 if "--pck" in flags else 8),
                f"eval_baselines {label}: lines {list(card)} against {list(cpu)}")
        worst = 0.0
        for key, ref in cpu.items():
            got, ref = np.asarray(card[key]), np.asarray(ref)
            require(got.shape == ref.shape and bool(np.isfinite(got).all()),
                    f"eval_baselines {label} {key}: {got} against {ref}")
            err = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-12)))
            require(err <= ANALYSIS_TOL, f"eval_baselines {label} {key}: card {got} against "
                                         f"the CPU's {ref} ({err} > {ANALYSIS_TOL})")
            worst = max(worst, err)
        print(f"eval_baselines {label} on {ANALYSIS_DUMP} dumps: {len(cpu)} lines, card "
              f"against the CPU within {worst:.3g} relative; " + ", ".join(
                  f"{k} {v[0]:.4f}" for k, v in card.items() if len(v) == 1), flush=True)

    label = "flagship fp32 eval"
    sweep = plot_analysis.sweep_rows([run], [5])  # the flagship's K
    spread = plot_analysis.multimodality_data(run)
    points = plot_analysis.consistency_points([run], [label])
    bone_names, stretch = plot_analysis.max_stretch_bars(run)
    bars = plot_analysis.comparison_rows([run], [label])
    errs, _ = plot_analysis.seg_err_data(run)
    matrix = spread["matrix"]
    require(len(sweep) == 1 and "oracle" in sweep[0] and len(points) == 1,
            f"sweep rows {sweep}, points {points}")
    require(matrix.shape == (len(EVAL_ACTIONS), 17) and spread["actions"] is not None,
            f"spread matrix {matrix.shape}, actions {spread['actions']}")
    require(len(stretch) == 16 and len(bars) == 4 and errs.shape[1] == 16,
            f"stretch {stretch.shape}, bars {list(bars)}, segment errors {errs.shape}")
    values = [*(v for r in sweep for v in r.values()), *matrix.ravel(),
              *spread["frame_spread"], *(v for p in points for v in p[1:]), *stretch,
              *(v for _, rows in bars.values() for _, r in rows for v in r), *errs.ravel()]
    require(bool(np.isfinite(values).all()), "the figures' data are finite")
    print(f"plot_analysis on the {label} run: sweep rows {sweep}; spread matrix "
          f"{matrix.shape} ({', '.join(spread['actions'])} x 17 joints), max "
          f"{float(matrix.max()):.4f} mm, per-frame spread over {spread['frame_spread'].size} "
          f"frames; MPJPE vs MPSCE points {points}; max stretch of {len(bone_names)} bones, "
          f"largest {float(stretch.max()):.4f} mm; bars {', '.join(bars)}; "
          f"{errs.shape[0]} segment-error rows", flush=True)
    if matplotlib_imports():
        plot_analysis.main([str(run), "--labels", "flagship", "--sweep-param", "K=5"])
        drawn = sorted(p.name for p in run.glob("*.png"))
        require(len(drawn) == 14, f"plot_analysis drew {drawn}")
        print(f"plot_analysis drew {len(drawn)} figures", flush=True)
    else:
        for draw in (plot_analysis.plot_max_stretch, plot_analysis.inspect_multimodality,
                     plot_analysis.plot_seg_err_histograms):
            try:
                draw(run)
                require(False, f"{draw.__name__} drew without matplotlib")
            except ImportError as e:
                require("matplotlib" in str(e), f"the ImportError names matplotlib: {e}")
        print("plot_analysis: matplotlib does not import, each drawing raised the "
              "ImportError naming it; not drawn", flush=True)
    return require_no_launches("the analysis tools")


def phase_toy_tables(out_dir: Path) -> dict:
    """Phase 48. Returns the launch counts (none)."""
    import contextlib
    import io

    from manipose_tpu_torch import ops
    from manipose_tpu_torch.tools import get_table_data, quantitative_comparison

    ops.reset_launch_counts()
    for setting in ("toy2d", "toy3d"):
        root = out_dir / setting
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # each run prints its config
            results = quantitative_comparison.main([
                "--setting", setting, "--seeds", ",".join(map(str, TABLE_SEEDS)),
                f"train.epochs={TOY_EPOCHS}", f"run.output_dir={root}"])
        wall = time.perf_counter() - t0
        require(len(results) == 3 * len(TABLE_SEEDS)
                and all(v is not None and np.isfinite(v) for _, v in results),
                f"{setting} runs {results}")
        dirs = [str(root / name) for name, _ in results]
        groups = {}
        text = printed_by(lambda argv: groups.update(get_table_data.main(argv)), dirs)
        require(sorted(groups) == sorted(f"{setting}_{a}" for a in quantitative_comparison.ARCHS)
                and all(len(ms) == len(TABLE_SEEDS) for ms in groups.values()),
                f"{setting} table groups {groups}")
        require(all(np.isfinite(v) for ms in groups.values() for m in ms for v in m.values()),
                f"{setting} table cells finite: {groups}")
        require("nan" not in text and "inf" not in text, f"{setting} table:\n{text}")
        print(f"toy table {setting} ({len(TABLE_SEEDS)} seeds x 3 archs, {TOY_EPOCHS} "
              f"epochs, {wall:.1f} s on the card):\n{text}", flush=True)
    return require_no_launches("the toy tables")


def phase_mup() -> dict:
    """Phase 49. Returns the launch counts of its card runs."""
    from manipose_tpu_torch import ops
    from manipose_tpu_torch.tools import mup_coord_check, mup_lr_transfer

    base = MUP_WIDTHS[0]
    keys = ("trunk_abs", "out_abs")
    ops.reset_launch_counts()
    for width in MUP_WIDTHS:
        weights = mup_coord_check.build_model(width, base, True).state_dict()
        t0 = time.perf_counter()
        card = mup_coord_check.run(width, base, MUP_STEPS, state_dict=weights, device="cuda")
        card_s = time.perf_counter() - t0
        cpu = mup_coord_check.run(width, base, MUP_STEPS, state_dict=weights, device="cpu")
        for key in keys:
            got, ref = card[0][key], cpu[0][key]
            require(np.isfinite(got) and abs(got - ref) <= MODEL_TOL * abs(ref),
                    f"coord check width {width} step 0 {key}: card {got}, cpu {ref}")
        require(all(np.isfinite(r[k]) for r in card for k in keys), f"coord check {card}")
        gaps = [max(abs(c[k] - p[k]) / abs(p[k]) for k in keys) for c, p in zip(card, cpu)]
        print(f"mup_coord_check width {width} ({MUP_STEPS} steps, {card_s:.2f} s on the "
              f"card): trunk|a| " + " ".join(f"{r['trunk_abs']:.4f}" for r in card)
              + ", out|a| " + " ".join(f"{r['out_abs']:.4f}" for r in card)
              + "; card against the CPU by step (relative) "
              + " ".join(f"{g:.2g}" for g in gaps), flush=True)

    for mup in (True, False):
        t0 = time.perf_counter()
        res = mup_lr_transfer.lr_transfer(widths=MUP_WIDTHS, steps=MUP_TRANSFER_STEPS,
                                          mup=mup, seeds=(0, 1), device="cuda")
        wall = time.perf_counter() - t0
        best = res["best_idx"]
        drift = abs(best[min(best)] - best[max(best)])
        require(all(np.isfinite(v) for c in res["curves"].values() for v in c),
                f"transfer curves {res['curves']}")
        if mup:
            require(res["transfer_gap"] < MUP_GAP_LIMIT and drift <= 1,
                    f"muP transfer gap {res['transfer_gap']} (< {MUP_GAP_LIMIT}), best "
                    f"rates {best} (drift <= 1)")
        print(f"lr_transfer {'muP' if mup else 'SP'} (widths {MUP_WIDTHS}, "
              f"{MUP_TRANSFER_STEPS} steps, seeds 0 and 1, {len(res['lrs'])} rates, "
              f"{wall:.1f} s): transfer gap {res['transfer_gap']:.4f}, best rate index "
              f"{best} (drift {drift}); curves " + "; ".join(
                  f"{w}: " + " ".join(f"{v:.4f}" for v in c) for w, c in res["curves"].items()),
              flush=True)
    counts, fp32 = ops.launch_counts(), ops.launch_counts(torch.float32)
    require(counts == fp32, f"muP launches {counts}, on fp32 operands {fp32}")
    require(counts["attention_dense"] == counts["attention_dense_bwd"] == 0
            and all(counts[k] > 0 for k in ("attention_packed", "attention_packed_bwd",
                                            "fused_mlp", "fused_mlp_bwd")),
            f"muP launches (K3-K6 only at L <= 27): {counts}")
    print(f"muP tools launches {counts} (all on fp32 operands)", flush=True)
    return counts


def phase_fast(out_dir: Path, serve_fps: float, blocked_seq_s: float) -> dict:
    """Phase 50. Returns {path: launch counts}."""
    import collections
    import contextlib
    import io

    from manipose_tpu_torch import ops
    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.ops import cuda_attention
    from manipose_tpu_torch.serving import Predictor
    from manipose_tpu_torch.tools import seg_heads_ab

    cfg = load_config("config", ["model=fast"])
    require(cfg.model.nheads_seg == 2 and cfg.model.channels_seg == 128,
            f"model=fast: segments {cfg.model.channels_seg} wide in {cfg.model.nheads_seg} heads")
    # every head dim that attention() sees, and so whether it pads one
    seen = collections.Counter()
    padded_head_dim = cuda_attention.padded_head_dim

    def spy(d):
        seen[d] += 1
        return padded_head_dim(d)

    counts = {}
    cuda_attention.padded_head_dim = spy
    try:
        predictor = Predictor(cfg=cfg, batch_size=16, tta=True)
        l = cfg.data.seq_len
        video = np.random.default_rng(0).normal(size=(16 * l, 17, 2)).astype(np.float32)
        predictor.predict_video(video)  # warm-up
        seen.clear()
        ops.reset_launch_counts()
        poses, hyps, scores = predictor.predict_video(video, return_hypotheses=True)
        counts["serve_fast"] = require_counts(
            "float32", {k: 2 * n for k, n in LAUNCHES_PER_FORWARD.items()},
            "model=fast fp32 serving (1 batch of 16 windows, TTA)")
        require(set(seen) == {64}, f"model=fast serving head dims {dict(seen)}")
        require(all(bool(np.isfinite(a).all()) for a in (poses, hyps, scores))
                and poses.shape == video.shape[:2] + (3,), f"poses {poses.shape}")
        serve_dims = dict(seen)
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            predictor.predict_video(video)
        fps = video.shape[0] * reps / (time.perf_counter() - t0)

        state, step = make_trainer(load_config("config", ["model=fast", "model.dtype=bfloat16"]),
                                   "cuda")
        x, y = (t.cuda() for t in flagship_batch(l, TRAIN_BATCH))
        seen.clear()
        ops.reset_launch_counts()
        history = [step(state, x, y, TRAIN_LR)]
        torch.cuda.synchronize()
        counts["train_step_fast_bf16"] = require_counts(
            "bfloat16", LAUNCHES_PER_TRAIN_STEP, "model=fast bf16 train step")
        require(set(seen) == {64}, f"model=fast train step head dims {dict(seen)}")
        train_dims = dict(seen)
        history.append(step(state, x, y, TRAIN_LR))  # second warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            history.append(step(state, x, y, TRAIN_LR))
        torch.cuda.synchronize()
        seq_s = TRAIN_BATCH * TRAIN_STEPS / (time.perf_counter() - t0)
        for i, metrics in enumerate(history):
            require_finite(metrics, f"model=fast train step {i}")
        del state, step, x, y
    finally:
        cuda_attention.padded_head_dim = padded_head_dim
    print(f"model=fast (segments 128 wide, 2 heads of 64): predict_video {fps:.1f} frames/s "
          f"(fp32, 16 windows, TTA, mean of {reps}; phase 3's flagship {serve_fps:.1f}); bf16 "
          f"train step {seq_s:.2f} sequences/s (B={TRAIN_BATCH}, mean of {TRAIN_STEPS} after "
          f"2 warm-ups; phase 9's flagship {blocked_seq_s:.2f}); head dims at attention(): "
          f"serving {serve_dims}, train step {train_dims} (none padded)", flush=True)

    weights = {k: v.cpu() for k, v in predictor.model.state_dict().items()}
    del predictor
    window = np.random.default_rng(1).normal(size=(FAST_CPU_WINDOWS * l, 17, 2))
    window = window.astype(np.float32)
    outs = {dev: Predictor(cfg=cfg, state_dict=weights, batch_size=FAST_CPU_WINDOWS,
                           tta=False, device=dev).predict_video(window, return_hypotheses=True)
            for dev in ("cuda", "cpu")}
    errs = {}
    for i, name in enumerate(("poses", "hyps", "scores")):
        ref, got = outs["cpu"][i], outs["cuda"][i]
        err = float(np.abs(ref - got).max())
        tol = MODEL_TOL * max(1.0, float(np.abs(ref).max()))
        require(err <= tol, f"model=fast cpu vs card {name}: {err} > {tol}")
        errs[name] = (err, tol)
    print(f"model=fast cpu vs card (fp32, {FAST_CPU_WINDOWS} windows, TTA off): "
          + ", ".join(f"{k} err {e:.3g} (tol {t:.3g})" for k, (e, t) in errs.items()),
          flush=True)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    path = out_dir / "seg_heads_ab.json"
    with contextlib.redirect_stdout(io.StringIO()):  # the loop's epoch lines
        results = seg_heads_ab.main(["--seeds", "0", "--epochs", str(SEG_AB_EPOCHS),
                                     "--json", str(path)])
    wall = time.perf_counter() - t0
    arms = [k for k in results if k != "protocol"]
    require(arms == ["seg8", "seg2"] and path.exists(), f"seg_heads_ab arms {arms}")
    require(all(np.isfinite(v) for a in arms for row in results[a] for v in row.values()),
            f"seg_heads_ab results {results}")
    counts["seg_heads_ab"] = ops.launch_counts()
    require(counts["seg_heads_ab"]["attention_dense"] == 0
            and all(counts["seg_heads_ab"][k] > 0 for k in ("attention_packed",
                                                            "attention_packed_bwd",
                                                            "fused_mlp", "fused_mlp_bwd")),
            f"seg_heads_ab launches (K3-K6 at L = 27): {counts['seg_heads_ab']}")
    print(f"seg_heads_ab (d=64, L=27, segments 16 wide, K=3; seed 0, {SEG_AB_EPOCHS} epochs "
          f"an arm, {wall:.1f} s): " + "; ".join(
              f"{a} " + ", ".join(f"{k} {v:.3f}" for k, v in results[a][0].items())
              for a in arms) + f"; launches {counts['seg_heads_ab']}", flush=True)
    return counts


def phase_dstformer() -> dict:
    """Phase 51. Returns {path: launch counts}."""
    from manipose_tpu_torch import ops
    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.drivers import instantiate_model
    from manipose_tpu_torch.geometry import h36m_skeleton_17
    from manipose_tpu_torch.serving import Predictor
    from manipose_tpu_torch.train import LossConfig, TrainState, make_train_step
    from manipose_tpu_torch.train.optim import optimizer_from_config
    from manipose_tpu_torch.utils import profiling

    cfg = load_config("config", ["model=dstformer", "train=motionbert_ft"])
    m, t = cfg.model, cfg.train
    require(m.arch == "dstformer" and m.channels == 512 and m.layers == 5 and m.nheads == 8
            and t.optimizer == "adamw", "model=dstformer train=motionbert_ft: the published "
                                        "sizes and AdamW")
    skeleton = h36m_skeleton_17()
    model, rmcl = instantiate_model(cfg, skeleton)
    require(not rmcl, "the DSTformer is single-hypothesis")
    with torch.no_grad():  # fusions away from the published init's 1/2
        gen = torch.Generator().manual_seed(0)
        for fuse in model.ts_attn:
            fuse.weight.copy_(torch.randn(fuse.weight.shape, generator=gen)
                              * 0.5 / fuse.weight.shape[1] ** 0.5)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    fusions = DSTFORMER_FUSIONS_PER_FORWARD

    counts = {}
    l, b = cfg.data.seq_len, DSTFORMER_WINDOWS
    predictor = Predictor(cfg=cfg, state_dict=weights, batch_size=b, tta=True)
    video = np.random.default_rng(0).normal(size=(b * l, 17, 2)).astype(np.float32)
    predictor.predict_video(video)  # warm-up
    ops.reset_launch_counts()
    profiling.reset()
    poses = predictor.predict_video(video)
    torch.cuda.synchronize()
    counts["serve_dstformer"] = require_counts(
        "float32", {**{k: 2 * n for k, n in DSTFORMER_LAUNCHES_PER_FORWARD.items()},
                    "stream_fusion": 2 * fusions},
        f"DSTformer fp32 serving (1 batch of {b} windows, TTA)")
    spans = [sp for sp in profiling.spans() if sp.name == "model.fuse"]
    require(len(spans) == 2 * fusions and all(sp.counts == {"rows": b * l * 17}
                                              for sp in spans),
            f"DSTformer serving: {len(spans)} model.fuse spans "
            f"{[sp.counts for sp in spans]}, want {2 * fusions} of {b * l * 17} rows")
    require(poses.shape == video.shape[:2] + (3,) and bool(np.isfinite(poses).all()),
            f"DSTformer poses {poses.shape}, finite {bool(np.isfinite(poses).all())}")
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        predictor.predict_video(video)
    fps = video.shape[0] * reps / (time.perf_counter() - t0)
    del predictor

    model, _ = instantiate_model(cfg, skeleton)
    model.load_state_dict(weights, strict=True)
    opt = optimizer_from_config(model, cfg)
    require(type(opt.adam) is torch.optim.AdamW, f"train=motionbert_ft's optimizer {opt.adam}")
    state = TrainState.create(model, opt, seed=cfg.run.seed, device="cuda")
    step = make_train_step(model, LossConfig(
        sq_loss=t.sq_loss, w_loss=t.w_loss, vel_loss=t.vel_loss, smooth_reg=t.smooth_reg,
        rmcl_score_reg=t.rmcl_score_reg, rigid_seg_reg=t.rigid_seg_reg, rmcl=False,
        nmpjpe=t.nmpjpe), skeleton, opt)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(b, l, 17, 2)).astype(np.float32)).cuda()
    y = torch.from_numpy((0.3 * rng.normal(size=(b, l, 17, 3))).astype(np.float32)).cuda()
    ops.reset_launch_counts()
    history = [step(state, x, y, DSTFORMER_LR)]
    torch.cuda.synchronize()
    per_forward = DSTFORMER_LAUNCHES_PER_FORWARD
    counts["train_step_dstformer"] = require_counts(
        "float32", {**per_forward, **{k + "_bwd": n for k, n in per_forward.items()},
                    ("fused_mlp", "wgmma"): per_forward["fused_mlp"],
                    ("fused_mlp_bwd", "wgmma"): per_forward["fused_mlp"],
                    "stream_fusion": fusions, "stream_fusion_bwd": fusions},
        f"DSTformer fp32 train step (B={b})")
    for name, p in state.model.named_parameters():
        require(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                f"DSTformer {name}'s gradient is finite")
    history.append(step(state, x, y, DSTFORMER_LR))  # second warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        history.append(step(state, x, y, DSTFORMER_LR))
    torch.cuda.synchronize()
    seq_s = b * TRAIN_STEPS / (time.perf_counter() - t0)
    for i, metrics in enumerate(history):
        require_finite(metrics, f"DSTformer train step {i}")
    del state, step, model, opt
    torch.cuda.empty_cache()
    losses = " ".join(f"{float(h['loss']):.5f}" for h in history)
    print(f"dstformer (published sizes, fp32): predict_video {fps:.1f} frames/s ({b} windows, "
          f"TTA, mean of {reps}); AdamW train step {seq_s:.2f} sequences/s (B={b}, mean of "
          f"{TRAIN_STEPS} after 2 warm-ups); losses per step {losses}; launches "
          f"{json.dumps(counts)}", flush=True)
    return counts


def rank_worker() -> int:
    """One rank of ``--ranks N`` (under torchrun, nccl, one card a rank):
    ring attention on a ring of every rank (phase 41's checks), each
    layout's flagship train step against the plain step (fp32 strict, bf16
    finite and timed), and the training driver under each layout."""
    import os

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from manipose_tpu_torch.parallel import initialize_multihost, is_primary, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_multihost(auto=True, backend="nccl")
    world, primary = dist.get_world_size(), is_primary()
    quiet = None
    if not primary:
        quiet = sys.stdout = open(os.devnull, "w")
    scratch = ROOT / "build" / "chip_smoke_ranks"
    try:
        t0 = time.perf_counter()
        ring = phase_ring(make_mesh(1, world))
        print(f"ring phase ({world} ranks): {time.perf_counter() - t0:.1f} s", flush=True)
        legs = {}
        for dtype, strict in (("float32", True), ("bfloat16", False)):
            t0 = time.perf_counter()
            legs[dtype] = run_sharded_legs(sharded_legs(world), dtype, None, strict=strict)
            print(f"sharded steps {dtype} ({world} ranks): {time.perf_counter() - t0:.1f} s",
                  flush=True)
        t0 = time.perf_counter()
        drivers = phase_rank_drivers(world, scratch)
        print(f"drivers phase ({world} ranks): {time.perf_counter() - t0:.1f} s", flush=True)
        dist.barrier()
    finally:
        if primary:
            shutil.rmtree(scratch, ignore_errors=True)
        dist.destroy_process_group()
        if quiet is not None:
            sys.stdout = sys.__stdout__
            quiet.close()
    if primary:
        print("ranks " + json.dumps({"world": world, "ring_ms": ring, "legs": legs,
                                     "drivers": drivers}), flush=True)
    return 0


def main_ranks(n: int) -> int:
    """``--ranks N``: build every kernel here, then run ``rank_worker`` on N
    cards under torchrun (``python -m torch.distributed.run``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < n:
        print(f"chip_smoke: --ranks {n} needs {n} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from manipose_tpu_torch.ops import build

    print(cmd_output(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]), flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rc = subprocess.call([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          f"--nproc-per-node={n}", str(Path(__file__).resolve()),
                          "--rank-worker"])
    print(f"--ranks {n}: exit {rc} after {time.perf_counter() - t0:.1f} s", flush=True)
    return rc


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
    k5_paths = phase_k5_paths()
    k6_paths = phase_k6_paths()
    fusion_cases = phase_fusion_kernels()
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

    # the trunk variants: joint-major, remat, the megastep (phases 34-38)
    t0 = time.perf_counter()
    jm_cases = phase_joint_major_kernels()
    print(f"joint-major kernels phase: {time.perf_counter() - t0:.1f} s", flush=True)
    jm_counts, jm_fps, jm_train_counts, jm_seq = {}, {}, {}, {}
    for dtype, fold_pred, fold_seq in (("float32", predictor, seq_s),
                                       ("bfloat16", predictor16, seq_s16)):
        t0 = time.perf_counter()
        jm_counts[dtype], jm_fps[dtype] = phase_joint_major_serving(dtype, fold_pred)
        jm_train_counts[dtype], jm_seq[dtype] = phase_joint_major_train(dtype, fold_seq,
                                                                        weights)
        print(f"joint-major {dtype} phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    remat_counts = {dtype: phase_remat(dtype) for dtype in ("float32", "bfloat16")}
    print(f"remat phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    megastep = {
        "3dhp_bf16": phase_megastep(
            f"3dhp bf16 (L={DHP3_SEQ_LEN}, B={DHP3_BATCH}, steps_per_call=4)",
            ["data=mpi_inf_3dhp", "model.dtype=bfloat16"], DHP3_BATCH, DHP3_SEQ_LEN, 4, 5),
        "flagship_bf16": phase_megastep(
            f"flagship bf16 (L=243, B={TRAIN_BATCH}, steps_per_call=2)",
            ["model.dtype=bfloat16"], TRAIN_BATCH, 243, 2, 3),
        "3dhp_bf16_remat": phase_megastep(
            f"3dhp bf16 remat (L={DHP3_SEQ_LEN}, B={DHP3_BATCH}, steps_per_call=4)",
            ["data=mpi_inf_3dhp", "model.dtype=bfloat16", "model.remat=true"],
            DHP3_BATCH, DHP3_SEQ_LEN, 4, 2),
    }
    print(f"megastep phase: {time.perf_counter() - t0:.1f} s; "
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
        # phase 47's plot_analysis reads the fp32 eval run's artifacts
        eval_run = ROOT / "build" / "chip_smoke_analysis" / "eval_float32"
        shutil.rmtree(eval_run.parent, ignore_errors=True)
        shutil.copytree(Path(eval_config("float32", scratch).run.output_dir) / "eval_float32",
                        eval_run)
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
        t0 = time.perf_counter()
        phase_dhp3_megastep(scratch, dhp3_epochs["bfloat16"])
        print(f"3dhp megastep driver phase: {time.perf_counter() - t0:.1f} s", flush=True)
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

    scratch = ROOT / "build" / "chip_smoke_toy"
    shutil.rmtree(scratch, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        phase_toy(scratch)
        print(f"toy phase: {time.perf_counter() - t0:.1f} s; "
              f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    # parallel/ on the one card: phases 40-43
    t0 = time.perf_counter()
    parallel_counts = phases_parallel(cases, seq_s16)
    print(f"parallel phases: {time.perf_counter() - t0:.1f} s; "
          f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    # viz, the run-the-model tools, MLflow: phases 44-46
    scratch = ROOT / "build" / "chip_smoke_tools"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    t_new = time.perf_counter()
    try:
        write_h36m(scratch, eval_config("float32", scratch).run.seed)
        t0 = time.perf_counter()
        viz_counts = phase_viz(scratch)
        print(f"viz phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        ablation_counts = phase_tools(scratch, fps, int8_fps["float32"], seq_s16)
        print(f"tools phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        phase_mlflow(scratch)
        print(f"mlflow phase: {time.perf_counter() - t0:.1f} s; phases 44-46 "
              f"{time.perf_counter() - t_new:.1f} s; total "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    # the offline-analysis and muP tools, model=fast: phases 47-50
    scratch = eval_run.parent
    t_new = time.perf_counter()
    try:
        t0 = time.perf_counter()
        analysis_counts = phase_analysis(scratch, eval_run)
        print(f"analysis phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        table_counts = phase_toy_tables(scratch)
        print(f"toy tables phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        mup_counts = phase_mup()
        print(f"muP phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        fast_counts = phase_fast(scratch, fps, seq_s16)
        print(f"fast phase: {time.perf_counter() - t0:.1f} s; phases 47-50 "
              f"{time.perf_counter() - t_new:.1f} s; total "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    t0 = time.perf_counter()
    dst_counts = phase_dstformer()
    print(f"dstformer phase: {time.perf_counter() - t0:.1f} s; total "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    kernels, table = [], kernel_table()
    for name in REPLACES:
        meta = table[name]
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
                   "http_serve": http_counts,
                   "serve_joint_major": jm_counts["float32"],
                   "serve_joint_major_bf16": jm_counts["bfloat16"],
                   "train_step_joint_major": jm_train_counts["float32"],
                   "train_step_joint_major_bf16": jm_train_counts["bfloat16"],
                   "train_step_remat": remat_counts["float32"],
                   "train_step_remat_bf16": remat_counts["bfloat16"],
                   "viz": viz_counts, "step_ablation_full_bf16": ablation_counts,
                   "analysis_tools": analysis_counts, "toy_tables": table_counts,
                   "mup_tools": mup_counts, **fast_counts, **dst_counts,
                   **{f"megastep_{k}_replayed": v[4] for k, v in megastep.items()},
                   **{f"train_step_{k}_bf16": v for k, v in parallel_counts.items()}}
        variants = [dict(name=f"{name}_strided", layout="joint_major", route="cuda",
                         source=meta["source"], replaces=meta["replaces"],
                         launches=jm_train_counts["bfloat16"][name],
                         max_abs_err=max(c["max_abs_err"] for c in jm_cases[name]
                                         if c["dtype"] == "bfloat16"),
                         **{key: c[key] for key in ("ms", "fold_ms", "plain_ms", "bound_ms",
                                                    "bound_by", "library_ms")},
                         timed_case=f"{c['trunk']} {c['dtype']} {c['shape']}",
                         cases=jm_cases[name])
                    for c in jm_cases.get(name, [])[2:3]]
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
            cases=cases[name], **({"variants": variants} if variants else {}),
            **({"paths": {"fused_mlp": k5_paths, "fused_mlp_bwd": k6_paths}[name]}
               if name in ("fused_mlp", "fused_mlp_bwd") else {}),
        ))
    for name in (n for n in table if n not in REPLACES):  # the DSTformer's, in fp32 only
        head = fusion_cases[name][0]
        kernels.append(dict(
            name=name, route="cuda", **table[name],
            launches=dst_counts["train_step_dstformer"][name],
            launches_by_path={path: c[name] for path, c in dst_counts.items()},
            max_abs_err=head["max_abs_err"], ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            timed_case=f"{head['trunk']} {head['dtype']} {head['shape']}",
            cases=fusion_cases[name],
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
          f"joint-major serving frames/s fp32 {jm_fps['float32']:.1f}, bf16 "
          f"{jm_fps['bfloat16']:.1f}; joint-major train sequences/s fp32 "
          f"{jm_seq['float32']:.2f}, bf16 {jm_seq['bfloat16']:.2f}; megastep sequences/s "
          + ", ".join(f"{k} {v[1]:.2f} (single {v[0]:.2f})" for k, v in megastep.items())
          + f"; total {time.perf_counter() - t_start:.1f} s on {smi}")
    print("int8 gemms " + json.dumps(int8_rows))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-probe"]:  # one rank of phase 40
        backend, rank, port, out = sys.argv[2:6]
        sys.exit(rank_probe(backend, int(rank), int(port), Path(out)))
    if sys.argv[1:2] == ["--rank-worker"]:  # one rank of --ranks N
        sys.exit(rank_worker())
    if sys.argv[1:2] == ["--ranks"]:
        sys.exit(main_ranks(int(sys.argv[2])))
    sys.exit(main())
