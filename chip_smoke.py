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
              SM) per dtype and head dim.
2. kernels  - each kernel (K1 dense attention, K3 per-window attention,
              K5 fused MLP, and their backward kernels K2, K4, K6) against
              its plain PyTorch version at the shapes the flagship gives
              it, in fp32 and bf16, timed (with its achieved TFLOP/s)
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
              (+1e-6), printed beside the errors and times the kernels
              had with P and dS in one bf16 part.
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
16. profile - only with ``--profile``: one flagship ``predict_video`` and
              one flagship train step under ``torch.profiler``, in fp32
              and in bf16, device time by kernel class and the device's
              busy share of each.

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
# moves that far on the CPU (one score head's at the flagship). For the
# same reason the train step's gradients through FK and the WTA loss
# (which a 1e-3 change of the input moves by half on the CPU) are
# required finite, not close.
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
# 1.05 x the plain version's error (+1e-6). The plain version keeps P and
# dS in fp32, as the Pallas kernels do; the kernels split them into two
# bf16 parts (csrc/attention.cu, AccMma).
BF16_ACCURACY_RATIO, BF16_ACCURACY_SLACK = 1.05, 1e-6
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
            for n in (17, 16):
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
    (B = 16 windows, L = 243, J = 17 joints, S = 16 bones, 8 heads)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, l, j, s = TRAIN_BATCH, 243, 17, 16
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
            ]
        for kind, case in (("fused_mlp", mlp_case), ("fused_mlp_bwd", mlp_bwd_case)):
            cases[kind] += [
                case("rotations", b * l * j, 512, 1024, dtype, gen),
                case("segments", b * l * s, 128, 256, dtype, gen),
            ]
            torch.cuda.empty_cache()
    for name, rows in cases.items():
        for r in rows:
            print(f"kernel {name:20s} {r['trunk']:9s} {r['dtype']:8s} "
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
    opt = optimizer_from_config(model.parameters(), cfg)
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
    term within BF16_TOL relative, every gradient fp32 and finite; and each
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
        err = abs(metrics[k] - want) / abs(want)
        require(err <= BF16_TOL, f"cpu vs card bf16 train {k}: {metrics[k]} vs {want}")
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
          f"{metrics['loss']:.6f} card, worst term rel err {worst_term[1]:.3g} at "
          f"{worst_term[0]} (tol {BF16_TOL}); every gradient fp32 and finite (through "
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
            bound = BF16_ACCURACY_RATIO * plain + BF16_ACCURACY_SLACK
            before = ONE_PART_BF16_ERRORS.get((kind, trunk, name))
            line.append(f"{name} {kernel:.4e} (plain {plain:.4e}, ratio {kernel / plain:.4f}"
                        + (f", one part {before:.3e}" if before else "") + ")")
            require(kernel <= bound, f"bf16 {kind} {trunk} {name}: error against fp64 "
                                     f"{kernel} > {BF16_ACCURACY_RATIO} x plain {plain} "
                                     f"+ {BF16_ACCURACY_SLACK}")
        print(f"bf16 accuracy {kind:6s} {trunk:9s} {windows}*8 x {n} x {d} against fp64: "
              + "; ".join(line), flush=True)
    for name in ("attention_dense", "attention_dense_bwd", "attention_packed",
                 "attention_packed_bwd"):
        for c in cases[name]:
            if c["dtype"] == "bfloat16":
                print(f"bf16 time {name:20s} {c['trunk']:9s} {c['ms']:.4f} ms "
                      f"(one part {ONE_PART_BF16_MS[(name, c['trunk'])]:.4f} ms), "
                      f"{c['tflops']:.1f} TFLOP/s", flush=True)


def write_h36m(data_dir: Path, seed: int) -> None:
    """H36M-format npz files (``data_3d_h36m.npz`` with 32-joint world
    positions in meters, ``data_2d_h36m_cpn_ft_h36m_dbb.npz`` with pixel
    detections per camera) for S11 and EVAL_ACTIONS, from ``seed``."""
    rng = np.random.default_rng(seed)
    positions_3d = {"S11": {a: rng.normal(scale=0.3, size=(EVAL_FRAMES, 32, 3))
                            .astype(np.float32) for a in EVAL_ACTIONS}}
    positions_2d = {"S11": {a: [rng.uniform(0, 1000, size=(EVAL_FRAMES, 17, 2))
                                .astype(np.float32) for _ in range(4)]
                            for a in EVAL_ACTIONS}}
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
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    kernels = []
    for name, meta in KERNELS.items():
        # this slice's main path is bf16 eval: each kernel's headline case is
        # the rotations trunk in bf16, its launches those of the bf16 eval
        # driver (the forward kernels) or of the bf16 train step (the
        # backward ones, which eval does not run)
        head = next(c for c in cases[name] if c["dtype"] == "bfloat16")
        by_path = {"serve": counts, "train_step": train_counts,
                   "serve_bf16": counts16, "train_step_bf16": train_counts16,
                   "eval": eval_counts["float32"], "eval_bf16": eval_counts["bfloat16"]}
        kernels.append(dict(
            name=name, route="cuda", **meta,
            launches=(train_counts16 if name.endswith("_bwd")
                      else eval_counts["bfloat16"])[name],
            launches_by_path={path: c[name] for path, c in by_path.items()},
            max_abs_err=max(c["max_abs_err"] for c in cases[name]
                            if c["dtype"] == head["dtype"]),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            timed_case=f"{head['trunk']} {head['dtype']} {head['shape']}",
            cases=cases[name],
        ))
    if "--profile" in sys.argv[1:]:
        phase_profile("fp32", predictor, (state, step, batch))
        phase_profile("bf16", predictor16, (state16, step16, batch16))
    print(f"flagship frames/s fp32 {fps:.1f}, bf16 {fps16:.1f}; train sequences/s "
          f"fp32 {seq_s:.2f} (peak {peak_gb:.2f} GB), bf16 {seq_s16:.2f} (peak "
          f"{peak_gb16:.2f} GB); eval frames/s fp32 {eval_fps['float32']:.1f}, bf16 "
          f"{eval_fps['bfloat16']:.1f}; total {time.perf_counter() - t_start:.1f} s "
          f"on {smi}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
