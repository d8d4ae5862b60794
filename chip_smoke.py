#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit: ``python3 chip_smoke.py``. It imports nothing of JAX or of the JAX
package. Phases, each fatal on failure:

1. build    - compile every CUDA kernel of ``manipose_tpu_torch/ops/csrc``
              with nvcc (one process per source, in parallel).
2. kernels  - each kernel (K1 dense attention, K3 per-window attention,
              K5 fused MLP) against its plain PyTorch version at the shapes
              the flagship forward gives it, in fp32 and bf16, timed beside
              its plain version, its roofline bound and one PyTorch library
              call computing the same function.
3. flagship - ``Predictor.predict_video`` at ``configs/config.yaml`` (rMCL,
              fp32, 16 windows of 243 frames, TTA on) with seeded random
              weights: output checks, the manifold invariant, the kernel
              launch counts of the run, and frames/s.
4. cpu-card - one window of the flagship model, TTA off, on the CPU (plain
              versions) and on the card (kernels) with the same weights.
5. profile  - only with ``--profile``: one flagship ``predict_video`` under
              ``torch.profiler``, device time by kernel class and the
              device's busy share of the call.

The last lines are the card's name and power limit (as nvidia-smi prints
them), one JSON object ``{"kernels": [...]}``, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W): the
# roofline bound of a kernel is the larger of bytes / memory rate and
# operations / peak rate of the operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

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
# CPU vs card on the whole model: the JAX package's model-forward tolerance
# (5e-5), relative to the output's magnitude (16 fp32 trunk blocks whose
# sums run in another order on each side).
MODEL_TOL = 5e-5

# launches per forward pass of the flagship rMCL model: 8 + 2 temporal
# (K1) and 8 + 2 spatial (K3) attention layers, 16 + 4 MLPs (K5); TTA runs
# the model twice per window batch
LAUNCHES_PER_FORWARD = {"attention_dense": 10, "attention_packed": 10,
                        "fused_mlp": 20}

KERNELS = {
    "attention_dense": dict(
        source="manipose_tpu_torch/ops/csrc/attention.cu",
        replaces="manipose_tpu/ops/pallas_attention.py:97",
    ),
    "attention_packed": dict(
        source="manipose_tpu_torch/ops/csrc/attention.cu",
        replaces="manipose_tpu/ops/pallas_attention.py:224",
    ),
    "fused_mlp": dict(
        source="manipose_tpu_torch/ops/csrc/mlp.cu",
        replaces="manipose_tpu/ops/pallas_mlp.py:95",
    ),
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


def time_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    b_ms, b_by = bound_ms(4 * bh * n * d * elem, 4.0 * bh * n * n * d, dtype)
    return dict(
        trunk=trunk, dtype=str(dtype).replace("torch.", ""),
        shape=[batch, heads, n, d], max_abs_err=err, tol=tol,
        ms=time_ms(lambda: wrapper(q, k, v, scale)),
        plain_ms=time_ms(lambda: ca.attention_plain(q, k, v, scale)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(
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
    b_ms, b_by = bound_ms((2 * m * c + 2 * c * h + h + c) * elem,
                          4.0 * m * c * h, dtype)
    return dict(
        trunk=trunk, dtype=str(dtype).replace("torch.", ""),
        shape=[m, c, h], max_abs_err=err, tol=tol,
        ms=time_ms(lambda: cm.fused_mlp(x, w1, b1, w2, b2)),
        plain_ms=time_ms(lambda: cm.mlp_plain(x, w1, b1, w2, b2)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(
            lambda: F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)
        ),
    )


def phase_kernels():
    """Every kernel against its plain version at the flagship's shapes
    (B = 16 windows, L = 243, J = 17 joints, S = 16 bones, 8 heads)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, l, j, s = 16, 243, 17, 16
    cases = {name: [] for name in KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        cases["attention_dense"] += [
            attention_case("attention_dense", "rotations", b * j, 8, l, 64, dtype, gen),
            attention_case("attention_dense", "segments", b * s, 8, l, 16, dtype, gen),
        ]
        cases["attention_packed"] += [
            attention_case("attention_packed", "rotations", b * l, 8, j, 64, dtype, gen),
            attention_case("attention_packed", "segments", b * l, 8, s, 16, dtype, gen),
        ]
        cases["fused_mlp"] += [
            mlp_case("rotations", b * l * j, 512, 1024, dtype, gen),
            mlp_case("segments", b * l * s, 128, 256, dtype, gen),
        ]
    for name, rows in cases.items():
        for r in rows:
            print(f"kernel {name:16s} {r['trunk']:9s} {r['dtype']:8s} "
                  f"shape={r['shape']} err={r['max_abs_err']:.3g} "
                  f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                  f"library_ms={r['library_ms']:.4f}", flush=True)
    return cases


def bone_lengths(poses: np.ndarray, parents) -> np.ndarray:
    js = [i for i, p in enumerate(parents) if p >= 0]
    ps = [parents[i] for i in js]
    return np.linalg.norm(poses[..., js, :] - poses[..., ps, :], axis=-1)


def phase_flagship():
    from manipose_tpu_torch import ops
    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.serving import Predictor

    cfg = load_config("config")
    predictor = Predictor(cfg=cfg, batch_size=16, tta=True)
    n_windows = 16
    l = cfg.data.seq_len
    video = np.random.default_rng(0).normal(size=(n_windows * l, 17, 2))
    video = video.astype(np.float32)
    predictor.predict_video(video)  # warm-up

    ops.reset_launch_counts()
    poses, hyps, scores = predictor.predict_video(video, return_hypotheses=True)
    counts = ops.launch_counts()
    n_batches = -(-n_windows // predictor.batch_size)
    print(f"flagship launches {counts} for {n_batches} window batch(es)")
    for name, per_forward in LAUNCHES_PER_FORWARD.items():
        want = 2 * per_forward * n_batches
        require(counts[name] == want, f"{name} launched {counts[name]}, want {want}")

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
          f"-> {fps:.1f} frames/s (mean of {reps}, TTA on, batch 16, fp32); "
          f"score err {score_err:.3g}, bone-length spread {spread:.3g}", flush=True)
    return predictor, counts, fps


def phase_cpu_vs_card(card_predictor):
    from manipose_tpu_torch.serving import Predictor

    cfg = card_predictor.cfg
    state = {k: v.cpu() for k, v in card_predictor.model.state_dict().items()}
    window = np.random.default_rng(1).normal(size=(cfg.data.seq_len, 17, 2))
    window = window.astype(np.float32)
    outs = {}
    for device in ("cpu", "cuda"):
        pred = Predictor(cfg=cfg, state_dict=state, batch_size=1, tta=False,
                         device=device)
        outs[device] = pred.predict_video(window, return_hypotheses=True)
    errs = {}
    for i, name in enumerate(("poses", "hyps", "scores")):
        ref, got = outs["cpu"][i], outs["cuda"][i]
        err = float(np.abs(ref - got).max())
        tol = MODEL_TOL * max(1.0, float(np.abs(ref).max()))
        require(err <= tol, f"cpu vs card {name}: {err} > {tol}")
        errs[name] = (err, tol)
    print(f"cpu vs card (one flagship window, TTA off): "
          + ", ".join(f"{k} err {e:.3g} (tol {t:.3g})" for k, (e, t) in errs.items()),
          flush=True)


def kernel_group(name: str) -> str:
    """Coarse class of a device kernel, by its (mangled) name."""
    for ours in KERNELS:
        if f"{ours}_kernel" in name:
            return ours
    low = name.lower()
    if any(s in low for s in ("gemm", "cutlass", "xmma", "sm90_", "cublas")):
        return "library GEMM (qkv, proj, embeddings, heads)"
    if "layer_norm" in low:
        return "LayerNorm"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other elementwise / reductions"


def phase_profile(predictor) -> None:
    """One flagship ``predict_video`` under ``torch.profiler``: device time
    by kernel and by class, and the device's busy share of the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    video = np.random.default_rng(0).normal(size=(16 * predictor.seq_len, 17, 2))
    video = video.astype(np.float32)
    predictor.predict_video(video)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor.predict_video(video)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(ms for _, _, ms in rows)
    if busy_ms == 0.0:
        print("profile: the profiler recorded no device time (not measured)")
        return
    groups = {}
    for key, count, ms in rows:
        g = groups.setdefault(kernel_group(key), [0, 0.0])
        g[0] += count
        g[1] += ms
    print(f"profile: predict_video of {video.shape[0]} frames, wall {wall_ms:.2f} ms, "
          f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    for name, (count, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"  group {name:45s} launches {count:5d} {ms:9.3f} ms "
              f"{100 * ms / busy_ms:5.1f} %")
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:15]:
        print(f"  kernel {key[:90]:90s} launches {count:5d} {ms:9.3f} ms")


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
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  nvcc {name}: {line.strip()}")

    t0 = time.perf_counter()
    cases = phase_kernels()
    print(f"kernels phase: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    predictor, counts, fps = phase_flagship()
    print(f"flagship phase: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    phase_cpu_vs_card(predictor)
    print(f"cpu-card phase: {time.perf_counter() - t0:.1f} s; "
          f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = []
    for name, meta in KERNELS.items():
        head = cases[name][0]  # rotations trunk, fp32: the main path's shape
        kernels.append(dict(
            name=name, route="cuda", **meta, launches=counts[name],
            max_abs_err=max(c["max_abs_err"] for c in cases[name]
                            if c["dtype"] == "float32"),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            timed_case=f"{head['trunk']} {head['dtype']} {head['shape']}",
            cases=cases[name],
        ))
    if "--profile" in sys.argv[1:]:
        phase_profile(predictor)
    print(f"flagship frames/s {fps:.1f} on {smi}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
