"""Probes of the tensor-core kernels on the card: what bounds them.

Run from the repository root on a machine with an H100 and the CUDA
toolkit: ``python3 -m manipose_tpu_torch.ops.probes.run_probes [section
...] [--against DIR]`` (sections as numbered below; all by default). It
builds into ``build/probes/`` and prints:

1. ``mma_rate``: the peak rate of mma.sync tf32 and bf16 on register
   operands (``mma_rate.cu``).
2. ``accumulate``: the error of fp32 products on the tensor cores against
   fp64, for the accumulation schemes of ``accumulate.cu``.
3. ``ablate``: K5's mma.sync kernel at the flagship's rotations-trunk
   shape (M 66096, C 512, H 1024), fp32 and bf16, built from ``csrc/`` as it is and with one part
   of the work taken out of a copy of the sources (the numbers of a variant
   are wrong by design; only its time is read): ``one_pass`` (one tf32
   pass instead of three), ``no_split`` (operands passed unsplit),
   ``no_copy`` (no cp.async copies), ``no_fc1`` and ``no_fc2`` (the
   products of one of K5's two GEMMs skipped).
   ``wgmma`` (a section of its own): the same for K5's wgmma kernel
   (fp32) at M 66096 and 33048: ``base``, ``one_pass`` (the big parts'
   product alone), ``no_mma`` (no wgmma: the loads, the fragments'
   splits and the waits alone), ``no_w_loads`` (no TMA load of the
   weights' planes) and ``no_x_loads`` (none of x).
4. ``k6``: the device time of each of K6's kernels at the same shape, from
   ``torch.profiler``.
   ``k6wgmma`` (a section of its own): each kernel of K6's wgmma path
   (fp32) at M 66096 and 132192, from ``torch.profiler``, built from
   ``csrc/`` as it is and with one part of the work taken out:
   ``no_stores`` (the rows pass writes no planes), ``no_dh`` (the rows
   pass skips dh = g W2 and g's loads), ``one_pass`` (the big parts'
   product alone, in the rows pass and the tile products) and ``no_mma``
   (no wgmma at all).
   ``linear`` (a section of its own): each kernel of the fp32 linear
   (``cuda_linear``: the forward, dX and dW products, the split and
   transpose passes, the reduce) at the trunks' qkv and proj (K 512, N
   1536 and 512) at M 66096 and 132192, from ``torch.profiler``, built
   from ``csrc/`` as it is and with one part of the work taken out:
   ``one_pass`` (the big parts' product alone), ``no_mma`` (no wgmma:
   the loads, the splits in registers and the waits alone) and
   ``no_split`` (no split or transpose pass: the products read planes
   left as they were).
5. ``attention``: K1 and K2 at the flagship's shapes (rotations 272*8
   windows of 243 x 64, segments 256*8 of 243 x 16), fp32 and bf16, in
   turns, built from ``csrc/`` as it is (``base``, twice) and changed:
   ``no_copy``, ``no_split`` and ``one_pass`` as for K5; ``no_scores``
   (the products over d skipped: S, dP), ``no_rows`` (the products over
   rows skipped: P V in K1; dS K, P^T dO and dS^T Q in K2), ``no_exp``
   (the softmax's exp2 left out), ``stages3`` (a 3-slot ring),
   ``blocks2`` and ``blocks3`` (registers capped for two or three blocks
   an SM at every head dim), ``warps8`` (blocks of 8 warps owning 128
   rows, one an SM). With
   ``--against DIR`` it also times the kernels built from the source
   directory DIR (an earlier commit's ``csrc/``, unpacked with ``git
   archive``) as ``against``.
6. ``packed``: K3 and K4 at the flagship's shapes (rotations 3888*8
   windows of 17 x 64, segments 3888*8 of 16 x 16), fp32 and bf16, in
   turns, built from ``csrc/`` as it is (``base``, first and last) and
   changed: ``no_copy`` (no window copied), ``no_math`` (each window's
   products, softmax and stores skipped: the copies alone), ``one_pass``
   (one tf32 pass instead of three), ``slots1``, ``slots2`` and ``slots3``
   (a ring of one, two or three windows a warp at every dtype and head
   dim), ``warps2`` and ``warps8`` (blocks of two
   or eight warps), ``recompute`` (K4's dV and dK from recomputed
   transposed scores, ``packed_recompute.cuh``, instead of P^T and dS^T
   through shared memory). With ``--against DIR`` also the kernels of DIR
   (``against``, second and second to last), e.g. the parent commit's.
   Each is timed twice over 20 calls: CUDA events around calls queued
   behind a sleep kernel, and the kernels' device time from
   torch.profiler; neither counts the host's time to launch. Each
   variant's launch shapes are printed beside its times.

7. ``bf16``: each kernel's bf16 error against fp64 on the same bf16
   inputs, beside its plain version's, at the flagship's rotations and
   segments shapes: the relative error in norm of K1's/K3's output, of
   K2's/K4's dq, dk and dv, and of K5's output and K6's five gradients.
8. ``pinning``: ``evaluate`` at the flagship (fp32 and bf16; TTA, rMCL
   oracle; 7 seeded batches of 10 windows, the last with 4 valid rows)
   with each batch pinned on the prefetch thread (``producer``, as
   ``evaluate`` does on the card) or on the launching thread inside
   ``Batch.to_device`` (``consumer``), in turns: frames/s of each call
   (host clock) and the device's busy share of one call of each under
   torch.profiler.

The ablation patches the sources by text and stops if a patch point is
gone; update the patches with the kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from .. import build

HERE = Path(__file__).resolve().parent
OUT = build.BUILD_DIR.parent / "probes"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
SHAPE = (66096, 512, 1024)

# variant -> [(file, text, replacement, count)]
MLP_ABLATIONS = {
    "base": [],
    "one_pass": [("mma.cuh", "static constexpr int PASSES = 3;",
                  "static constexpr int PASSES = 1;", 1)],
    "no_split": [("mma.cuh", "      p[0][i] = __float_as_uint(big);\n"
                  "      p[1][i] = __float_as_uint(__fsub_rn(x, big));",
                  "      p[0][i] = w[i];\n      p[1][i] = w[i];", 1)],
    "no_copy": [("mma.cuh", "    cp_async16(dst + r * ld + 4 * c, s + (ok ? r * pitch : 0)"
                 " + 16 * c, ok);", "    (void)ok;", 1)],
    "no_fc1": [("mlp.cu", "for (int ks = 0; ks < R::KW / 8; ++ks) {",
                "for (int ks = 0; ks < 0; ++ks) {", 1)],
    "no_fc2": [("mlp.cu", "for (int ks = 0; ks < R::KW2 / 8; ++ks) {",
                "for (int ks = 0; ks < 0; ++ks) {", 1)],
}


def run_tool(name: str) -> None:
    exe = OUT / name
    subprocess.run([build.nvcc_path(), *FLAGS, "-o", str(exe), str(HERE / f"{name}.cu")],
                   check=True)
    subprocess.run([str(exe)], check=True)


_WG_PRODUCTS = ("  mma(d, a.small, bb, s == 0 ? 0 : 1);\n"
                "  mma(d, a.big, desc_swizzled(b_big + BOX + 32 * s), 1);\n"
                "  mma(d, a.big, bb, 1);")
WGMMA_ABLATIONS = {
    "base": [],
    "one_pass": [("mlp.cu", _WG_PRODUCTS, "  mma(d, a.big, bb, s == 0 ? 0 : 1);", 1)],
    "no_mma": [("mlp.cu", _WG_PRODUCTS, "  (void)bb;", 1)],
    "no_w_loads": [("mlp.cu", "    bar_expect(full, W_SLOT);\n"
                    "    tma_load(slot, map, k0, row0, full);\n"
                    "    tma_load(slot + BOX, map, k0, plane_rows + row0, full);",
                    "    bar_arrive(full);\n"
                    "    (void)slot, (void)map, (void)k0, (void)row0, (void)plane_rows;", 1)],
    "no_x_loads": [("mlp.cu", "        bar_expect(&x_full[r.i], BOX);\n"
                    "        tma_load(smem + OFF_X + r.i * BOX, tx, (n % (C / KB)) * KB, "
                    "tile * BM, &x_full[r.i]);", "        bar_arrive(&x_full[r.i]);", 1)],
}

_K6_PRODUCTS = ("  mma128(d, a.small, bb, s == 0 ? 0 : 1);\n"
                "  mma128(d, a.big, desc_swizzled(b_big + B_PLANE + 32 * s), 1);\n"
                "  mma128(d, a.big, bb, 1);")
K6_WGMMA_ABLATIONS = {
    "base": [],
    "no_stores": [("mlp.cu", "              at[0] = __uint_as_float(p[0][0]);\n"
                   "              at[plane] = __uint_as_float(p[1][0]);\n"
                   "              at[2 * plane] = __uint_as_float(p[0][1]);\n"
                   "              at[3 * plane] = __uint_as_float(p[1][1]);",
                   "              (void)at;", 1)],
    "no_dh": [("mlp.cu", "for (int n = 0; n < 2 * (C / KB); ++n) {",
               "for (int n = 0; n < C / KB; ++n) {", 2),
              ("mlp.cu", "      product(dh);\n", "", 1)],
    "one_pass": [("mlp.cu", _WG_PRODUCTS, "  mma(d, a.big, bb, s == 0 ? 0 : 1);", 1),
                 ("wgmma.cuh", _K6_PRODUCTS, "  mma128(d, a.big, bb, s == 0 ? 0 : 1);", 1)],
    "no_mma": [("mlp.cu", _WG_PRODUCTS, "  (void)bb;", 1),
               ("wgmma.cuh", _K6_PRODUCTS, "  (void)bb;", 1)],
}
# the fp32 linear's products (wgmma.cuh's gemm, shared with K6's tile
# products) and its split and transpose passes
LINEAR_ABLATIONS = {
    "base": [],
    "one_pass": K6_WGMMA_ABLATIONS["one_pass"][1:],
    "no_mma": K6_WGMMA_ABLATIONS["no_mma"][1:],
    "no_split": [("linear.cu", "  linear_split_kernel<<<", "  if (false) linear_split_kernel<<<",
                  3)],
}

_DENSE_SCORES = "for (int kk = 0; kk < G::KS; ++kk) {"
_DENSE_ROWS = "for (int j = 0; j < TROWS / G::KK; ++j) {"
_DENSE_BLOCKS = ("static constexpr int BLOCKS = (EW == 2 && D == 64) || (EW == 1 && D == 16)"
                 " ? 3 : 2;")
ATTENTION_VARIANTS = {
    "base": [],
    "no_copy": MLP_ABLATIONS["no_copy"],
    "no_split": MLP_ABLATIONS["no_split"],
    "one_pass": MLP_ABLATIONS["one_pass"],
    "no_scores": [("attention.cu", _DENSE_SCORES,
                   "for (int kk = 0; kk < 0; ++kk) {", 5)],
    "no_rows": [("attention.cu", _DENSE_ROWS, "for (int j = 0; j < 0; ++j) {", 4)],
    "no_exp": [("attention.cu", "sc[ni][e] = exp2f(sc[ni][e] - m[e >> 1]);",
                "sc[ni][e] = sc[ni][e] - m[e >> 1];", 1),
               ("attention.cu", "? exp2f(fmaf(sc[ni][e], c, -lr[e >> 1]))",
                "? fmaf(sc[ni][e], c, -lr[e >> 1])", 1),
               ("attention.cu", "exp2f(fmaf(st[ni][e], c, -ls[8 * ni + 2 * t + (e & 1)]))",
                "fmaf(st[ni][e], c, -ls[8 * ni + 2 * t + (e & 1)])", 1)],
    "stages3": [("attention.cu", "constexpr int DSTAGES = 2;", "constexpr int DSTAGES = 3;", 1)],
    "blocks2": [("attention.cu", _DENSE_BLOCKS, "static constexpr int BLOCKS = 2;", 1)],
    "blocks3": [("attention.cu", _DENSE_BLOCKS, "static constexpr int BLOCKS = 3;", 1)],
    "warps8": [("attention.cu", "static constexpr int WARPS = 4;",
                "static constexpr int WARPS = 8;", 1),
               ("attention.cu", _DENSE_BLOCKS, "static constexpr int BLOCKS = 1;", 1)],
}


def build_variants(lib_name: str, variants: dict, against: Path | None = None) -> dict:
    """Library ``lib_name`` built from a patched copy of ``csrc/`` per
    variant (and from the directory ``against`` as variant "against"),
    all nvcc processes at once."""
    procs = {}
    sources = {name: build.CSRC for name in variants}
    if against is not None:
        sources["against"] = against
    for name, src_dir in sources.items():
        d = OUT / lib_name / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src_dir, d)
        for file, text, new, count in variants.get(name, []) if src_dir == build.CSRC else []:
            if text is None:  # a probe source the variant includes
                shutil.copy(HERE / file, d / file)
                continue
            src = (d / file).read_text()
            if src.count(text) < count:
                raise RuntimeError(f"variant {name}: patch point gone from {file}")
            (d / file).write_text(src.replace(text, new, count))
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / f"{lib_name}.so"),
               str(d / f"{lib_name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        lib = ctypes.CDLL(str(OUT / lib_name / name / f"{lib_name}.so"))
        for fn, argtypes in build.SIGNATURES[lib_name].items():
            if not hasattr(lib, fn):  # an older tree's library
                continue
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.mp_error_string.argtypes = [ctypes.c_int]
        lib.mp_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def operands(dtype, gen, shape=SHAPE):
    m, c, h = shape

    def uniform(shape, fan_in):
        u = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
        return (u / fan_in**0.5).to(dtype)

    x = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
    return x, uniform((h, c), c), uniform((h,), c), uniform((c, h), h), uniform((c,), h)


def time_ms(fn, reps: int = 10) -> float:
    """Mean time of ``reps`` calls of ``fn`` from CUDA events, queued behind
    a sleep kernel so that the host's time to launch is not counted (as
    chip_smoke.py times its kernels)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time of the kernels one call of ``fn`` launches, over
    ``reps`` calls under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 / reps


def ablate(libs: dict, gen) -> None:
    from ..cuda_mlp import K5_LAUNCHERS

    for dtype in (torch.float32, torch.bfloat16):
        args = operands(dtype, gen)
        for name, lib in libs.items():
            ms = time_ms(lambda: K5_LAUNCHERS["mma.sync"](*args, lib=lib))
            print(f"ablate K5 {str(dtype)[6:]:8s} {name:9s} {ms:.4f} ms", flush=True)


def ablate_wgmma(libs: dict, gen) -> None:
    """K5's wgmma kernel and its ablations, fp32, at two row counts."""
    from ..cuda_mlp import K5_LAUNCHERS

    m, c, h = SHAPE
    for rows in (m, m // 2):
        args = operands(torch.float32, gen, (rows, c, h))
        for name, lib in libs.items():
            ms = time_ms(lambda: K5_LAUNCHERS["wgmma"](*args, lib=lib))
            print(f"ablate K5 wgmma M={rows} {name:10s} {ms:.4f} ms "
                  f"({4.0 * rows * c * h / ms * 1e-9:.1f} TFLOP/s)", flush=True)


def k6_kernels(gen) -> None:
    from torch.profiler import ProfilerActivity, profile

    from ..cuda_mlp import fused_mlp_bwd

    for dtype in (torch.float32, torch.bfloat16):
        x, w1, b1, w2, _ = operands(dtype, gen)
        g = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
        fused_mlp_bwd(x, w1, b1, w2, g)
        torch.cuda.synchronize()
        reps = 5
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fused_mlp_bwd(x, w1, b1, w2, g)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                name = e.key.split("::")[-1].split("<")[0]
                print(f"k6 {str(dtype)[6:]:8s} {name:30s} {e.count // reps} launches "
                      f"{e.self_device_time_total / 1e3 / reps:.4f} ms a call")


def ablate_k6_wgmma(libs: dict, gen) -> None:
    """Each kernel of K6's wgmma path, fp32, at two row counts, per variant
    of the sources (device times from torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from ..cuda_mlp import K6_LAUNCHERS

    _, c, h = SHAPE
    for rows in (SHAPE[0], 2 * SHAPE[0]):
        x, w1, b1, w2, _ = operands(torch.float32, gen, (rows, c, h))
        g = torch.randn(x.shape, generator=gen, device="cuda")
        for name, lib in libs.items():
            def run():
                K6_LAUNCHERS["wgmma"](x, w1, b1, w2, g, lib=lib)

            run()
            torch.cuda.synchronize()
            reps = 5
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    run()
                torch.cuda.synchronize()
            times = {e.key.split("::")[-1].split("(")[0]: e.self_device_time_total / 1e3 / reps
                     for e in prof.key_averages() if e.self_device_time_total > 0}
            total = sum(times.values())
            print(f"ablate K6 wgmma M={rows} {name:9s} {total:.4f} ms "
                  f"({10.0 * rows * c * h / total * 1e-9:.1f} TFLOP/s): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)


def ablate_linear(libs: dict, gen) -> None:
    """Each kernel of the fp32 linear's forward and backward at the trunks'
    qkv and proj, per variant of the sources (device times from
    torch.profiler; the split kernel's time is that of all three of its
    launches), with each product's TFLOP/s."""
    from torch.profiler import ProfilerActivity, profile

    from ..cuda_linear import linear_backward, linear_forward

    k = SHAPE[1]
    for rows in (SHAPE[0], 2 * SHAPE[0]):
        for n in (3 * k, k):
            x = torch.randn((rows, k), generator=gen, device="cuda")
            w = (torch.rand((n, k), generator=gen, device="cuda") * 2 - 1) / k**0.5
            b = torch.zeros(n, device="cuda")
            g = torch.randn((rows, n), generator=gen, device="cuda")
            flops = 2.0 * rows * n * k
            for name, lib in libs.items():
                def run():
                    linear_forward(x, w, b, lib=lib)
                    linear_backward(x, w, g, lib=lib)

                run()
                torch.cuda.synchronize()
                reps = 5
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        run()
                    torch.cuda.synchronize()
                times = {e.key.split("::")[-1].split("(")[0]:
                         e.self_device_time_total / 1e3 / reps
                         for e in prof.key_averages() if e.self_device_time_total > 0}
                products = ", ".join(
                    f"{kn[7:-7]} {flops / times[kn] * 1e-9:.1f} TFLOP/s" for kn in
                    ("linear_fwd_kernel", "linear_dx_kernel", "linear_dw_kernel") if kn in times)
                print(f"ablate linear M={rows} N={n} K={k} {name:9s} "
                      f"{sum(times.values()):.4f} ms ({products}): "
                      + ", ".join(f"{kn} {v:.4f}" for kn, v in times.items()), flush=True)


# (trunk, windows, heads, N, d) of the flagship's dense attention, B = 16
ATTENTION_SHAPES = (("rotations", 16 * 17, 8, 243, 64), ("segments", 16 * 16, 8, 243, 16))


def attention(libs: dict, gen) -> None:
    """K1 and K2 of every variant, in turns (base first and last), through
    the port's wrappers with the variant's library in place."""
    from .. import cuda_attention as ca

    order = ["base", *[n for n in libs if n != "base"], "base"]
    for trunk, b, h, n, d in ATTENTION_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda")
            q, k, v = (t.transpose(1, 2) for t in qkv.to(dtype).unbind(2))
            dout = torch.randn((b, n, h, d), generator=gen, device="cuda")
            dout = dout.to(dtype).transpose(1, 2)
            lse = torch.empty((b, h, n), dtype=torch.float32, device="cuda")
            scale = d**-0.5
            for name in order:
                build._libs["attention"] = libs[name]
                out = ca.attention_dense(q, k, v, scale, lse=lse)
                fwd = time_ms(lambda: ca.attention_dense(q, k, v, scale))
                bwd = time_ms(lambda: ca.attention_dense_bwd(q, k, v, out, dout, lse, scale))
                print(f"attention {trunk:9s} {str(dtype)[6:]:8s} {name:9s} "
                      f"K1 {fwd:.4f} ms  K2 {bwd:.4f} ms", flush=True)
    build._libs.pop("attention", None)


# (trunk, windows, heads, N, d) of the flagship's per-window attention, B = 16
PACKED_SHAPES = (("rotations", 16 * 243, 8, 17, 64), ("segments", 16 * 243, 8, 16, 16))
_PACKED_COPY = ("      mp::cp_async16(slot + (i * n + r) * P::LD + 4 * c, s + r * pitch[i]"
                " + 16 * c, true);")
_PACKED_WARPS = "static constexpr int WARPS = 4;  // a block's warps"
_PACKED_SLOTS = ("static constexpr int SLOTS = std::is_same<T, float>::value && D == 64"
                 " ? 1 : 2;")
PACKED_VARIANTS = {
    "base": [],
    "no_copy": [("attention.cu", _PACKED_COPY, "      (void)s;", 1)],
    "no_math": [("attention.cu", "        packed_fwd_window<T, D, MT>(",
                 "        if (false) packed_fwd_window<T, D, MT>(", 1),
                ("attention.cu", "        packed_bwd_window<T, D, MT>(",
                 "        if (false) packed_bwd_window<T, D, MT>(", 1)],
    "one_pass": MLP_ABLATIONS["one_pass"],
    "slots1": [("attention.cu", _PACKED_SLOTS, "static constexpr int SLOTS = 1;", 1)],
    "slots2": [("attention.cu", _PACKED_SLOTS, "static constexpr int SLOTS = 2;", 1)],
    "slots3": [("attention.cu", _PACKED_SLOTS, "static constexpr int SLOTS = 3;", 1)],
    "warps2": [("attention.cu", _PACKED_WARPS, _PACKED_WARPS.replace("4;", "2;"), 1)],
    "warps8": [("attention.cu", _PACKED_WARPS, _PACKED_WARPS.replace("4;", "8;"), 1)],
    "recompute": [("packed_recompute.cuh", None, None, 0),
                  ("attention.cu", "// K4: each warp walks windows through its ring.",
                   '#include "packed_recompute.cuh"\n\n'
                   "// K4: each warp walks windows through its ring.", 1),
                  ("attention.cu", "        packed_bwd_window<T, D, MT>(",
                   "        packed_bwd_window_recompute<T, D, MT>(", 1),
                  ("attention.cu", "packed_warp_words<T, D>(N, 4, true)",
                   "packed_warp_words<T, D>(N, 4, false)", 1),
                  ("attention.cu", "packed_warp_words<T, D>(n, bwd ? 4 : 3, bwd)",
                   "packed_warp_words<T, D>(n, bwd ? 4 : 3, false)", 1)],
}


def packed_shape(lib, dtype, d: int, n: int, backward: bool) -> str:
    """A variant's K3 or K4 launch shape, or "-" for a library without the
    query (an older tree's)."""
    from ..cuda_attention import KERNEL_DTYPES

    if not hasattr(lib, "mp_attention_packed_shape"):
        return "-"
    shape = (ctypes.c_int * 5)()
    err = lib.mp_attention_packed_shape(KERNEL_DTYPES[dtype], d, n, int(backward), 1 << 30,
                                        torch.cuda.current_device(), ctypes.addressof(shape))
    if err:
        raise RuntimeError(f"mp_attention_packed_shape: CUDA error {err}")
    return f"{shape[0]}w x {shape[1]}s x {shape[2]}b/SM"


def packed(libs: dict, gen) -> None:
    """K3 and K4 of every variant, in turns, through the port's wrappers
    with the variant's library in place."""
    from .. import cuda_attention as ca

    against = ["against"] if "against" in libs else []
    others = [n for n in libs if n not in ("base", "against")]
    order = ["base", *against, *others, *against, "base"]
    for trunk, b, h, n, d in PACKED_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda")
            q, k, v = (t.transpose(1, 2) for t in qkv.to(dtype).unbind(2))
            dout = torch.randn((b, n, h, d), generator=gen, device="cuda")
            dout = dout.to(dtype).transpose(1, 2)
            scale = d**-0.5
            for name in order:
                build._libs["attention"] = libs[name]
                line = []
                for kind, fn, backward in (
                        ("K3", lambda: ca.attention_packed(q, k, v, scale), False),
                        ("K4", lambda: ca.attention_packed_bwd(q, k, v, dout, scale), True)):
                    line.append(f"{kind} {time_ms(fn, reps=20):.4f} ms, device "
                                f"{device_ms(fn):.4f} "
                                f"({packed_shape(libs[name], dtype, d, n, backward)})")
                print(f"packed {trunk:9s} {str(dtype)[6:]:8s} {name:9s} " + "  ".join(line),
                      flush=True)
    build._libs.pop("attention", None)


def rel64(got, ref) -> float:
    return ((got.double() - ref).norm() / ref.norm()).item()


def bf16_attention_errors(kind: str, qkv, dout, scale: float) -> dict:
    """{output: (kernel error, plain error)}: the relative error in norm
    against fp64 from the same bf16 values of K1 + K2 (``dense``) or K3 +
    K4 (``packed``) and of their plain versions, on bf16 views of one qkv
    tensor (b, n, 3, h, d) and an output gradient ``dout`` (b, h, n, d)
    laid out as the kernels' outputs (strides of (b, n, h, d)). The check
    that the kernels keep P and dS at fp32 accuracy (chip_smoke.py,
    tests/test_torch_port_cuda.py) holds the first against the second."""
    from manipose_tpu_torch.ops import cuda_attention as ca

    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, dout))
    p = torch.softmax(q64 @ k64.transpose(-1, -2) * scale, -1)
    dp = do64 @ v64.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    want = [p @ v64, ds @ k64 * scale, ds.transpose(-1, -2) @ q64 * scale,
            p.transpose(-1, -2) @ do64]
    del p, dp, ds
    if kind == "dense":
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        out = ca.attention_dense(q, k, v, scale, lse=lse)
        grads = ca.attention_dense_bwd(q, k, v, out, dout, lse, scale)
    else:
        out = ca.attention_packed(q, k, v, scale)
        grads = ca.attention_packed_bwd(q, k, v, dout, scale)
    got = [out] + [t.transpose(1, 2) for t in grads.unbind(2)]
    plain = [ca.attention_plain(q, k, v, scale), *ca.attention_plain_bwd(q, k, v, dout, scale)]
    return {name: (rel64(g, w), rel64(pl, w))
            for name, g, pl, w in zip(("out", "dq", "dk", "dv"), got, plain, want)}


def bf16_attention(kind: str, b: int, h: int, n: int, d: int, gen) -> None:
    """:func:`bf16_attention_errors` at one shape, printed."""
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").bfloat16()
    dout = torch.randn((b, n, h, d), generator=gen, device="cuda").bfloat16().transpose(1, 2)
    errs = bf16_attention_errors(kind, qkv, dout, d**-0.5)
    print(f"bf16 {kind} attention {b}*{h} x {n} x {d}: " + ", ".join(
        f"{name} kernel {kernel:.3e} plain {plain:.3e}"
        for name, (kernel, plain) in errs.items()), flush=True)


def bf16_mlp(m: int, c: int, h: int, gen) -> None:
    """K5 + K6 on bf16 operands against fp64 from the same bf16 values."""
    import math

    from manipose_tpu_torch.ops import cuda_mlp as cm

    x, w1, b1, w2, b2 = operands(torch.bfloat16, gen, (m, c, h))
    g = torch.randn((m, c), generator=gen, device="cuda").bfloat16()
    x64, w164, b164, w264, g64 = (t.double() for t in (x, w1, b1, w2, g))
    a = x64 @ w164.t() + b164
    cdf = 0.5 * (1 + torch.erf(a / math.sqrt(2)))
    hh = a * cdf
    da = (g64 @ w264) * (cdf + a * torch.exp(-0.5 * a * a) / math.sqrt(2 * math.pi))
    want = [hh @ w264.t() + b2.double(), da @ w164, da.t() @ x64, da.sum(0),
            g64.t() @ hh, g64.sum(0)]
    got = [cm.fused_mlp(x, w1, b1, w2, b2), *cm.fused_mlp_bwd(x, w1, b1, w2, g)]
    plain = [cm.mlp_plain(x, w1, b1, w2, b2), *cm.mlp_plain_bwd(x, w1, b1, w2, g)]
    print(f"bf16 mlp M {m} C {c} H {h}: " + ", ".join(
        f"{name} kernel {rel64(gt, w):.3e} plain {rel64(pl, w):.3e}"
        for name, gt, pl, w in zip(("out", "dx", "dw1", "db1", "dw2", "db2"), got, plain, want)),
        flush=True)


def bf16_accuracy(gen) -> None:
    b, l, j, s = 16, 243, 17, 16
    bf16_attention("dense", b * j, 8, l, 64, gen)
    bf16_attention("dense", b * s, 8, l, 16, gen)
    bf16_attention("packed", b * l, 8, j, 64, gen)
    bf16_attention("packed", b * l, 8, s, 16, gen)
    bf16_mlp(b * l * j, 512, 1024, gen)
    bf16_mlp(b * l * s, 128, 256, gen)


def busy_share(fn) -> tuple:
    """(wall ms, device busy ms) of one call of ``fn`` under torch.profiler,
    device activity only."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return wall, busy


def eval_pinning() -> None:
    import threading
    import time

    import numpy as np

    from ...config import load_config
    from ...data import Batch
    from ...drivers import instantiate_model
    from ...eval.engine import EvalConfig, evaluate
    from ...geometry import h36m_skeleton_17

    rng = np.random.default_rng(0)
    last = np.asarray([1.0] * 4 + [0.0] * 6, np.float32)
    batches = [Batch(rng.normal(size=(10, 243, 17, 2)).astype(np.float32),
                     (0.3 * rng.normal(size=(10, 243, 17, 3))).astype(np.float32),
                     last if i == 6 else np.ones(10, np.float32)) for i in range(7)]
    frames = 64 * 243
    skeleton = h36m_skeleton_17()
    pin = Batch.pin_memory

    def on_consumer(self):  # the prefetch thread's batches stay unpinned
        return pin(self) if threading.current_thread() is threading.main_thread() else self

    variants = {"producer": pin, "consumer": on_consumer}
    for dtype in ("float32", "bfloat16"):
        model = instantiate_model(load_config("config", [f"model.dtype={dtype}"]),
                                  skeleton)[0].cuda()

        def run():
            evaluate(model, batches, skeleton, EvalConfig())

        run()
        try:
            for name in ("producer", "consumer", "consumer", "producer") * 2:
                Batch.pin_memory = variants[name]
                t0 = time.perf_counter()
                run()
                sec = time.perf_counter() - t0
                print(f"pinning {dtype:8s} {name:8s} {frames / sec:.1f} frames/s "
                      f"({sec:.3f} s)", flush=True)
            for name in variants:
                Batch.pin_memory = variants[name]
                wall, busy = busy_share(run)
                print(f"pinning {dtype:8s} {name:8s} profiled: wall {wall:.2f} ms, device "
                      f"busy {busy:.2f} ms ({100 * busy / wall:.1f} %)", flush=True)
        finally:
            Batch.pin_memory = pin


SECTIONS = ("mma_rate", "accumulate", "ablate", "wgmma", "k6", "k6wgmma", "linear", "attention",
            "packed", "bf16", "pinning")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sections", nargs="*", help=f"any of {', '.join(SECTIONS)} (all)")
    parser.add_argument("--against", type=Path, default=None,
                        help="a csrc directory whose attention kernels (attention, "
                             "packed) to time too")
    args = parser.parse_args()
    if set(args.sections) - set(SECTIONS):
        parser.error(f"sections are {', '.join(SECTIONS)}")
    sections = args.sections or SECTIONS
    if not torch.cuda.is_available():
        print("run_probes: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    for tool in ("mma_rate", "accumulate"):
        if tool in sections:
            run_tool(tool)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "ablate" in sections:
        ablate(build_variants("mlp", MLP_ABLATIONS), gen)
    if "wgmma" in sections:
        ablate_wgmma(build_variants("mlp", WGMMA_ABLATIONS), gen)
    if "k6" in sections:
        k6_kernels(gen)
    if "k6wgmma" in sections:
        ablate_k6_wgmma(build_variants("mlp", K6_WGMMA_ABLATIONS), gen)
    if "linear" in sections:
        ablate_linear(build_variants("linear", LINEAR_ABLATIONS), gen)
    if "attention" in sections:
        attention(build_variants("attention", ATTENTION_VARIANTS, args.against), gen)
    if "packed" in sections:
        packed(build_variants("attention", PACKED_VARIANTS, args.against), gen)
    if "bf16" in sections:
        bf16_accuracy(gen)
    if "pinning" in sections:
        eval_pinning()
    return 0


if __name__ == "__main__":
    sys.exit(main())
