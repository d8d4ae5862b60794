"""Probes of the fused-MLP kernels on the card: what bounds them.

Run from the repository root on a machine with an H100 and the CUDA
toolkit: ``python3 -m manipose_tpu_torch.ops.probes.run_probes``. It
builds into ``build/probes/`` and prints:

1. ``mma_rate``: the peak rate of mma.sync tf32 and bf16 on register
   operands (``mma_rate.cu``).
2. ``accumulate``: the error of fp32 products on the tensor cores against
   fp64, for the accumulation schemes of ``accumulate.cu``.
3. ``ablate``: K5 at the flagship's rotations-trunk shape (M 66096, C 512,
   H 1024), fp32 and bf16, built from ``csrc/`` as it is and with one part
   of the work taken out of a copy of the sources (the numbers of a variant
   are wrong by design; only its time is read): ``one_pass`` (one tf32
   pass instead of three), ``no_split`` (operands passed unsplit),
   ``no_copy`` (no cp.async copies), ``no_fc1`` and ``no_fc2`` (the
   products of one of K5's two GEMMs skipped).
4. ``k6``: the device time of each of K6's kernels at the same shape, from
   ``torch.profiler``.

The ablation patches the sources by text and stops if a patch point is
gone; update the patches with the kernels.
"""

from __future__ import annotations

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
ABLATIONS = {
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


def build_variants() -> dict:
    procs = {}
    for name, patches in ABLATIONS.items():
        d = OUT / "ablate" / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        for file, text, new, count in patches:
            src = (d / file).read_text()
            if src.count(text) < count:
                raise RuntimeError(f"ablation {name}: patch point gone from {file}")
            (d / file).write_text(src.replace(text, new, count))
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / "mlp.so"), str(d / "mlp.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablation {name} failed to build:\n{log}")
        lib = ctypes.CDLL(str(OUT / "ablate" / name / "mlp.so"))
        for fn, argtypes in build.SIGNATURES["mlp"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def operands(dtype, gen):
    m, c, h = SHAPE

    def uniform(shape, fan_in):
        u = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
        return (u / fan_in**0.5).to(dtype)

    x = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
    return x, uniform((h, c), c), uniform((h,), c), uniform((c, h), h), uniform((c,), h)


def time_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ablate(libs: dict, gen) -> None:
    from ..cuda_mlp import KERNEL_DTYPES

    m, c, h = SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        x, w1, b1, w2, b2 = operands(dtype, gen)
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        for name, lib in libs.items():
            def run():
                err = lib.mp_fused_mlp(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                       w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                                       KERNEL_DTYPES[dtype], m, c, h, 0, stream)
                if err:
                    raise RuntimeError(f"ablation {name}: CUDA error {err}")

            print(f"ablate K5 {str(dtype)[6:]:8s} {name:9s} {time_ms(run):.4f} ms",
                  flush=True)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("run_probes: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    run_tool("mma_rate")
    run_tool("accumulate")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ablate(build_variants(), gen)
    k6_kernels(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
