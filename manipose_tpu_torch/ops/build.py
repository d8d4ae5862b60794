"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into ``build/kernels/<name>-<hash>.so`` under the repository root (listed
in ``.gitignore``), keyed by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is loaded as is. Every library has a
plain C interface: pointers and the stream travel as ``c_void_p`` and
every entry point returns ``cudaGetLastError()`` after its launch.

Nothing is built at import: the first wrapper call on a CUDA tensor builds
the library it needs, and :func:`build_all` builds every library at once,
one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# entry point -> argtypes, per library
SIGNATURES: Dict[str, Dict[str, list]] = {
    "attention": {
        # q, k, v, out, lse, dtype, B, H, N, D, stride_b, stride_h,
        # stride_n, scale, device, stream
        "mp_attention_dense": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _L, _L, _L, _F, _I, _P],
        # q, k, v, out, dtype, B, L, H, N, D, q/k/v strides (b, l, h, n),
        # out strides (b, l, h, n), scale, device, stream
        "mp_attention_packed": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I]
                               + [_L] * 8 + [_F, _I, _P],
        # q, k, v, out, dout, lse, delta, dq, dk, dv, dtype, B, H, N, D,
        # q/k/v strides (b, h, n), out/dout strides, dq/dk/dv strides,
        # scale, device, stream
        "mp_attention_dense_bwd": [_P] * 10 + [_I] * 5 + [_L] * 9
                                  + [_F, _I, _P],
        # q, k, v, dout, dq, dk, dv, dtype, B, L, H, N, D, q/k/v strides
        # (b, l, h, n), dout strides, dq/dk/dv strides, scale, device, stream
        "mp_attention_packed_bwd": [_P] * 7 + [_I] * 6 + [_L] * 12
                                   + [_F, _I, _P],
        # dtype, D, N, backward, windows, device, int[5] out
        "mp_attention_packed_shape": [_I] * 6 + [_P],
    },
    "mlp": {
        # x, w1, b1, w2, b2, out, dtype, M, C, H, device, stream
        "mp_fused_mlp": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # x, w1, b1, w2, b2, out, w1p, w2p (scratch), M, H, device, stream
        "mp_fused_mlp_sm90": [_P] * 8 + [_I, _I, _I, _P],
        # x, g, w1, b1, w2, dx, da, h, colsum, part, grads, dtype, M, C,
        # H, S, device, stream
        "mp_fused_mlp_bwd": [_P] * 11 + [_I] * 6 + [_P],
        # x, g, w1, b1, w2, dx, planes, wp, colsum, part, grads, M, H, S,
        # device, stream
        "mp_fused_mlp_bwd_sm90": [_P] * 11 + [_I] * 4 + [_P],
    },
    "fusion": {
        # x_st, x_ts, w, b, out, alpha, R, C, blocks, device, stream
        "mp_stream_fusion": [_P] * 6 + [_I] * 4 + [_P],
        # g, x_st, x_ts, alpha, w, dx_st, dx_ts, dw, db, part, R, C, blocks,
        # device, stream
        "mp_stream_fusion_bwd": [_P] * 10 + [_I] * 4 + [_P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.name == f"{name}.cu" or src.suffix == ".cuh":
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, target: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def _finish(name: str, target: Path, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, target)
    target.with_suffix(".log").write_text(log)
    return log


def build_all() -> Dict[str, str]:
    """Build every library whose target is missing, one ``nvcc`` per
    source in parallel. Returns {name: nvcc log} for what was built."""
    with _lock:
        jobs = {}
        for name in SIGNATURES:
            target = _target(name)
            if not target.exists():
                jobs[name] = (target, _start(name, target))
        logs = {}
        try:
            for name, (target, proc) in jobs.items():
                logs[name] = _finish(name, target, proc)
        finally:
            for _, proc in jobs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if its target is missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        target = _target(name)
        if not target.exists():
            _finish(name, target, _start(name, target))
        lib = ctypes.CDLL(str(target))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.mp_error_string.argtypes = [ctypes.c_int]
        lib.mp_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if err != 0:
        msg = lib.mp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
