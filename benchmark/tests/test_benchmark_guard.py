"""What a run may load and where it may run: the import guard compares
top-level names whole, the yardstick imports nothing of the program, and
a run prints no result without a card or outside a whole checkout."""

import json
import os
import shutil
import subprocess
import sys

from harness import core

ROOT = str(core.ROOT)


def test_guard_compares_top_level_names_whole():
    assert core.forbidden_loaded(["manipose_tpu_torch", "manipose_tpu_torch.ops",
                                  "numpy", "jaxtyping", "flaxen.x"]) == []
    assert core.forbidden_loaded(["manipose_tpu.ops.pallas", "jax._src", "jaxlib",
                                  "flax.linen", "torch"]) == ["flax", "jax", "jaxlib",
                                                              "manipose_tpu"]


def test_the_yardstick_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [{b!r}, {r!r}]\n"
            "import harness.reference, harness.synth, harness.weights, harness.yardstick, "
            "harness.checks, harness.tracing, harness.readers, archs.rmcl_manifold\n"
            "bad = sorted({{m.split('.')[0] for m in sys.modules}} & "
            "{{'manipose_tpu_torch', 'manipose_tpu', 'jax', 'jaxlib', 'flax'}})\n"
            "assert not bad, bad\n").format(b=os.path.join(ROOT, "benchmark"), r=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "h36m-lift-videos",
                           "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def _no_result(out: str) -> bool:
    for line in out.splitlines():
        try:
            if "correct" in json.loads(line):
                return False
        except (ValueError, TypeError):
            continue
    return True


def test_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = _run(ROOT, env)
    assert res.returncode != 0 and _no_result(res.stdout)
    assert "needs 1 CUDA device" in res.stderr


def test_no_result_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(str(tmp_path))
    assert res.returncode != 0 and _no_result(res.stdout)
