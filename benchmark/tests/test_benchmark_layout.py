"""The harness finds every cell's files by name, and a cell is added by
adding files; BENCHMARK.json keeps to the contract's names and units."""

import json
import re
import shutil

import pytest

import tiny
from harness import core, yardstick

ROOT = core.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = core.Cell.find(name)
    assert cell.config["name"] == next(w["config"] for w in SPEC["workloads"] if w["name"] == name)
    assert callable(cell.driver().run)
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))
        assert any(e["name"] == m["moves"] for e in cell.end_to_end)


def test_names_units_and_files_keep_to_the_contract():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]] + [c["name"] for c in SPEC["configs"]]
    names += [w["traffic"] for w in SPEC["workloads"]] + [k for c in SPEC["configs"]
                                                          for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    assert all(m["source"] in ("host_clock", "device_trace") for m in SPEC["end_to_end"])
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all("\n" not in x and "\t" not in x and 0 < len(x) <= 200 for x in layers)
    for path in (ROOT / "benchmark").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(ROOT).as_posix()
            assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", rel), rel
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")


def test_kernel_classes_map_every_port_kernel():
    classes = yardstick.kernel_classes(str(ROOT / "benchmark" / "kernels"))
    # the device kernels of manipose_tpu_torch/ops/csrc, as the profiler names them
    names = {
        "void attention_dense_kernel<64, float>(Params)": "attention_dense",
        "void attention_dense_bwd_dq_kernel<64, float>(P)": "attention_dense_bwd",
        "void attention_dense_bwd_dkv_kernel<16, float>(P)": "attention_dense_bwd",
        "void attention_packed_kernel<64, float, 1, 2>(P)": "attention_packed",
        "void attention_packed_bwd_kernel<64, float>(P)": "attention_packed_bwd",
        "void fused_mlp_kernel<float>(P)": "fused_mlp",
        "void fused_mlp_bwd_rows_kernel<float>(P)": "fused_mlp_bwd",
        "void fused_mlp_bwd_gemm_kernel<float>(P)": "fused_mlp_bwd",
        "void fused_mlp_bwd_reduce_kernel<float>(P)": "fused_mlp_bwd",
        "nvjet_tst_128x64_64x4_1x2_h_bz_TNT": None,
        "void at::native::vectorized_elementwise_kernel<4>(...)": None,
    }
    for name, op in names.items():
        assert yardstick.op_of(name, classes) == op, name


def test_a_cell_is_added_by_adding_files(tmp_path):
    """A new cell (its entry and a new mix file) runs with no edit to any
    file the harness has."""
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "h36m-lift-videos-b4", "config": "manipose-h36m-243",
                              "traffic": "lift-videos-b4", "chips": 1,
                              "why": "the lift mix at 4 windows a batch"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "h36m-lift-videos" in m.get("workloads", []):
            m["workloads"].append("h36m-lift-videos-b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    mix = json.loads((bench / "mixes" / "lift-videos.json").read_text())
    mix["batch_size"] = 4
    (bench / "mixes" / "lift-videos-b4.json").write_text(json.dumps(mix))
    cell = core.Cell.find("h36m-lift-videos-b4", root=tmp_path, bench_dir=bench)
    assert cell.mix["batch_size"] == 4 and [m["name"] for m in cell.end_to_end] == [
        "frames_per_s", "setup_s"]
    small = tiny.tiny(cell)
    small.mix["batch_size"] = 4
    line = tiny.run(small)
    assert line["correct"] and set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert list(line)[-1] == "checks"


def _files(bench):
    return {p.relative_to(bench).as_posix(): p.read_bytes() for p in bench.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_configuration_of_another_architecture_is_added_by_adding_files(tmp_path, monkeypatch):
    """The port's plain MixSTE (``tests/mixste_arch.py`` as ``archs/mixste.py``),
    a configuration of it and two cells on the existing lift and training
    mixes run to correct with no edit to any file the harness has; with
    half of each batch left out, the training cell is not correct."""
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench, ignore=shutil.ignore_patterns("__pycache__"))
    had = _files(bench)
    shutil.copy(bench / "tests" / "mixste_arch.py", bench / "archs" / "mixste.py")
    cfg = json.loads((bench / "configs" / "manipose-h36m-243.json").read_text())
    del cfg["multi_hyp"]
    cfg.update(name="mixste-h36m-243", source="https://arxiv.org/abs/2203.09159",
               overrides=cfg["overrides"] + ["model.arch=mixste"],
               model=dict(arch="mixste", layers=8, channels=512, nheads=8, drop_path_rate=0.1,
                          mlp_ratio=2.0, dtype="float32", layout="fold", mup=False))
    (bench / "configs" / "mixste-h36m-243.json").write_text(json.dumps(cfg))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "mixste-h36m-243", "source": cfg["source"],
                            "file": "benchmark/configs/mixste-h36m-243.json", "reduced": [],
                            "why": "MixSTE alone: one trunk, one hypothesis"})
    cells = {"mixste-lift-videos": ("lift-videos", "h36m-lift-videos"),
             "mixste-train-b16": ("train-b16", "h36m-train-b16")}
    for name, (traffic, like) in cells.items():
        spec["workloads"].append({"name": name, "config": "mixste-h36m-243",
                                  "traffic": traffic, "chips": 1, "why": f"{like} on MixSTE"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    found = {n: core.Cell.find(n, root=tmp_path, bench_dir=bench) for n in cells}
    assert all(c.arch().__file__ == str(bench / "archs" / "mixste.py") for c in found.values())
    for name, cell in found.items():
        line = tiny.run(tiny.tiny(cell))
        assert line["correct"], (name, line["checks"])
        assert line["failed"] == 0 and line["attempted"] > 0
    from manipose_tpu_torch.train import step as step_mod

    make = step_mod.make_train_step

    def halved(*a, **k):
        inner = make(*a, **k)

        def step(state, x, y, lr, n_valid=None):
            return inner(state, x[: len(x) // 2], y[: len(y) // 2], lr)

        return step

    monkeypatch.setattr(step_mod, "make_train_step", halved)
    line = tiny.run(tiny.tiny(found["mixste-train-b16"]))
    assert not line["correct"]
    assert line["checks"]["loss_gap"]["value"] > line["checks"]["loss_gap"]["limit"]
    now = _files(bench)
    assert {k: now[k] for k in had} == had


@pytest.mark.parametrize("name", sorted(p.stem for p in (ROOT / "benchmark" / "configs").glob("*.json")))
def test_config_files_state_what_the_port_runs(name):
    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.data.dhp3 import dhp3_skeleton
    from manipose_tpu_torch.geometry import h36m_skeleton_17

    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    port = load_config("config", cfg["overrides"])
    for group in ("model", "multi_hyp", "data"):
        for key, value in cfg[group].items():
            if key in port[group]:
                assert port[group][key] == value, (group, key)
    skel = dhp3_skeleton() if cfg["data"]["dataset"] == "3dhp" else h36m_skeleton_17()
    s = cfg["skeleton"]
    assert tuple(s["parents"]) == skel.parents
    assert tuple(s["joints_left"]) == skel.joints_left
    assert tuple(s["joints_right"]) == skel.joints_right
    assert tuple(tuple(t) for t in s["t_pose"]) == tuple(skel.t_pose_operators)
