"""The yardstick's work counts: K1-K6's bound times as PERF.md's kernel
table gives them (chip_smoke.py's arithmetic), the model's FLOPs, and the
kernel launches a forward and a step make."""

import pytest

from archs import rmcl_manifold
from harness import yardstick

CFG_243 = {"model": dict(layers=8, channels=512, nheads=8, layers_seg=2, channels_seg=128,
                         nheads_seg=8, rot_dim=6, mlp_ratio=2.0, dtype="float32"),
           "multi_hyp": {"n_hyp": 5}, "data": {"seq_len": 243},
           "skeleton": {"parents": [-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 9, 8, 11, 12, 8, 14, 15]}}
CFG_27 = dict(CFG_243, data={"seq_len": 27})

# PERF.md's kernel table (PRs 1-11): op, shape, dtype, bound ms
BOUNDS = [
    ("attention_dense", (272 * 8, 243, 64), "float32", 0.1994),
    ("attention_dense", (272 * 8, 243, 64), "bfloat16", 0.0808),
    ("attention_dense", (256 * 8, 243, 16), "float32", 0.0469),
    ("attention_dense_bwd", (272 * 8, 243, 64), "float32", 0.4984),
    ("attention_dense_bwd", (272 * 8, 243, 64), "bfloat16", 0.1623),
    ("attention_dense_bwd", (256 * 8, 243, 16), "bfloat16", 0.0386),
    ("attention_packed", (3888 * 8, 17, 64), "float32", 0.1616),
    ("attention_packed", (3888 * 8, 16, 16), "bfloat16", 0.0190),
    ("attention_packed", (17 * 8, 27, 64), "float32", 0.0011),
    ("attention_packed_bwd", (3888 * 8, 17, 64), "float32", 0.2829),
    ("attention_packed_bwd", (425 * 8, 27, 64), "bfloat16", 0.0246),
    ("fused_mlp", (66096, 512, 1024), "float32", 0.8401),
    ("fused_mlp", (62208, 128, 256), "bfloat16", 0.0095),
    ("fused_mlp", (459, 512, 1024), "float32", 0.0058),
    ("fused_mlp_bwd", (66096, 512, 1024), "float32", 2.1002),
    ("fused_mlp_bwd", (11475, 512, 1024), "bfloat16", 0.0608),
]


@pytest.mark.parametrize("op,shape,dtype,ms", BOUNDS)
def test_bound_times_match_the_kernel_table(op, shape, dtype, ms):
    flops, n_bytes = yardstick.work(op, shape, dtype)
    assert round(yardstick.bound_s(flops, n_bytes, dtype) * 1e3, 4) == pytest.approx(ms, abs=1e-4)


def test_model_flops_of_a_flagship_window():
    # about 72.7 MFLOP a token (16 rotation blocks of 16 d^2 FLOPs a token,
    # attention, the segments trunk): 3.0e11 for one 243-frame window
    flops = rmcl_manifold.model_flops(CFG_243, 1)
    assert flops / (243 * 17) == pytest.approx(72.7e6, rel=0.03)
    assert rmcl_manifold.model_flops(CFG_243, 8) == pytest.approx(8 * flops)


@pytest.mark.parametrize("cfg,windows,backward,want", [
    # the port's launch counters: a flagship forward launches K1 10, K3 10, K5 20
    (CFG_243, 16, False, {"attention_dense": 10, "attention_packed": 10, "fused_mlp": 20}),
    (CFG_243, 16, True, {"attention_dense": 10, "attention_packed": 10, "fused_mlp": 20,
                         "attention_dense_bwd": 10, "attention_packed_bwd": 10,
                         "fused_mlp_bwd": 20}),
    # at L = 27 every attention runs per window: K1/K2 launch 0 times
    (CFG_27, 1, False, {"attention_packed": 20, "fused_mlp": 20}),
])
def test_kernel_ops_count_the_launches(cfg, windows, backward, want):
    got = {}
    for (op, _), n in rmcl_manifold.kernel_ops(cfg, windows, backward).items():
        got[op] = got.get(op, 0) + n
    assert got == want


def test_kernel_ops_shapes_at_the_stream_window():
    ops = rmcl_manifold.kernel_ops(CFG_27, 1, False)
    assert ops[("fused_mlp", (459, 512, 1024))] == 16
    assert ops[("attention_packed", (17 * 8, 27, 64))] == 8
