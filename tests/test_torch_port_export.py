"""The port's ``Predictor.export_program`` / ``load_program``
(``torch.export``) on the CPU, at the sizes of ``tests/test_serving.py``.

The JAX package exports an XLA twin as StableHLO
(``Predictor.export_stablehlo``); the port's program keeps its kernels as
the ``manipose::`` operators and runs their plain versions on the CPU, so
the program and the live forward compute the same products in the same
order. The tolerance is the JAX package's export tolerance, 1e-5
(``tests/test_serving.py::TestStableHLOExport``), of the output's
magnitude.
"""

import numpy as np
import pytest
import torch

from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.serving import Predictor

OVERRIDES = [
    "data.seq_len=9",
    "model.layers=2", "model.channels=32", "model.nheads=4",
    "model.layers_seg=2", "model.channels_seg=16", "model.nheads_seg=4",
    "multi_hyp.n_hyp=2",
]
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _live(predictor, x):
    with torch.no_grad():
        return predictor.serving_forward(torch.from_numpy(x))


def _close(got, want):
    assert got.shape == want.shape
    atol = TOL * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def rmcl():
    return Predictor(cfg=load_config("config", OVERRIDES), batch_size=3, tta=True,
                     device="cpu")


@pytest.fixture(scope="module")
def int8_mixste():
    """An int8 MixSTE predictor (no hypotheses) and its fixed-batch program."""
    cfg = load_config("config", OVERRIDES + ["model.arch=mixste"])
    pred = Predictor(cfg=cfg, batch_size=3, tta=True, quantize="force", device="cpu")
    return pred, Predictor.load_program(pred.export_program(batch_symbolic=False))


def test_export_round_trip_symbolic_batch(rmcl, tmp_path):
    """One program, written to a file, reproduces the live forward (model,
    hypothesis aggregation, TTA) at several batch sizes, one window
    included."""
    path = tmp_path / "manipose.pt2"
    data = rmcl.export_program(path)
    assert path.stat().st_size == len(data) > 10_000
    program = Predictor.load_program(path)
    rng = np.random.default_rng(7)
    for b in (3, 5, 1):
        x = rng.normal(size=(b, 9, 17, 2)).astype(np.float32)
        got, want = program(x), _live(rmcl, x)
        assert got[0].shape == (b, 9, 17, 3) and got[1].shape == (b, 2, 9, 17, 3)
        for g, w in zip(got, want):
            _close(g, w)


def test_export_returns_none_legs_without_hypotheses(int8_mixste):
    pred, program = int8_mixste
    x = np.random.default_rng(8).normal(size=(3, 9, 17, 2)).astype(np.float32)
    poses, hyps, scores = program(x)
    assert poses.shape == (3, 9, 17, 3) and hyps is None and scores is None


def test_int8_export_matches_the_live_int8_forward(int8_mixste):
    pred, program = int8_mixste
    assert pred.quantized
    x = np.random.default_rng(9).normal(size=(3, 9, 17, 2)).astype(np.float32)
    _close(program(x)[0], _live(pred, x)[0])


def test_fixed_batch_refuses_another_batch_size(int8_mixste):
    _, program = int8_mixste
    with pytest.raises(Exception):
        program(np.zeros((4, 9, 17, 2), np.float32))


def test_operators_fake_outputs_match_the_real_ones():
    """The ``manipose::`` operators' fake versions (what torch.export
    traces) give the real outputs' shapes and strides; K1 and K3 return a
    (B, h, N, d) view of a (B, N, h, d) tensor on both devices."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn((2, 17, 3, 4, 8), generator=gen)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    x = torch.randn((34, 64), generator=gen)
    w1, b1 = torch.randn((128, 64), generator=gen), torch.randn((128,), generator=gen)
    w2, b2 = torch.randn((64, 128), generator=gen), torch.randn((64,), generator=gen)
    calls = [(torch.ops.manipose.attention_dense, (q, k, v, 0.5)),
             (torch.ops.manipose.attention_packed, (q, k, v, 0.5)),
             (torch.ops.manipose.mlp_forward, (x, w1, b1, w2, b2))]
    for op, args in calls:
        real = op(*args)
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                        for a in args))
        assert fake.shape == real.shape and fake.stride() == real.stride(), op
    assert calls[0][0](q, k, v, 0.5).stride() == (17 * 4 * 8, 8, 4 * 8, 1)


def test_entry_points_refuse_other_devices():
    """``attention`` and ``fused_mlp`` refuse a device that is neither the
    CPU nor a card before they reach an operator, whose fake version would
    otherwise answer for it."""
    from manipose_tpu_torch.ops.cuda_attention import attention
    from manipose_tpu_torch.ops.cuda_mlp import fused_mlp

    with pytest.raises(ValueError):
        attention(torch.empty((2, 17, 3 * 4 * 8), device="meta"), 4, 1.0)
    x = torch.empty((8, 64), device="meta")
    with pytest.raises(ValueError):
        fused_mlp(x, torch.empty((128, 64), device="meta"), torch.empty(128, device="meta"),
                  torch.empty((64, 128), device="meta"), torch.empty(64, device="meta"))
