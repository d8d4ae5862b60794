"""The port's spans (``manipose_tpu_torch.utils.profiling``): the ring and
its totals, nesting across the prefetch thread, annotations only under a
profiler and on its clock, and the spans that serving, the data pipeline
and the train step record, with their counts. One test needs the card
(marked ``cuda``): a span around a kernel's launch and a synchronisation
encloses the kernel on the profiler's device timeline. This file imports
no JAX, so the card runs it with ``--noconftest``."""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.data import PoseSequenceDataset, SequenceLoader, prefetch
from manipose_tpu_torch.drivers import instantiate_model
from manipose_tpu_torch.geometry import h36m_skeleton_17
from manipose_tpu_torch.serving import Predictor
from manipose_tpu_torch.train import LossConfig, TrainState, make_optimizer, make_train_step
from manipose_tpu_torch.utils import profiling

# the sizes of tests/test_serving.py
OVERRIDES = [
    "data.seq_len=9",
    "model.layers=2", "model.channels=32", "model.nheads=4",
    "model.layers_seg=2", "model.channels_seg=16", "model.nheads_seg=4",
    "multi_hyp.n_hyp=2",
]
SEQ_LEN = 9


@pytest.fixture(autouse=True)
def fresh_spans():
    profiling.reset()
    yield
    profiling.reset()


def _named(name, records=None):
    return [r for r in (profiling.spans() if records is None else records) if r.name == name]


def _within(inner, outer):
    """``inner`` ran inside ``outer`` on the same thread: a span's parent
    and request (the outermost span around it) follow from its times."""
    return (inner.thread == outer.thread
            and outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns)


def _manipose_events(prof, name):
    return sorted((e for e in prof.profiler.kineto_results.events()
                   if e.name() == "manipose." + name
                   and e.device_type() == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.start_ns())


def test_the_ring_keeps_the_newest_and_the_totals_keep_all():
    rec = profiling.SpanRecorder(size=4)
    for i in range(10):
        with rec.span("a", n=2, i=i):
            pass
    kept = rec.spans()
    assert [r.counts["i"] for r in kept] == [6, 7, 8, 9]
    assert all(r.end_ns >= r.start_ns and r.thread == threading.get_ident() for r in kept)
    assert rec.totals() == {"a": {"n": 20, "i": sum(range(10))}}
    rec.reset()
    assert rec.spans() == [] and rec.totals() == {}


def test_parent_request_and_thread_across_the_prefetch_thread():
    def items():
        for i in range(3):
            with profiling.span("inner", i=i):
                pass
            yield i

    with profiling.span("outer"):
        got = list(prefetch(items()))
    assert got == [0, 1, 2]
    (outer,) = _named("outer")
    main = threading.get_ident()
    assert outer.thread == main
    # three items and the iterator's end, each produced and waited for
    produce, wait, inner = _named("data.produce"), _named("data.wait"), _named("inner")
    assert len(produce) == len(wait) == 4 and len(inner) == 3
    assert all(_within(w, outer) for w in wait)
    worker = {p.thread for p in produce}
    assert len(worker) == 1 and main not in worker
    # each item's span lies in its own production, on the prefetch thread,
    # and in no span of the consumer's
    for r in inner:
        assert sum(_within(r, p) for p in produce) == 1 and not _within(r, outer)


def test_many_threads_lose_no_span():
    """Threads recording at once: every span counted once, inside its
    parent on its own thread (a lost update breaks the totals)."""
    n_threads, n_spans = 16, 500
    rec = profiling.SpanRecorder(size=2 * n_threads * n_spans)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        # every thread alive at once, so no two share an ident
        start = threading.Barrier(n_threads)

        def work():
            start.wait(timeout=60)
            for _ in range(n_spans):
                with rec.span("outer", n=1):
                    with rec.span("inner", n=2):
                        pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert rec.totals() == {"outer": {"n": n_threads * n_spans},
                            "inner": {"n": 2 * n_threads * n_spans}}
    records = rec.spans()
    assert len(records) == 2 * n_threads * n_spans
    by_thread = {}
    for r in records:
        by_thread.setdefault(r.thread, []).append(r)
    assert len(by_thread) == n_threads
    for mine in by_thread.values():
        # an inner span closes before its outer one: they alternate
        assert [r.name for r in mine] == ["inner", "outer"] * n_spans
        assert all(_within(i, o) for i, o in zip(mine[::2], mine[1::2]))


def test_no_annotation_without_a_profiler(monkeypatch):
    def refused(*a, **k):
        raise AssertionError("a profiler event made with no profiler recording")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refused)
    with profiling.span("quiet"):
        pass
    assert len(_named("quiet")) == 1


def test_an_annotation_under_the_profiler_matches_its_record():
    """Under ``torch.profiler`` each span is also a ``manipose.<name>``
    host event, on the clock of the ring's record (within 0.5 ms)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(4):
            with profiling.span("probe"):
                torch.ones(64).sum()
    records = _named("probe")
    events = _manipose_events(prof, "probe")
    assert len(events) == len(records) == 4
    for e, r in list(zip(events, records))[1:]:  # the first pays the profiler's warm-up
        assert abs(e.start_ns() - r.start_ns) < 500_000, (e.start_ns(), r.start_ns)
        end = e.start_ns() + e.duration_ns()
        assert abs(end - r.end_ns) < 500_000, (end, r.end_ns)


def _ceil_div(a, b):
    return -(-a // b)


@pytest.mark.parametrize("n_frames,batch_size", [(40, 3), (9, 3), (100, 4)])
def test_predict_video_spans_and_counts(n_frames, batch_size):
    pred = Predictor(cfg=load_config("config", OVERRIDES), batch_size=batch_size, tta=True,
                     device="cpu")
    video = np.random.default_rng(0).normal(size=(n_frames, 17, 2)).astype(np.float32)
    poses = pred.predict_video(video)
    assert poses.shape == (n_frames, 17, 3)
    (top,) = _named("serve.video")
    assert top.counts == {"frames": n_frames}
    windows = _ceil_div(n_frames, SEQ_LEN)
    batches = _ceil_div(windows, batch_size)
    dispatch = _named("serve.dispatch")
    assert len(dispatch) == batches and len(profiling.spans()) == batches + 1
    assert [d.counts["rows"] for d in dispatch] == [batch_size] * batches
    assert sum(d.counts["valid"] for d in dispatch) == windows
    assert all(_within(d, top) for d in dispatch)
    assert all(a.end_ns <= b.start_ns for a, b in zip(dispatch, dispatch[1:]))
    assert profiling.totals() == {"serve.video": {"frames": n_frames},
                                  "serve.dispatch": {"rows": batches * batch_size,
                                                     "valid": windows}}
    # the windows' streaming path: one dispatch, unpadded
    profiling.reset()
    pred.forward_windows(np.zeros((2, SEQ_LEN, 17, 2), np.float32))
    (d,) = profiling.spans()
    assert d.name == "serve.dispatch" and d.counts == {"rows": 2, "valid": 2}


def test_loader_and_prefetch_spans():
    rng = np.random.default_rng(0)
    p3 = [rng.normal(size=(200, 17, 3)).astype(np.float32)]
    p2 = [rng.normal(size=(200, 17, 2)).astype(np.float32)]
    ds = PoseSequenceDataset(p3, p2, seq_len=SEQ_LEN, skeleton=h36m_skeleton_17())
    loader = SequenceLoader(ds, batch_size=2)
    n = len(loader)
    assert n >= 8  # more than the queue and the consumer below hold
    moved = [b.to_device(torch.device("cpu")) for b in prefetch(loader)]
    assert len(moved) == n
    produce, batch = _named("data.produce"), _named("data.batch")
    # one of each a batch, and one more produce and wait for the loader's end
    assert len(batch) == len(_named("data.to_device")) == n
    assert len(produce) == len(_named("data.wait")) == n + 1
    assert all(sum(_within(b, p) for p in produce) == 1 for b in batch)
    # a consumer that stops early waits once a batch it takes
    profiling.reset()
    batches = prefetch(loader)
    for _ in range(2):
        next(batches)
    batches.close()
    assert len(_named("data.wait")) == 2
    assert len(_named("data.batch")) == len(_named("data.produce")) >= 2


def test_train_step_spans_in_order():
    cfg = load_config("config", OVERRIDES + ["model.drop_path_rate=0.0"])
    skeleton = h36m_skeleton_17()
    model, _ = instantiate_model(cfg, skeleton)
    opt = make_optimizer(model.parameters(), weight_decay=1e-6)
    state = TrainState.create(model, opt, seed=0, device="cpu")
    step = make_train_step(model, LossConfig(), skeleton, opt)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, SEQ_LEN, 17, 2)).astype(np.float32)
    y = 0.1 * rng.normal(size=(2, SEQ_LEN, 17, 3)).astype(np.float32)
    for _ in range(2):
        step(state, x, y, 4e-5)
    tops = _named("step")
    assert len(tops) == 2
    for top in tops:
        inside = sorted((r for r in profiling.spans() if _within(r, top) and r is not top),
                        key=lambda r: r.start_ns)
        assert [r.name for r in inside] == ["step.forward", "step.backward", "step.optimizer"]
        assert all(a.end_ns <= b.start_ns for a, b in zip(inside, inside[1:]))


@pytest.mark.cuda
def test_a_span_encloses_its_kernel_on_the_device_timeline():
    """On the card: a span around a launch and a synchronisation holds the
    kernel's device interval, its host event agrees with the ring's record
    within 50 us (the profiler's clock is the spans' clock), and it leaves
    nothing on the device's timeline, where a reader of the trace could
    take it for device work."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    x = torch.randn(2048, 2048, device="cuda")
    (x @ x).sum().item()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            with profiling.span("probe"):
                x @ x
                torch.cuda.synchronize()
    records = _named("probe")
    events = prof.profiler.kineto_results.events()
    assert not [e.name() for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
                and e.name().startswith("manipose.")]
    # the device's kernels, not the annotations' or synchronisations' markers
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.name().startswith("manipose.")
               and not any(m in e.name() for m in ("Sync", "Wait Event", "Memcpy", "Memset"))]
    assert len(records) == 4 and len(kernels) >= 4, [e.name() for e in events]
    for r in records:
        inside = [(a, b) for a, b in kernels if r.start_ns <= a < b <= r.end_ns]
        assert inside, (r.start_ns, r.end_ns, kernels)
    assert sum(any(r.start_ns <= a < b <= r.end_ns for r in records)
               for a, b in kernels) == len(kernels)
    for e, r in list(zip(_manipose_events(prof, "probe"), records))[1:]:
        assert abs(e.start_ns() - r.start_ns) < 50_000, (e.start_ns(), r.start_ns)
        assert abs(e.start_ns() + e.duration_ns() - r.end_ns) < 50_000
