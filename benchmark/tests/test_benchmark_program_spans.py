"""The readers of the port's own spans, each with a known answer: idle
gaps given to the innermost port span on the launching thread, on a
synthetic trace; None where the port has no span module; the medians of
the data spans; and a tiny lift run on the CPU whose
``useful_frames.lift`` is the reckoning from its lengths plan."""

import dataclasses
import threading
import time
import types

import pytest

import tiny
from harness import common, core, program_spans, tracing

SPEC = core.load_json(core.ROOT / "BENCHMARK.json")
MS = 1_000_000  # ns


@pytest.fixture(autouse=True)
def fresh_spans():
    from manipose_tpu_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.reset()


@dataclasses.dataclass
class Rec:
    name: str
    thread: int
    start_ns: int
    end_ns: int


def _trace(busy, window):
    return tracing.Trace([("k", a, b) for a, b in busy], [], 0, window)


def _reader(metric):
    cell = core.Cell.find(next(w for w in SPEC["per_layer"] if w["name"] == metric)
                          ["workloads"][0])
    return cell.reader(metric)


def test_each_gap_goes_to_the_innermost_span_open_when_it_began(monkeypatch):
    main, other = threading.main_thread().ident, -1
    # window 0-100 ms; device busy 5-20, 30-60, 70-95: gaps 0-5, 20-30, 60-70, 95-100
    trace = _trace([(5 * MS, 20 * MS), (30 * MS, 60 * MS), (70 * MS, 95 * MS)], (0, 100 * MS))
    records = [Rec("serve.video", main, 2 * MS, 90 * MS),
               Rec("serve.dispatch", main, 18 * MS, 25 * MS),  # the 20-30 gap opens here
               Rec("serve.dispatch", main, 50 * MS, 58 * MS),  # closed before 60
               Rec("serve.dispatch", other, 55 * MS, 99 * MS),  # another thread's
               Rec("step.forward", main, 58 * MS, 65 * MS),  # another layer's
               Rec("stepper", main, 0, 100 * MS)]  # no layer of the port's
    monkeypatch.setattr(program_spans, "recorder",
                        lambda: types.SimpleNamespace(spans=lambda: records))
    run = types.SimpleNamespace(trace=trace, config={}, work={})
    assert program_spans.idle_by_span(run, ("serve",)) == pytest.approx(
        {"host": 0.010, "serve.dispatch": 0.010, "serve.video": 0.010})
    assert _reader("idle_in_program.lift")(run) == pytest.approx(20.0)
    assert _reader("idle_in_dispatch.lift")(run) == pytest.approx(10.0)
    assert program_spans.idle_by_span(run, ("step", "data")) == pytest.approx(
        {"host": 0.020, "step.forward": 0.010})
    assert _reader("idle_in_program.train")(run) == pytest.approx(10.0)


def test_idle_in_program_reads_the_ports_spans_against_the_trace(fresh_spans):
    """Real spans on the launching thread, a trace laid around them: one
    gap opens inside ``serve.dispatch`` and one in ``serve.video`` after
    it, and both count in ``idle_in_program.lift``, the first alone in
    ``idle_in_dispatch.lift``; one opens before any port span and one
    after the video's, and neither counts."""
    profiling = fresh_spans
    with profiling.span("serve.video"):
        time.sleep(0.003)
        with profiling.span("serve.dispatch"):
            time.sleep(0.003)
        time.sleep(0.003)
    spans = {r.name: r for r in profiling.spans()}
    video, disp = spans["serve.video"], spans["serve.dispatch"]
    lo, hi = video.start_ns - 2 * MS, video.end_ns + 2 * MS
    trace = _trace([(lo + MS, disp.start_ns + MS // 2), (disp.start_ns + MS, disp.end_ns + MS // 2),
                    (disp.end_ns + MS, video.end_ns + MS)], (lo, hi))
    run = types.SimpleNamespace(trace=trace, config={}, work={})
    window = (hi - lo) * 1e-9
    assert _reader("idle_in_program.lift")(run) == pytest.approx(100 * 0.001 / window)
    assert _reader("idle_in_dispatch.lift")(run) == pytest.approx(100 * 0.0005 / window)
    assert _reader("idle_in_program.train")(run) is None  # no step or data span recorded
    assert _reader("idle_in_program.lift")(types.SimpleNamespace(trace=None)) is None


def test_the_readers_find_the_ports_module_and_give_none_without_it(monkeypatch):
    """This checkout's port records spans, so the readers find its module
    (were it moved, this fails rather than the metrics falling silent);
    a port without the module gives None from every reader."""
    from manipose_tpu_torch.utils import profiling

    assert program_spans.recorder() is profiling
    find_spec = program_spans.importlib.util.find_spec
    monkeypatch.setattr(program_spans.importlib.util, "find_spec",
                        lambda name: None if name == program_spans.MODULE else find_spec(name))
    with profiling.span("serve.video", frames=9):
        with profiling.span("serve.dispatch", rows=1, valid=1):
            pass
    trace = _trace([(0, 1)], (0, 2))
    run = types.SimpleNamespace(trace=trace, config={"data": {"seq_len": 9}}, work={})
    for metric in ("idle_in_program.lift", "idle_in_dispatch.lift", "useful_frames.lift",
                   "idle_in_program.train", "prefetch_wait_ms.train", "batch_make_ms.train"):
        assert _reader(metric)(run) is None, metric


def test_the_data_medians(fresh_spans):
    profiling = fresh_spans
    run = types.SimpleNamespace(trace=None, config={}, work={})
    assert _reader("prefetch_wait_ms.train")(run) is None
    for ms in (1, 9, 3):
        with profiling.span("data.wait"):
            time.sleep(ms * 1e-3)

    def produce():
        for ms in (20, 40):
            with profiling.span("data.produce"):
                time.sleep(ms * 1e-3)

    worker = threading.Thread(target=produce)
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive()
    waits = sorted(r.seconds for r in profiling.spans() if r.name == "data.wait")
    assert _reader("prefetch_wait_ms.train")(run) == pytest.approx(1e3 * waits[1])
    assert 3 <= _reader("prefetch_wait_ms.train")(run) < 9
    assert 30 <= _reader("batch_make_ms.train")(run) < 40


def test_useful_frames_of_a_tiny_lift_run(fresh_spans):
    """The frames of every video the run lifted (its warm-up and window)
    over the slots its padded batches ran, reckoned from the lengths plan."""
    cell = tiny.tiny(tiny.cell("manipose-h36m-243", "lift-videos"))
    seed = 2**31 + 1234
    outcome = cell.driver().run(core.Context(cell, seed, 1.0, False, "cpu", time.perf_counter()))
    mix, seq_len = cell.mix, cell.config["data"]["seq_len"]
    lengths = common.lengths_plan(mix["lengths"], mix["videos"], seed)
    lifted = ([lengths[-1 - i] for i in range(mix["warm_videos"])]
              + [lengths[i % len(lengths)] for i in range(outcome.attempted)])
    batch = mix["batch_size"]
    slots = sum(common.ceil_div(common.ceil_div(n, seq_len), batch) * batch * seq_len
                for n in lifted)
    got = _reader("useful_frames.lift")(core.Run(cell, outcome))
    assert got == pytest.approx(100.0 * sum(lifted) / slots, abs=1e-9)
    assert 0 < got < 100
    fresh_spans.reset()
    assert _reader("useful_frames.lift")(core.Run(cell, outcome)) is None
