"""Whole runs of each cell at a tiny size on the CPU (the harness's look
for a card skipped), sound and with the timed path broken underneath:
``correct`` must come out true, then false for each fault the cell can
have. On the card: the TF32 control fails each cell's limits."""

import json

import pytest

import tiny
from harness import core

SPEC = json.loads((core.ROOT / "BENCHMARK.json").read_text())
# every mix with a driver: the benchmark's cells, and the stream mix that
# PERF.md keeps for a later PR
CELLS = [(w["config"], w["traffic"]) for w in SPEC["workloads"]
         if w["chips"] == 1] + [("manipose-3dhp-27", "stream-push")]


def _cell(config, traffic):
    return tiny.tiny(tiny.cell(config, traffic))


@pytest.mark.parametrize("config,traffic", CELLS)
def test_a_sound_run_is_correct(config, traffic):
    line = tiny.run(_cell(config, traffic))
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


def test_an_altered_pose_is_caught(monkeypatch):
    from manipose_tpu_torch.serving import Predictor

    lift = Predictor.predict_video

    def altered(self, video, *a, **k):
        out = lift(self, video, *a, **k)
        out[len(out) // 2, 3, 1] += 0.01  # one coordinate of one frame, 1 cm
        return out

    monkeypatch.setattr(Predictor, "predict_video", altered)
    assert not tiny.run(_cell("manipose-h36m-243", "lift-videos"))["correct"]


def test_an_altered_streamed_pose_is_caught(monkeypatch):
    from manipose_tpu_torch.streaming import StreamingSession

    push = StreamingSession.push
    calls = {"n": 0}

    def altered(self, frames):
        out = push(self, frames)
        calls["n"] += 1
        if len(out) and calls["n"] % 3 == 0:
            out = out.copy()
            out[0, 5, 0] += 0.01
        return out

    monkeypatch.setattr(StreamingSession, "push", altered)
    assert not tiny.run(_cell("manipose-3dhp-27", "stream-push"))["correct"]


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    from manipose_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "step", lambda self, lr: True)
    line = tiny.run(_cell("manipose-h36m-243", "train-b16"))
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] > 0.9  # nothing moved: about 1


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    from manipose_tpu_torch.train import step as step_mod

    make = step_mod.make_train_step

    def halved(*a, **k):
        inner = make(*a, **k)

        def step(state, x, y, lr, n_valid=None):
            return inner(state, x[: len(x) // 2], y[: len(y) // 2], lr)

        return step

    monkeypatch.setattr(step_mod, "make_train_step", halved)
    line = tiny.run(_cell("manipose-h36m-243", "train-b16"))
    assert not line["correct"]
    assert line["checks"]["loss_gap"]["value"] > line["checks"]["loss_gap"]["limit"]


@pytest.mark.parametrize("config,traffic", CELLS)
def test_the_tf32_control_fails_on_the_card(card, config, traffic):
    cell = tiny.cell(config, traffic)
    numbers = cell.driver().control(core.Context(cell, 2**31 + 101, 0.0, False, card, 0.0),
                                    "tf32")
    limits = cell.mix["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers
