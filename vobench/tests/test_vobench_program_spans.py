"""`vobench/program_spans.py` and the seven readers of the port's tracer,
over a synthetic device trace and synthetic spans: clipping to the window,
operations and idle time by the innermost span, request spans kept out of
the nesting, keys that sum to each value beside the counts that sit next
to them, and nothing read without the tracer or without a device trace.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from sosvo_torch.utils import spans
from vobench import harness, trace

REPO = Path(__file__).resolve().parents[2]
READERS = ("device_ops_per_frame", "frontend_span_ms_per_frame", "step_span_ms_per_frame",
           "window_ba_span_ms", "loop_leg_span_s", "sync_reads_per_frame",
           "live_frame_span_p95_ms")


@pytest.fixture(autouse=True)
def tracer():
    """Each test starts with the tracer off and empty, and leaves it so:
    importing `vobench.program_spans` turns it on."""
    spans.disable()
    spans.reset()
    try:
        yield spans
    finally:
        spans.disable()
        spans.reset()


LO, HI = 1000, 2000


def _span(name, a, b, parent=-1, counts=None, **attrs):
    s = spans.Span(name, attrs)
    s.start_ns, s.end_ns, s.parent, s.counts = a, b, parent, dict(counts or {})
    return s


def _synthetic():
    """Two frames inside [LO, HI], a loop leg, a warm-up span before the
    window and one crossing its end; three live.frame requests."""
    s = [
        _span("step", 100, 200, frame=9),                                      # 0 warm-up
        _span("frame", 1100, 1500, frame=0),                                   # 1
        _span("frontend", 1100, 1120, 1),                                      # 2
        _span("step", 1120, 1400, 1, {"sync.gate": 1, "gate.fired": 1}),       # 3
        _span("step.stereo", 1130, 1200, 3),                                   # 4
        _span("step.rigid", 1250, 1350, 3),                                    # 5
        _span("keyframe", 1400, 1500, 1, {"keyframes": 1}),                    # 6
        _span("keyframe.window_ba", 1410, 1490, 6, {"ba.lm_iters": 2}),        # 7
        _span("ba.build", 1420, 1440, 7),                                      # 8
        _span("ba.schur", 1440, 1460, 7),                                      # 9
        _span("ba.solve", 1460, 1480, 7),                                      # 10
        _span("frame", 1500, 1850, frame=1),                                   # 11
        _span("step", 1500, 1800, 11, {"sync.gate": 1}),                       # 12
        _span("step.stereo", 1500, 1600, 12),                                  # 13
        _span("keyframe", 1800, 1850, 11, {"sync.keyframe_read": 1,
                                            "reloc.tried": 1}),                # 14
        _span("loop_leg", 1850, 1990),                                         # 15
        _span("loop_leg.pairs", 1860, 1980, 15, {"loop.pairs_tried": 4,
                                                  "sync.leg_correct": 2}),     # 16
        _span("step", 1995, 2100),                                             # 17 crosses HI
    ]
    reqs = [_span("live.frame", 1050, 1700, frame=0), _span("live.frame", 1450, 1900, frame=1),
            _span("live.frame", 1800, 2500, frame=2)]
    events = [("a", 1050, 1060),   # no span open
              ("b", 1105, 1110),   # frontend
              ("c", 1135, 1150),   # step.stereo
              ("d", 1140, 1160),   # step.stereo
              ("e", 1210, 1240),   # step
              ("f", 1425, 1435),   # ba.build
              ("g", 1520, 1580),   # step.stereo (frame 1)
              ("h", 1900, 1950)]   # loop_leg.pairs
    busy = trace.union(events)
    return s, reqs, trace.DeviceTrace(LO, HI, events, busy)


@pytest.fixture
def program_spans():
    """`vobench.program_spans`, imported here and not at collection: its
    import turns the tracer on, which `tracer` turns off again."""
    from vobench import program_spans
    spans.disable()
    return program_spans


@pytest.fixture
def synthetic(monkeypatch, program_spans):
    s, reqs, tr = _synthetic()
    monkeypatch.setattr(program_spans, "tracer",
                        SimpleNamespace(spans=lambda: s, requests=lambda: reqs))
    return SimpleNamespace(trace=tr)


def test_window_clips_and_lays_ops_and_idle_under_the_innermost_span(program_spans, synthetic,
                                                                    capsys):
    w = program_spans.window(synthetic)
    assert sorted(w.spans) == list(range(1, 17))            # warm-up and crossing spans dropped
    assert [r.attrs["frame"] for r in w.requests] == [0, 1]  # the third ends after HI
    assert w.frames == 2
    assert w.ops == {"outside": 1, "frontend": 1, "step.stereo": 3, "step": 1, "ba.build": 1,
                     "loop_leg.pairs": 1, "frame": 0, "step.rigid": 0, "keyframe": 0,
                     "keyframe.window_ba": 0, "ba.schur": 0, "ba.solve": 0, "loop_leg": 0}
    # step.stereo: [1130, 1200] less busy [1135, 1160], [1500, 1600] less [1520, 1580]
    assert w.idle_ns["step.stereo"] == 45 + 40
    # no span open: [1000, 1100] less [1050, 1060], and [1990, 2000]
    assert w.idle_ns["outside"] == 90 + 10
    assert sum(w.idle_ns.values()) == (HI - LO) - sum(b - a for a, b in synthetic.trace.busy)
    assert "idle under no program span: 0.000 s of 0.000 s" in capsys.readouterr().err
    st = w.stage("step", w.frames, 1.0)
    assert st["value"] == (280 + 300) / 2
    assert st["step.stereo"] == (70 + 100) / 2 and st["step.rigid"] == 50
    assert st["self"] == st["value"] - st["step.stereo"] - st["step.rigid"]
    assert st["idle.step.stereo"] == 85 / 2


def test_request_spans_stay_out_of_the_nesting(program_spans, synthetic):
    w = program_spans.window(synthetic)
    assert all(s.name != "live.frame" for s in w.spans.values())
    assert "live.frame" not in w.ops and "live.frame" not in w.idle_ns


@pytest.mark.parametrize("name", READERS)
def test_reader_keys_sum_to_the_value(synthetic, name):
    v = harness.load_reader(REPO, name).read(synthetic)
    assert isinstance(v, dict)
    parts = {k: x for k, x in v.items() if k != "value" and not k.startswith("idle")
             and k not in ("lm_iters_per_solve", "pairs_tried", "samples", "gate_fired_per_frame",
                           "keyframes_per_frame", "reloc_tried_per_frame")}
    assert parts and sum(parts.values()) == pytest.approx(v["value"], rel=1e-12, abs=1e-12)
    if name == "device_ops_per_frame":
        assert v["value"] * 2 == len(synthetic.trace.events)
    if name == "sync_reads_per_frame":
        assert v == {"value": 2.5, "sync.gate": 1.0, "sync.keyframe_read": 0.5,
                     "sync.leg_correct": 1.0}
    if name == "window_ba_span_ms":
        assert v["lm_iters_per_solve"] == 2 and v["value"] == pytest.approx(80 / 1e6)
        assert (v["keyframes_per_frame"], v["reloc_tried_per_frame"]) == (0.5, 0.5)
        assert v["idle_ms"] == pytest.approx((80 - 10) / 1e6)
    if name == "step_span_ms_per_frame":
        assert v["gate_fired_per_frame"] == 0.5
    if name == "loop_leg_span_s":
        assert v["pairs_tried"] == 4 and v["loop_leg.pairs"] == pytest.approx(120 / 1e9)
    if name == "live_frame_span_p95_ms":
        assert v["samples"] == 2 and v["value"] == pytest.approx(650 / 1e6)
        assert v["own_ms_p95"] == pytest.approx(400 / 1e6)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_the_tracer(program_spans, synthetic, monkeypatch, name):
    monkeypatch.setattr(program_spans, "tracer", None)
    assert harness.load_reader(REPO, name).read(synthetic) is None


def test_readers_read_nothing_without_a_device_trace(synthetic):
    assert harness.load_reader(REPO, "step_span_ms_per_frame").read(
        SimpleNamespace(trace=None)) is None


def test_busy_until_counts_the_cards_busy_time(program_spans, synthetic):
    w = program_spans.window(synthetic)
    t = np.array([LO, 1055, 1150, 1600, HI])
    assert w.busy_until(t).tolist() == [0, 5, 10 + 5 + 15, 10 + 5 + 25 + 30 + 10 + 60, 10 + 5 + 25
                                        + 30 + 10 + 60 + 50]
