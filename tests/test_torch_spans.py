"""The port's tracer (`sosvo_torch.utils.spans`).

By hand: counts go to the innermost open span and none is kept outside
one, `frame` is inherited inward, request spans stay out of the nesting,
and off, nothing is kept. On CPU tensors, a 6-frame image-mode window-BA
replay through `default_rig(192)` (the smallest rig the CPU tests render),
a `live_vo_ba` session over the same frames and a small observation-mode
loop leg:
  * off, `span()` hands back one shared null object and nothing is kept;
  * on, the replay's outputs are bit-identical to the run with it off;
  * one `step` span per frame with its named children inside it, on the
    `time.time_ns()` base; the counters equal what the replay did;
  * in a live session every frame's spans carry its `frame=`, and each
    `live.frame` request span holds its own `frame` span.
"""

import dataclasses
import time

import pytest
import torch

from sosvo_torch.frontend.image_frontend import build_frontend_luts
from sosvo_torch.sensor.rig import default_rig
from sosvo_torch.synth import scene
from sosvo_torch.synth.render import RoomScene, render_sequence
from sosvo_torch.utils import spans
from sosvo_torch.utils.config import BAConfig, FrontendConfig, PipelineConfig, RansacConfig
from sosvo_torch.vo import pipeline
from sosvo_torch.vo.ba_pipeline import init_ba_state
from sosvo_torch.vo.image_pipeline import run_replay_images_ba
from sosvo_torch.vo.live import live_vo_ba
from sosvo_torch.vo.loop_closure import close_loops, loop_pairs

torch.set_num_threads(1)
N = 6
ITERS = 3
CFG = PipelineConfig(
    frontend=FrontendConfig(max_features=256, pano_height=64, pano_width=512, descriptor_patch=16),
    ransac=RansacConfig(rigid_angle_threshold=0.02, essential_threshold=0.01, min_inliers=8),
    ba=BAConfig(window=4, max_landmarks=256, max_new=128, iters=ITERS), keyframe_every=2)
STEP_PARTS = {"step.stereo", "step.temporal", "step.rigid", "step.refine", "step.gate"}


@pytest.fixture(autouse=True)
def tracer():
    """Each test starts with the tracer off and empty, and leaves it so."""
    spans.disable()
    spans.reset()
    try:
        yield spans
    finally:
        spans.disable()
        spans.reset()


@pytest.fixture(scope="module")
def world():
    rig = default_rig(image_size=192, device="cpu")
    poses = scene.make_trajectory(N, radius=0.4, device="cpu")
    images = render_sequence(rig, poses, RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6,
                                                   texture_scale=2.0))
    return rig, poses, images, build_frontend_luts(rig, CFG.frontend)


def _replay(world, cfg=CFG):
    rig, poses, images, luts = world
    state = init_ba_state(cfg, torch.Generator().manual_seed(3), T0=poses[0], device="cpu")
    return run_replay_images_ba(rig, cfg, state, images, luts)[1]


def _named(name):
    return [s for s in spans.spans() if s.name == name]


def _totals():
    total = {}
    for s in spans.spans():
        for k, n in s.counts.items():
            total[k] = total.get(k, 0) + n
    return total


def test_counts_go_to_the_innermost_open_span():
    spans.enable()
    spans.count("x")  # no span open: not kept
    with spans.span("a"):
        spans.count("x")
        with spans.span("b"):
            spans.count("x", 3)
            spans.count("y")
        spans.count("x")
    a, b = spans.spans()
    assert (a.counts, b.counts) == ({"x": 2}, {"x": 3, "y": 1})
    assert (a.parent, b.parent) == (-1, 0)


def test_frame_is_inherited_inward_unless_given():
    spans.enable()
    with spans.span("frame", frame=4):
        with spans.span("step"):
            with spans.span("step.gate"):
                pass
        with spans.span("keyframe", frame=7):
            pass
    with spans.span("loop_leg"):
        pass
    assert [s.attrs for s in spans.spans()] == [{"frame": 4}, {"frame": 4}, {"frame": 4},
                                                {"frame": 7}, {}]


def test_request_spans_stay_out_of_the_nesting():
    spans.enable()
    spans.begin("live.frame", 0)
    with spans.span("frame", frame=0):
        spans.begin("live.frame", 1)
        with spans.span("step"):
            spans.count("sync.gate")
    spans.end("live.frame", 0)
    spans.end("live.frame", 5)  # never begun: nothing
    frame, step = spans.spans()
    assert (frame.parent, step.parent, step.counts) == (-1, 0, {"sync.gate": 1})
    (r,) = spans.requests()
    assert (r.name, r.attrs, r.counts) == ("live.frame", {"frame": 0}, {})
    assert r.start_ns <= frame.start_ns <= frame.end_ns <= r.end_ns
    spans.end("live.frame", 1)
    assert [q.attrs["frame"] for q in spans.requests()] == [0, 1]


@pytest.mark.parametrize("call", ["count", "begin", "end", "span"])
def test_off_each_entry_keeps_nothing(call):
    spans.enable()
    spans.begin("live.frame", 0)
    spans.disable()
    {"count": lambda: spans.count("x"), "begin": lambda: spans.begin("live.frame", 1),
     "end": lambda: spans.end("live.frame", 0), "span": lambda: spans.span("a").__enter__()}[call]()
    assert spans.spans() == [] and spans.requests() == []


def test_a_reset_inside_an_open_span_forgets_it_and_exits_cleanly():
    spans.enable()
    with spans.span("a"):
        spans.reset()
        spans.count("x")
    with spans.span("b"):
        pass
    (b,) = spans.spans()
    assert (b.name, b.parent, b.counts) == ("b", -1, {})


def test_off_the_tracer_keeps_nothing(world):
    assert spans.span("step") is spans.span("frontend", frame=3)
    assert spans.span("step").__enter__() is None
    _replay(world)
    assert spans.spans() == [] and spans.requests() == []


def test_on_the_replay_is_bit_identical(world):
    off = _replay(world)
    spans.enable()
    on = _replay(world)
    assert len(spans.spans()) > 0
    for a, b in zip((*off.vo, *off[1:]), (*on.vo, *on[1:])):
        assert torch.equal(a, b)


def test_one_step_span_per_frame_with_its_parts_inside_it(world):
    spans.enable()
    t0 = time.time_ns()
    _replay(world)
    t1 = time.time_ns()
    all_spans = spans.spans()
    steps = _named("step")
    assert len(steps) == N
    assert [s.attrs["frame"] for s in steps] == list(range(N))
    for i, s in enumerate(all_spans):
        assert t0 <= s.start_ns <= s.end_ns <= t1
        if s.parent >= 0:
            p = all_spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns and s.parent < i
    for k, s in enumerate(all_spans):
        if s.name == "step":
            kids = {c.name for c in all_spans if c.parent == k}
            assert kids == STEP_PARTS
    assert {all_spans[s.parent].name for s in steps} == {"frame"}
    assert {c.name for c in all_spans if c.parent >= 0 and all_spans[c.parent].name == "frontend"} \
        == {"frontend.warp", "frontend.detect", "frontend.describe", "frontend.lift"}
    kf = {s.attrs["frame"] for s in _named("keyframe")}
    assert kf == set(range(N))
    assert {all_spans[s.parent].name for s in _named("ba.build")} == {"keyframe.window_ba"}


def test_counts_are_what_the_replay_did(world):
    spans.enable()
    out = _replay(world)
    total = _totals()
    n_kf = int(out.is_keyframe.sum())
    solves = len(_named("keyframe.window_ba"))
    assert total["sync.gate"] == N                 # the lazy gate reads every frame
    assert total["sync.keyframe_read"] == N - 1    # every frame once frame 0 is a keyframe
    assert total["sync.replay_start"] == 1
    assert total["keyframes"] == n_kf == len(_named("keyframe.insert"))
    assert solves == n_kf - 1
    assert total["ba.lm_iters"] == ITERS * solves
    assert total.get("reloc.tried", 0) == int(out.reloc_tried.sum()) == \
        len(_named("keyframe.reloc"))
    gate = [s for s in spans.spans() if "sync.gate" in s.counts]
    assert {s.name for s in gate} == {"step.gate"}


def test_live_frames_carry_their_frame_and_own_plus_held_is_the_request(world):
    rig, poses, images, luts = world
    spans.enable()
    frames = list(images.numpy())
    session = live_vo_ba(rig, CFG, frames, generator=torch.Generator().manual_seed(3), luts=luts,
                         T0=poses[0], device="cpu")
    got = [idx for idx, _ in session]
    assert got == list(range(N))
    reqs = spans.requests()
    assert [r.attrs["frame"] for r in reqs] == list(range(N))
    all_spans = spans.spans()
    for s in all_spans:
        assert "frame" in s.attrs, s.name
    for r in reqs:
        own = [s for s in all_spans if s.name == "frame" and s.attrs["frame"] == r.attrs["frame"]]
        assert len(own) == 1 and r.start_ns <= own[0].start_ns <= own[0].end_ns <= r.end_ns
        mine = [s for s in all_spans if s.attrs["frame"] == r.attrs["frame"]]
        assert {"frame", "live.upload", "live.draws", "frontend", "step", "keyframe"} <= \
            {s.name for s in mine}
        # own plus held is the request: the frame's own span lies inside it
        held = (r.end_ns - r.start_ns) - (own[0].end_ns - own[0].start_ns)
        assert own[0].end_ns > own[0].start_ns and held >= 0


def test_loop_leg_spans_and_counts():
    rig = default_rig(device="cpu")
    sc = scene.make_scene(torch.Generator().manual_seed(0), 12, 512, device="cpu")
    obs = scene.observe_sequence(rig, sc, 64, torch.Generator().manual_seed(1), 0.3, 0.02)
    spans.enable()
    close_loops(rig, PipelineConfig(), obs, sc.poses, min_gap=2, min_inliers=8, iters=2)
    all_spans = spans.spans()
    legs = [k for k, s in enumerate(all_spans) if s.name == "loop_leg"]
    assert len(legs) == 1
    kids = [s for s in all_spans if s.parent == legs[0]]
    assert [s.name for s in kids] == ["loop_leg.features", "loop_leg.candidates",
                                      "loop_leg.pairs", "loop_leg.pgo", "loop_leg.correct"]
    n_kf = len(range(0, 12, PipelineConfig().keyframe_every))
    counts = {}
    for s in all_spans:
        for k, n in s.counts.items():
            counts[k] = counts.get(k, 0) + n
    assert counts["loop.pairs_tried"] == len(loop_pairs(n_kf, 2)[0])
    assert (counts["sync.leg_keyframes"], counts["sync.leg_pairs"], counts["sync.leg_correct"]) == \
        (1, 2, 2)
    assert counts["ba.lm_iters"] == 4 * counts["loop.pairs_tried"]


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "eager"])
def test_gate_fired_counts_the_gate_checks_run(world, monkeypatch, lazy):
    calls = []
    check = pipeline._gate_check

    def counted(*args, **kwargs):
        calls.append(1)
        return check(*args, **kwargs)

    monkeypatch.setattr(pipeline, "_gate_check", counted)
    spans.enable()
    _replay(world, dataclasses.replace(CFG, lazy_essential_gate=lazy))
    total = _totals()
    assert total.get("gate.fired", 0) == len(calls)
    assert total.get("sync.gate", 0) == (N if lazy else 0)
    if not lazy:
        assert len(calls) == N
    fired = [s for s in spans.spans() if "gate.fired" in s.counts]
    assert {s.name for s in fired} <= {"step.gate"}
