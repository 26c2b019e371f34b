"""The harness on the CPU: a made-up cell from test-only files, the faults
the check must catch, the trace reduction, and the run's refusals.

The made-up cells live in a temporary checkout root assembled from
`vobench/tests/data` (configurations, traffic, a made-up metric) and copies
of the real readers; no file of the benchmark is edited. `run_cell` is
driven directly, past `run.py`'s look for a card, on CPU tensors.
"""

import io
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from vobench import harness, trace

torch.set_num_threads(1)  # as the repository's CPU tests run: steadier on a shared host

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
CPU = torch.device("cpu")
READERS = ("frames_per_s", "setup_s", "frontend_ms_per_frame", "step_ms_per_frame",
           "window_ba_ms", "loop_leg_s", "live_latency_p95_ms")
LIMITS = {"pos_gap_m": {"limit": 1e-4}, "pose_ok_diff": {"limit": 0}}
LEG_LIMITS = {**LIMITS, "leg_pos_gap_m": {"limit": 1e-4}}


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    r = tmp_path_factory.mktemp("checkout")
    for sub in ("configs", "traffic", "limits", "metrics"):
        (r / "vobench" / sub).mkdir(parents=True)
    for name in ("tiny_c2", "tiny_c3"):
        shutil.copy(DATA / f"{name}.json", r / "vobench" / "configs")
    for name in ("tiny_replay", "tiny_live"):
        shutil.copy(DATA / f"{name}.json", r / "vobench" / "traffic")
    shutil.copy(DATA / "frames_in_window.py", r / "vobench" / "metrics")
    for name in READERS:
        shutil.copy(REPO / "vobench" / "metrics" / f"{name}.py", r / "vobench" / "metrics")
    bench = {
        "command": ["python3", "-m", "vobench.run"], "paths": ["vobench"], "run_seconds": 1,
        "configs": [],
        "workloads": [
            {"name": "t2.replay", "config": "tiny_c2", "traffic": "tiny_replay", "chips": 1},
            {"name": "t3.replay-pgo", "config": "tiny_c3", "traffic": "tiny_replay", "chips": 1},
            {"name": "t3.live", "config": "tiny_c3", "traffic": "tiny_live", "chips": 1}],
        "end_to_end": [{"name": "frames_per_s", "unit": "frames/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "frames_in_window", "unit": "frames"},
                      {"name": "frontend_ms_per_frame", "unit": "ms"},
                      {"name": "step_ms_per_frame", "unit": "ms"},
                      {"name": "window_ba_ms", "unit": "ms"},
                      {"name": "loop_leg_s", "unit": "s", "workloads": ["t3.replay-pgo"]},
                      {"name": "live_latency_p95_ms", "unit": "ms", "workloads": ["t3.live"]}]}
    (r / "BENCHMARK.json").write_text(json.dumps(bench))
    for cell, limits in (("t2.replay", LIMITS), ("t3.replay-pgo", LEG_LIMITS),
                         ("t3.live", LIMITS)):
        (r / "vobench" / "limits" / f"{cell}.json").write_text(json.dumps({"numbers": limits}))
    return r


def _run(root: Path, cell: str, traced: bool = False, seconds: float = 1.0, seed: int = 2**31 + 9):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(root, cell, seed, seconds, traced, CPU, time.perf_counter(), out, err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("cell,traced,expect", [
    ("t2.replay", False, {"frames_per_s", "setup_s"}),
    ("t2.replay", True, {"frames_in_window", "frontend_ms_per_frame", "step_ms_per_frame",
                         "window_ba_ms"}),
    ("t3.live", True, {"frames_in_window", "frontend_ms_per_frame", "step_ms_per_frame",
                       "live_latency_p95_ms"}),
])
def test_made_up_cell_runs_from_test_only_files(root, cell, traced, expect):
    line, err = _run(root, cell, traced, seconds=8.0)
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, err
    assert expect <= set(line["metrics"]), err
    assert line["attempted"] > 0 and line["failed"] == 0
    assert err.strip().splitlines()[-1].startswith("check ")


def test_replay_with_leg_is_correct(root):
    line, err = _run(root, "t3.replay-pgo", traced=True, seconds=0.5)
    assert line["correct"] is True, err
    assert "loop_leg_s" in line["metrics"]
    assert set(line["checks"]) == set(LEG_LIMITS)


def _freeze_state(monkeypatch):
    """A step that returns its state unchanged."""
    from sosvo_torch.vo import ba_pipeline
    step_full = ba_pipeline.step_full

    def frozen(rig, cfg, state, obs, draws=None, defer_gate=False):
        _, out, feats = step_full(rig, cfg, state, obs, draws)
        return state, out._replace(T_world=state.T_world), feats
    monkeypatch.setattr(ba_pipeline, "step_full", frozen)


def _drop_half(monkeypatch):
    """Half of every frame's features left out."""
    from sosvo_torch.frontend import image_frontend
    extract = image_frontend.extract_sequence

    def half(*a, **k):
        obs = extract(*a, **k)
        keep = torch.arange(obs.valid_top.shape[-1]) % 2 == 0
        return obs._replace(valid_top=obs.valid_top & keep, valid_bottom=obs.valid_bottom & keep)
    monkeypatch.setattr(image_frontend, "extract_sequence", half)


def _alter_one_pose(monkeypatch):
    """One early frame's pose moved by 1 cm where the step produces it."""
    from sosvo_torch.vo import ba_pipeline
    step_full = ba_pipeline.step_full

    def altered(rig, cfg, state, obs, draws=None, defer_gate=False):
        track, out, feats = step_full(rig, cfg, state, obs, draws)
        if int(state.frame_idx) == 1:
            T = out.T_world.clone()
            T[0, 3] += 0.01
            track, out = track._replace(T_world=T), out._replace(T_world=T)
        return track, out, feats
    monkeypatch.setattr(ba_pipeline, "step_full", altered)


def _alter_leg(monkeypatch):
    """One frame of the loop leg's corrected trajectory moved by 1 cm."""
    from sosvo_torch.vo import loop_closure
    correct_trajectory = loop_closure.correct_trajectory

    def altered(*a, **k):
        T = correct_trajectory(*a, **k).clone()
        T[3, 0, 3] += 0.01
        return T
    monkeypatch.setattr(loop_closure, "correct_trajectory", altered)


@pytest.mark.parametrize("cell,fault", [
    ("t2.replay", _freeze_state), ("t2.replay", _drop_half), ("t2.replay", _alter_one_pose),
    ("t3.live", _alter_one_pose), ("t3.replay-pgo", _alter_leg),
])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    line, err = _run(root, cell, seconds=8.0)
    assert line["correct"] is False, err
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_union_and_idle_gaps_by_innermost_span():
    events = [("k1", 10, 20), ("k2", 15, 30), ("k3", 50, 60), ("k4", 92, 95)]
    busy = trace.union(events)
    assert busy == [(10, 30), (50, 60), (92, 95)]
    t = trace.DeviceTrace(0, 100, events, busy)
    assert t.busy_s == pytest.approx(33e-9) and t.window_s == pytest.approx(100e-9)
    spans = {"outer": [(0, 90)], "inner": [(25, 45)]}
    gaps = dict(trace.idle_gaps_by_span(t, spans))
    # a gap counts for the innermost span open when it began: 0-10 and
    # 60-92 under "outer", 30-50 under "inner", 95-100 outside every span
    assert gaps["inner"] == pytest.approx(20e-9)
    assert gaps["outer"] == pytest.approx(42e-9)
    assert gaps[trace.OUTSIDE] == pytest.approx(5e-9)
    assert trace.top_device_ops(t)[0] == ["k2", pytest.approx(15e-9)]


def test_forbidden_modules_are_compared_by_whole_top_level_name():
    assert harness.forbidden_modules(["sosvo_torch", "sosvo_torch.vo.live", "jaxtyping",
                                      "vobench.reference"]) == []
    assert harness.forbidden_modules(["sosvo.cli", "jax.numpy", "flax", "torch"]) == \
        ["flax", "jax", "sosvo"]


def test_run_without_a_card_prints_no_result(root):
    out = subprocess.run([sys.executable, "-m", "vobench.run", "--workload", "t2.replay",
                          "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                         cwd=root, env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
