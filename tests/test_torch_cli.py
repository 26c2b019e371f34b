"""The port's checkpoint/resume and command line (`sosvo_torch.utils.checkpoint`,
`sosvo_torch.cli`), twins of tests/test_checkpoint.py, all on the CPU.

A replay resumed from a checkpoint, in a fresh template or a new process,
equals the uninterrupted one bit for bit (the lanes' random streams are
part of the state). The command line runs at the reference test's tiny
sizes (K=128, H=128): a killed run resumed writes the uninterrupted run's
`frames.jsonl` byte for byte, with PGO its report's loops and ATE, and the
batched branch runs in both modes. A staged capture (`--sequence`, with and
without `--rig`) replays as the JAX command line replays it. Options that
are not ported, or that the run cannot take, raise.
The command line over several ranks: tests/test_torch_dist_cli.py.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sosvo.utils.framelog import stepoutput_rows as jax_stepoutput_rows
from sosvo_torch import cli
from sosvo_torch.synth.scene import FrameObservations
from sosvo_torch.tools.workload import make_workload
from sosvo_torch.utils.checkpoint import latest_step, restore_state, save_state
from sosvo_torch.utils.config import FrontendConfig, PipelineConfig
from sosvo_torch.utils.framelog import read_jsonl, stepoutput_rows, write_jsonl
from sosvo_torch.vo.ba_pipeline import init_ba_state, run_replay_ba
from sosvo_torch.vo.batched import init_batched_states, run_replay_batched
from sosvo_torch.vo.state import StepOutput

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
# The command line's own processes run on one thread, as this one does: on
# the CPU the replays' positions move by ~1e-6 m with the intra-op and BLAS
# thread count, so a process on more threads may write another log.
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
F, K = 12, 256


def _states_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, torch.Generator):
        return torch.equal(a.get_state(), b.get_state())
    if isinstance(a, tuple):
        return all(_states_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_checkpoint_roundtrip_resumes_exactly(tmp_path):
    """BA replay checkpointed after frame 6 and restored into a fresh
    template (other generator, other pose): the state, generator included,
    is equal, and the tail replays to the same poses bit for bit."""
    cfg = PipelineConfig(frontend=FrontendConfig(max_features=K))
    rig, scene, obs = make_workload(cfg, F, 2048, "cpu")

    def s0(seed, T0):
        return init_ba_state(cfg, torch.Generator().manual_seed(seed), T0=T0, device="cpu")

    _, full = run_replay_ba(rig, cfg, s0(2, scene.poses[0]), obs)
    head = FrameObservations(*(x[:6] for x in obs))
    tail = FrameObservations(*(x[6:] for x in obs))
    mid, _ = run_replay_ba(rig, cfg, s0(2, scene.poses[0]), head)
    save_state(tmp_path, 6, mid)
    assert latest_step(tmp_path) == 6
    restored = restore_state(tmp_path, 6, s0(9, None))
    assert _states_equal(mid, restored)
    _, out_tail = run_replay_ba(rig, cfg, restored, tail)
    assert torch.equal(out_tail.vo.T_world, full.vo.T_world[6:])
    assert torch.equal(out_tail.is_keyframe, full.is_keyframe[6:])


def test_checkpoint_batched_state_roundtrip(tmp_path):
    """A batched state (a tuple of lane generators) restores the same way."""
    cfg = PipelineConfig(frontend=FrontendConfig(max_features=128))
    state = init_batched_states(2, 128, 5, device="cpu")
    rig, _, obs = make_workload(cfg, 3, 1024, "cpu")
    obs2 = FrameObservations(*(torch.stack([x, x]) for x in obs))
    mid, _ = run_replay_batched(rig, cfg, state, FrameObservations(*(x[:, :2] for x in obs2)))
    save_state(tmp_path, 2, mid)
    restored = restore_state(tmp_path, 2, init_batched_states(2, 128, 6, device="cpu"))
    assert _states_equal(mid, restored)
    with pytest.raises(ValueError):
        restore_state(tmp_path, 2, init_batched_states(3, 128, 6, device="cpu"))


def test_framelog_rows_match_reference(tmp_path):
    """The port's copy of the per-frame log writes the JAX package's rows."""
    rng = np.random.default_rng(0)
    outs = StepOutput(T_world=rng.standard_normal((5, 4, 4)).astype(np.float32),
                      n_stereo=np.arange(5, dtype=np.int32), n_temporal=np.arange(5, dtype=np.int32),
                      n_inliers=np.arange(5, dtype=np.int32), pose_ok=np.arange(5) % 2 == 0,
                      ess_angle_err=np.zeros(5, np.float32))
    rows = stepoutput_rows(StepOutput(*(torch.tensor(x) for x in outs)), t_offset=3)
    assert rows == jax_stepoutput_rows(outs, t_offset=3)
    write_jsonl(tmp_path / "a.jsonl", rows[:2])
    write_jsonl(tmp_path / "a.jsonl", rows[2:], append=True)
    assert read_jsonl(tmp_path / "a.jsonl") == rows


def _tiny_cfg(tmp_path) -> str:
    """configs/c1_cpu_smoke.json at 128 features and 128 hypotheses."""
    cfg = json.loads((ROOT / "configs/c1_cpu_smoke.json").read_text())
    cfg["pipeline"]["frontend"]["max_features"] = 128
    cfg["pipeline"]["ransac"]["n_hyps"] = 128
    p = tmp_path / "c1_tiny.json"
    p.write_text(json.dumps(cfg))
    return str(p)


def _fault_and_resume(tmp_path, extra):
    """An uninterrupted run in this process; a run killed after frame 5 and
    its resume, each a process of its own. Returns both output dirs."""
    out_a, out_b = tmp_path / "full", tmp_path / "faulted"
    args = ["--config", _tiny_cfg(tmp_path), "--device", "cpu", "--mode", "f2f",
            "--ckpt-every", "4", *extra]
    assert cli.main(args + ["--out", str(out_a)]) == 0
    base = [sys.executable, "-m", "sosvo_torch.cli", *args, "--out", str(out_b)]
    r = subprocess.run(base + ["--fault-inject", "5"], capture_output=True, text=True, cwd=ROOT,
                       env=ONE_THREAD)
    assert r.returncode == 42, (r.returncode, r.stderr[-2000:])
    assert latest_step(out_b / "ckpt") == 8
    r = subprocess.run(base + ["--resume"], capture_output=True, text=True, cwd=ROOT,
                       env=ONE_THREAD)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed from checkpoint at frame 8" in r.stdout
    return out_a, out_b


def test_cli_fault_resume(tmp_path):
    """Kill the command line mid-replay, resume: the identical JSONL log."""
    out_a, out_b = _fault_and_resume(tmp_path, [])
    a = (out_a / "frames.jsonl").read_text()
    assert a == (out_b / "frames.jsonl").read_text()
    assert len(a.splitlines()) == 10


def test_cli_fault_resume_pgo(tmp_path):
    """Resume + PGO consumes the checkpointed estimated trajectory: the
    resumed run's loops and ATE equal the uninterrupted run's."""
    out_a, out_b = _fault_and_resume(tmp_path, ["--pgo"])
    rep_a = json.loads((out_a / "report.json").read_text())
    rep_b = json.loads((out_b / "report.json").read_text())
    assert rep_a["pgo_loops"] == rep_b["pgo_loops"]
    assert rep_a["ate_rmse_m"] == rep_b["ate_rmse_m"], (rep_a, rep_b)
    assert (out_a / "frames.jsonl").read_text() == (out_b / "frames.jsonl").read_text()


def test_cli_fault_resume_adaptive_pgo(tmp_path):
    """configs/c3_adaptive.json cut to size (observation mode, 24 frames,
    K=H=L=128, 6 candidates, 10 inliers; its keyframe thresholds as
    written) killed after frame 16 and resumed: the resumed run's PGO gets
    the scan's adaptive keyframe set, whole. Its final keyframe flags
    (`kf_*.npy`, the prefix read from the checkpoint and the flags it
    replayed) equal the uninterrupted run's, cover every frame and are not
    the stride set; the log is byte for byte the same, and so are the
    report's loops and ATE."""
    cfg = json.loads((ROOT / "configs/c3_adaptive.json").read_text())
    cfg["run"].update(n_frames=24, n_landmarks=4096)
    pipe = cfg["pipeline"]
    pipe.update(mode="observations", frontend={"max_features": 128}, ransac={"n_hyps": 128},
                ba={"window": 5, "max_landmarks": 128, "iters": 5}, loop_candidates=6,
                loop_min_inliers=10)
    path = tmp_path / "c3_adaptive_tiny.json"
    path.write_text(json.dumps(cfg))
    out_a, out_b = tmp_path / "full", tmp_path / "faulted"
    args = ["--config", str(path), "--device", "cpu", "--ckpt-every", "8"]
    assert cli.main(args + ["--out", str(out_a)]) == 0
    base = [sys.executable, "-m", "sosvo_torch.cli", *args, "--out", str(out_b)]
    r = subprocess.run(base + ["--fault-inject", "10"], capture_output=True, text=True, cwd=ROOT,
                       env=ONE_THREAD)
    assert r.returncode == 42, (r.returncode, r.stderr[-2000:])
    assert latest_step(out_b / "ckpt") == 16
    r = subprocess.run(base + ["--resume"], capture_output=True, text=True, cwd=ROOT,
                       env=ONE_THREAD)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed from checkpoint at frame 16" in r.stdout
    flags_a, flags_b = (np.load(d / "ckpt" / "kf_00000024.npy") for d in (out_a, out_b))
    np.testing.assert_array_equal(flags_b[:16], np.load(out_a / "ckpt" / "kf_00000016.npy"))
    np.testing.assert_array_equal(flags_b, flags_a)
    assert len(flags_a) == 24 and flags_a.sum() >= 2
    assert not np.array_equal(np.nonzero(flags_a)[0], np.arange(0, 24, 4)), flags_a
    rep_a = json.loads((out_a / "report.json").read_text())
    rep_b = json.loads((out_b / "report.json").read_text())
    assert (rep_a["pgo_loops"], rep_a["ate_rmse_m"]) == (rep_b["pgo_loops"], rep_b["ate_rmse_m"])
    assert (out_a / "frames.jsonl").read_bytes() == (out_b / "frames.jsonl").read_bytes()
    print(f"adaptive keyframes {np.nonzero(flags_a)[0].tolist()}, report {rep_b}")


def test_cli_batched_runs_both_modes(tmp_path):
    """The batched branch (dist.data_parallel > 1) runs end to end in f2f
    and BA modes and reports every lane."""
    cfg = {
        "run": {"n_frames": 6, "n_landmarks": 2048, "n_sequences": 2},
        "pipeline": {
            "frontend": {"max_features": 128},
            "ransac": {"n_hyps": 128},
            "ba": {"window": 3, "max_landmarks": 256, "iters": 2, "use_pallas_schur": False},
            "dist": {"data_parallel": 2},
            "mode": "observations",
            "keyframe_every": 3,
        },
    }
    p = tmp_path / "c4_tiny.json"
    p.write_text(json.dumps(cfg))
    for mode in ("f2f", "ba"):
        out = tmp_path / f"out_{mode}"
        assert cli.main(["--config", str(p), "--device", "cpu", "--mode", mode,
                         "--out", str(out)]) == 0
        rep = json.loads((out / "report.json").read_text())
        assert rep["mode"] == f"batched-{mode}"
        assert rep["n_sequences"] == 2
        assert all(a < 0.05 for a in rep["ate_per_sequence"]), rep
        rows = read_jsonl(out / "frames.jsonl")
        assert len(rows) == 6 and all(r["pose_ok"] for r in rows[1:])


NOT_BATCHED = (ValueError, "non-batched only")


@pytest.mark.parametrize("extra, pipeline, error", [
    (["--sequence", "capture.npz"], {"dist": {"data_parallel": 2}},
     (ValueError, "observation-mode")),
    (["--rig", "rig.json"], {}, (ValueError, "with --sequence")),
    (["--viz"], {}, (ImportError, "matplotlib")),
    (["--pgo"], {"dist": {"data_parallel": 2}}, NOT_BATCHED),
    ([], {"dist": {"data_parallel": 2}, "pose_graph": True}, NOT_BATCHED),
    (["--source", "images"], {"dist": {"data_parallel": 2}}, (ValueError, "observation-mode")),
    (["--verify-sharded"], {}, (ValueError, "model_parallel > 1"))],
    ids=["sequence", "rig", "viz", "batched_pgo", "batched_pose_graph", "batched_images",
         "verify_unsharded"])
def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, extra, pipeline, error):
    """An option or setting the run cannot take raises before anything
    runs: --viz where matplotlib does not import (hidden here, as on a
    machine without it), PGO or the image source (a staged capture too)
    with the batched replay, as the batched branch runs neither, --rig
    without --sequence (it is the rig of a staged capture), and
    --verify-sharded without a model-sharded BA replay, which leaves it
    nothing to check. None is ignored. (The model-sharded replay,
    --verify-sharded and sharded loop closing run:
    tests/test_torch_dist_cli.py; --viz with matplotlib:
    tests/test_torch_viz.py.)"""
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # any `import matplotlib` raises
    cfg = json.loads(Path(_tiny_cfg(tmp_path)).read_text())
    cfg["pipeline"].update(pipeline)
    p = tmp_path / "c.json"
    p.write_text(json.dumps(cfg))
    exc, match = error
    with pytest.raises(exc, match=match):
        cli.main(["--config", str(p), "--device", "cpu", "--out", str(tmp_path / "o"), *extra])
    assert not (tmp_path / "o").exists()


# A staged capture: the command line's room rendered by the port along
# make_trajectory(6, radius=0.4) through default_rig(384), quantised to 8
# bits as a PGM capture holds it, with the trajectory as its ground truth;
# the JAX image tests' frontend at 384 px (K=384, a 96x768 panorama).
SEQ_F, SEQ_IMG = 6, 384
SEQ_CFG = {"run": {}, "pipeline": {
    "frontend": {"max_features": 384, "pano_height": 96, "pano_width": 768,
                 "descriptor_patch": 16},
    "ransac": {"n_hyps": 256}, "mode": "images",
    "ba": {"window": 3, "max_landmarks": 384, "iters": 2, "use_pallas_schur": False},
    "keyframe_every": 2}}
# The port's draws are its own generator's, the JAX command line's
# jax.random's, and over 6 frames the draws alone move the frame-to-frame
# ATE by several mm (0.0045 against 0.0089 m here): the two ATEs are held
# within SEQ_ATE_TOL of each other and each under SEQ_ATE_MAX (m).
SEQ_ATE_TOL, SEQ_ATE_MAX = 1e-2, 2e-2
# A rig file stores elevations in degrees; read back, three of the default
# rig's four bounds differ by an f32 step (the JAX package's load does the
# same). Over these 6 frames that moves positions by about 1e-6 m and one
# RANSAC inlier count by 1; over c2's 60 frames on the card, by millimetres
# (chip_smoke.py phase 15 prints it).
RIG_ROUND_TRIP_POS_TOL, RIG_ROUND_TRIP_COUNT_TOL = 1e-4, 2


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    from sosvo_torch.data.sequence import save_sequence
    from sosvo_torch.sensor.calib_io import save_rig
    from sosvo_torch.sensor.rig import default_rig
    from sosvo_torch.synth.scene import make_trajectory
    from sosvo_torch.tools.workload import render_frames

    d = tmp_path_factory.mktemp("capture")
    rig = default_rig(image_size=SEQ_IMG, device="cpu")
    images = render_frames(rig, SEQ_F, range(SEQ_F), "cpu").numpy()
    frames = (np.clip(images, 0, 1) * 255).astype(np.uint8).astype(np.float32) / 255.0
    save_sequence(d / "seq.npz", images=frames,
                  poses=make_trajectory(SEQ_F, radius=0.4, device="cpu").numpy())
    save_sequence(d / "no_poses.npz", images=frames)
    save_rig(d / "rig.json", rig)
    (d / "cfg.json").write_text(json.dumps(SEQ_CFG))
    runs = {}
    for mode in ("f2f", "ba"):
        for rig_args in ((), ("--rig", str(d / "rig.json"))):
            out = d / f"torch_{mode}{'_rig' if rig_args else ''}"
            assert cli.main(["--config", str(d / "cfg.json"), "--device", "cpu", "--mode", mode,
                             "--sequence", str(d / "seq.npz"), "--out", str(out),
                             *rig_args]) == 0
            runs[out.name] = out
    return d, runs


def _run_jax_cli(argv):
    """The JAX command line in this process, its compilation-cache settings
    left to the test session's (tests/conftest.py)."""
    import jax

    from sosvo import cli as jax_cli

    update = jax.config.update
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.config, "update", lambda k, v: None if k.startswith(
            ("jax_compilation_cache", "jax_persistent_cache", "jax_platforms")) else update(k, v))
        assert jax_cli.main(argv) == 0


@pytest.mark.parametrize("mode, with_rig", [("f2f", False), ("ba", True)],
                         ids=["f2f", "ba_rig"])
def test_cli_sequence_against_jax_cli(tmp_path, capture, mode, with_rig):
    """The port's --sequence replay (with or without --rig) against the JAX
    command line on the same bundle: the same frames, report keys (the
    port's add `world`), every frame tracked in both, ATEs within
    SEQ_ATE_TOL of each other and under SEQ_ATE_MAX."""
    d, runs = capture
    rig_args = ["--rig", str(d / "rig.json")] if with_rig else []
    _run_jax_cli(["--config", str(d / "cfg.json"), "--platform", "cpu", "--mode", mode,
                  "--sequence", str(d / "seq.npz"), "--out", str(tmp_path / "jax"), *rig_args])
    ref = json.loads((tmp_path / "jax" / "report.json").read_text())
    out = runs[f"torch_{mode}{'_rig' if with_rig else ''}"]
    got = json.loads((out / "report.json").read_text())
    assert set(ref) <= set(got) and got["mode"] == ref["mode"] == mode
    assert got["frames"] == ref["frames"] == SEQ_F
    rows, ref_rows = read_jsonl(out / "frames.jsonl"), read_jsonl(tmp_path / "jax" / "frames.jsonl")
    assert [r["frame"] for r in rows] == [r["frame"] for r in ref_rows] == list(range(SEQ_F))
    assert all(r["pose_ok"] for r in rows[1:]) and all(r["pose_ok"] for r in ref_rows[1:])
    print(f"{mode} rig={with_rig}: ATE port {got['ate_rmse_m']} JAX {ref['ate_rmse_m']}")
    assert abs(got["ate_rmse_m"] - ref["ate_rmse_m"]) < SEQ_ATE_TOL
    assert max(got["ate_rmse_m"], ref["ate_rmse_m"]) < SEQ_ATE_MAX


@pytest.mark.parametrize("mode", ["f2f", "ba"])
def test_cli_sequence_rig_file(capture, mode):
    """--rig with the default rig's file replays as the default rig does,
    but for the file's degrees round trip: pose_ok equal on every frame,
    counts within RIG_ROUND_TRIP_COUNT_TOL, positions within
    RIG_ROUND_TRIP_POS_TOL."""
    _, runs = capture
    a = read_jsonl(runs[f"torch_{mode}"] / "frames.jsonl")
    b = read_jsonl(runs[f"torch_{mode}_rig"] / "frames.jsonl")
    assert len(a) == len(b) == SEQ_F
    for ra, rb in zip(a, b):
        assert (ra["frame"], ra["pose_ok"]) == (rb["frame"], rb["pose_ok"])
        assert all(abs(ra[k] - rb[k]) <= RIG_ROUND_TRIP_COUNT_TOL
                   for k in ("n_stereo", "n_temporal", "n_inliers"))
        assert max(abs(x - y) for x, y in zip(ra["pos"], rb["pos"])) < RIG_ROUND_TRIP_POS_TOL


def test_cli_sequence_without_poses(tmp_path, capture):
    """A bundle without ground truth: the replay starts at identity, every
    frame is logged, and ATE and RPE are null."""
    d, _ = capture
    assert cli.main(["--config", str(d / "cfg.json"), "--device", "cpu", "--mode", "ba",
                     "--sequence", str(d / "no_poses.npz"), "--out", str(tmp_path)]) == 0
    rep = json.loads((tmp_path / "report.json").read_text())
    assert rep["frames"] == SEQ_F
    assert rep["ate_rmse_m"] is None and rep["rpe_t_m"] is None and rep["rpe_r_rad"] is None
    rows = read_jsonl(tmp_path / "frames.jsonl")
    assert rows[0]["pos"] == [0.0, 0.0, 0.0] and all(r["pose_ok"] for r in rows[1:])


def test_cli_sequence_refuses_non_square_frames(tmp_path):
    from sosvo_torch.data.sequence import save_sequence

    save_sequence(tmp_path / "wide.npz", images=np.zeros((2, 32, 48), np.float32))
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(SEQ_CFG))
    with pytest.raises(ValueError, match="square"):
        cli.main(["--config", str(p), "--device", "cpu", "--sequence", str(tmp_path / "wide.npz"),
                  "--out", str(tmp_path / "o")])
