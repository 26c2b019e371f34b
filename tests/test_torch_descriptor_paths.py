"""The float (SIFT) descriptor through the port's other paths: the c4 lane
loop, the landmark-sharded window solve, checkpoints and the command line.

Inputs: the port's own renderer on the CPU (the CLI's room along
`make_trajectory(10, radius=0.4)` through `default_rig()`), extracted with
SIFT at a small width (K=128, a 64x512 panorama, 16 px patches, H=128).
  * The batched BA replay of two lanes (frames 0-7 and 2-9) equals each
    lane's sequential replay from the same generator: discrete outputs
    equal, poses within 1e-4 (tests/test_torch_batched.py's bound).
  * The BA replay with every window solve landmark-sharded over 2 ranks
    (gloo, CPU) equals the one-device replay with the same draws: discrete
    outputs equal, poses within 1e-3 (tests/test_torch_dist_replay.py's);
    the map's float descriptors stay replicated on every rank.
  * A SIFT BAState survives a checkpoint round trip bit for bit, and does
    not restore into a BRIEF template.
  * The command line runs a temporary image-mode config with "descriptor":
    "sift" in BA mode with --pgo, a run killed after frame 5 and resumed
    writes the uninterrupted run's log byte for byte, and a SIFT config in
    observation mode is refused.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sosvo_torch import cli
from sosvo_torch.dist.launch import launch
from sosvo_torch.frontend.image_frontend import build_frontend_luts, extract_sequence
from sosvo_torch.kernels import match_cuda
from sosvo_torch.sensor.rig import default_rig
from sosvo_torch.synth.render import render_sequence
from sosvo_torch.synth.scene import FrameObservations, make_trajectory
from sosvo_torch.tools.reference_draws import replay_draws
from sosvo_torch.tools.workload import ROOM
from sosvo_torch.utils.checkpoint import restore_state, save_state
from sosvo_torch.utils.config import BAConfig, FrontendConfig, PipelineConfig, RansacConfig
from sosvo_torch.vo import batched as tb
from sosvo_torch.vo.ba_pipeline import init_ba_state, run_replay_ba
from sosvo_torch.vo.state import lane, stack_lanes

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
FE = FrontendConfig(max_features=128, pano_height=64, pano_width=512, descriptor_patch=16,
                    descriptor="sift")
CFG = PipelineConfig(frontend=FE,
                     ransac=RansacConfig(n_hyps=128, rigid_angle_threshold=0.02,
                                         essential_threshold=0.01, min_inliers=8),
                     ba=BAConfig(window=3, max_landmarks=128, iters=2, huber_delta=0.003),
                     mode="images", keyframe_every=3)
N, F = 10, 8


@pytest.fixture(scope="module")
def world():
    rig = default_rig(device="cpu")
    poses = make_trajectory(N, radius=0.4, device="cpu")
    images = render_sequence(rig, poses, ROOM)
    obs = extract_sequence(rig, build_frontend_luts(rig, FE), FE, images)
    return dict(rig=rig, poses=poses, obs=obs)


def _lane_obs(world, first):
    return FrameObservations(*(x[first:first + F] for x in world["obs"]))


def test_batched_lanes_equal_sequential(world):
    assert world["obs"].desc_top.dtype == torch.float32
    firsts = (0, 2)
    obs = stack_lanes([_lane_obs(world, f) for f in firsts])
    T0 = torch.stack([world["poses"][f] for f in firsts])
    states = tb.init_batched_ba_states(2, CFG, 5, T0=T0, device="cpu")
    assert states.map.lm_desc.dtype == torch.float32 and states.map.lm_desc.shape == (2, 128, 128)
    match_cuda.reset_launches()
    _, batched = tb.run_replay_ba_batched(world["rig"], CFG, states, obs)
    assert match_cuda.launches == 0
    assert bool(batched.vo.pose_ok[:, 1:].all()) and bool(batched.is_keyframe.any())
    for s, gen in enumerate(tb.lane_generators(5, 2, "cpu")):
        st = init_ba_state(CFG, gen, T0=T0[s], device="cpu")
        _, seq = run_replay_ba(world["rig"], CFG, st, lane(obs, s))
        for name in ("pose_ok", "n_stereo", "n_temporal", "n_inliers"):
            assert torch.equal(getattr(batched.vo, name)[s], getattr(seq.vo, name)), (s, name)
        for name in ("is_keyframe", "n_landmarks", "reloc_tried"):
            assert torch.equal(getattr(batched, name)[s], getattr(seq, name)), (s, name)
        assert float((batched.vo.T_world[s] - seq.vo.T_world).abs().max()) < 1e-4


def test_sharded_solve_and_checkpoint_carry_float_maps(world, tmp_path):
    obs = _lane_obs(world, 0)
    h, k, l = CFG.ransac.n_hyps, FE.max_features, CFG.ba.max_landmarks
    draws = replay_draws(F, h, k, "cpu", seed=2, reloc_slots=l)
    state = init_ba_state(CFG, torch.Generator().manual_seed(2), T0=world["poses"][0],
                          device="cpu")
    final, single = run_replay_ba(world["rig"], CFG, state, obs, draws)
    assert final.map.lm_desc.dtype == torch.float32 and bool(final.map.lm_valid.any())
    assert float(single.ba_cost.max()) > 0.0
    outs = launch("tests.torch_dist_ranks:replay_sharded", 2,
                  dict(rig=world["rig"], cfg=CFG,
                       state=state._replace(track=state.track._replace(generator=None)),
                       obs=obs, draws=draws), device="cpu", timeout_s=300)
    for got, calls in outs:
        for name in ("is_keyframe", "n_landmarks"):
            assert torch.equal(getattr(got, name), getattr(single, name)), name
        for name in ("pose_ok", "n_stereo", "n_temporal"):
            assert torch.equal(getattr(got.vo, name), getattr(single.vo, name)), name
        assert float((got.vo.T_world - single.vo.T_world).abs().max()) < 1e-3
        assert calls["model.all_gather"] == int((single.ba_cost > 0).sum())

    save_state(tmp_path, F, final)
    template = init_ba_state(CFG, torch.Generator().manual_seed(9), device="cpu")
    restored = restore_state(tmp_path, F, template)
    for a, b in zip(torch.utils._pytree.tree_leaves(final), torch.utils._pytree.tree_leaves(restored)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(restored.track.generator.get_state(), final.track.generator.get_state())
    brief = dataclasses.replace(CFG, frontend=dataclasses.replace(FE, descriptor="brief"))
    with pytest.raises(ValueError, match="template"):
        restore_state(tmp_path, F, init_ba_state(brief, torch.Generator(), device="cpu"))


def _sift_config(tmp_path, mode="images") -> str:
    cfg = {"run": {"n_frames": 8, "render_chunk": 8},
           "pipeline": {"frontend": dataclasses.asdict(FE),
                        "ransac": dataclasses.asdict(CFG.ransac),
                        "ba": dataclasses.asdict(CFG.ba),
                        "mode": mode, "keyframe_every": 3, "loop_min_inliers": 10}}
    p = tmp_path / f"sift_{mode}.json"
    p.write_text(json.dumps(cfg))
    return str(p)


def test_cli_runs_sift_and_resumes(tmp_path):
    args = ["--config", _sift_config(tmp_path), "--device", "cpu", "--mode", "ba", "--pgo",
            "--ckpt-every", "4"]
    out_a, out_b = tmp_path / "full", tmp_path / "faulted"
    assert cli.main(args + ["--out", str(out_a)]) == 0
    rep = json.loads((out_a / "report.json").read_text())
    assert rep["frames"] == 8 and rep["ate_rmse_m"] < 0.05, rep
    base = [sys.executable, "-m", "sosvo_torch.cli", *args, "--out", str(out_b)]
    # one thread, as this process: on the CPU positions move by ~1e-6 m
    # with the intra-op and BLAS thread count
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    r = subprocess.run(base + ["--fault-inject", "5"], capture_output=True, text=True, cwd=ROOT,
                       env=env)
    assert r.returncode == 42, (r.returncode, r.stderr[-2000:])
    r = subprocess.run(base + ["--resume"], capture_output=True, text=True, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert (out_a / "frames.jsonl").read_text() == (out_b / "frames.jsonl").read_text()
    rep_b = json.loads((out_b / "report.json").read_text())
    assert (rep_b["pgo_loops"], rep_b["ate_rmse_m"]) == (rep["pgo_loops"], rep["ate_rmse_m"])


def test_cli_refuses_sift_observations(tmp_path):
    with pytest.raises(ValueError, match="image mode"):
        cli.main(["--config", _sift_config(tmp_path, "observations"), "--device", "cpu",
                  "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
