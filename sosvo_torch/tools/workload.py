"""The synthetic observation-mode workloads of chip_smoke.py and the tools.

A workload is a config preset from `configs/` in observation mode, a scene
and its per-frame observations at 0.3 px pixel noise and 2 % descriptor bit
flips (bench.py's), all drawn from one seeded generator on the device. It
is replayed frame to frame (`replayer`) or with keyframed window BA
(`ba_replayer`). `pgo_leg` closes loops over a replayed trajectory as
the JAX package's c3 command line does after its replay.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from sosvo_torch.sensor.rig import default_rig
from sosvo_torch.synth.scene import make_scene, observe_sequence
from sosvo_torch.utils.config import PipelineConfig, load_pipeline_config
from sosvo_torch.vo.ba_pipeline import init_ba_state, run_replay_ba
from sosvo_torch.vo.loop_closure import LoopClosure, close_loops
from sosvo_torch.vo.pipeline import run_replay
from sosvo_torch.vo.state import init_track_state

CONFIGS = Path(__file__).resolve().parents[2] / "configs"
PIXEL_NOISE = 0.3
DESC_FLIP = 0.02
SEED = 0


def load_preset(name: str) -> tuple[PipelineConfig, dict]:
    """(config in observation mode, its "run" block) of configs/<name>.json."""
    path = CONFIGS / f"{name}.json"
    cfg = dataclasses.replace(load_pipeline_config(path), mode="observations")
    return cfg, json.loads(path.read_text())["run"]


def make_workload(cfg: PipelineConfig, n_frames: int, n_landmarks: int, device):
    """(rig, scene, observations) drawn from SEED on `device`."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    rig = default_rig(device=device)
    scene = make_scene(gen, n_frames, n_landmarks, device=device)
    obs = observe_sequence(rig, scene, cfg.frontend.max_features, gen,
                           PIXEL_NOISE, DESC_FLIP)
    return rig, scene, obs


def replayer(cfg: PipelineConfig, rig, scene, obs, device):
    """A function that replays the whole sequence from the same initial state
    (RANSAC draws from SEED + 2) and returns (final state, stacked outputs)."""
    def replay():
        gen = torch.Generator(device=device).manual_seed(SEED + 2)
        state = init_track_state(cfg.frontend.max_features, gen, T0=scene.poses[0],
                                 device=device)
        return run_replay(rig, cfg, state, obs)
    return replay


def ba_replayer(cfg: PipelineConfig, rig, scene, obs, device):
    """`replayer` for the keyframed window-BA replay (`run_replay_ba`), from
    the same initial pose and RANSAC seed."""
    def replay():
        gen = torch.Generator(device=device).manual_seed(SEED + 2)
        state = init_ba_state(cfg, gen, T0=scene.poses[0], device=device)
        return run_replay_ba(rig, cfg, state, obs)
    return replay


def pgo_leg(cfg: PipelineConfig, rig, obs, T_world: torch.Tensor,
            kf_idx: np.ndarray) -> LoopClosure:
    """Loop closure and PGO over a replayed trajectory with the preset's
    loop settings (`loop_candidates`, 0 = all pairs, `loop_min_inliers`,
    `pgo_robust`, `pgo_robust_delta`), min_gap=3 and 10 GN iterations, as
    `sosvo/cli.py` passes them to `pgo_refine_trajectory`; RANSAC draws from
    a generator seeded 17 on the trajectory's device."""
    return close_loops(rig, cfg, obs, T_world, min_gap=3, min_inliers=cfg.loop_min_inliers,
                       iters=10, max_candidates=cfg.loop_candidates or None,
                       robust=cfg.pgo_robust, robust_delta=cfg.pgo_robust_delta, kf_idx=kf_idx)


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of `fn` over `reps` back-to-back calls (CUDA events),
    after five warm-up calls."""
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
