"""The synthetic workloads of chip_smoke.py and the tools.

An observation-mode workload is a config preset from `configs/` in
observation mode, a scene and its per-frame observations at 0.3 px pixel
noise and 2 % descriptor bit flips (bench.py's), all drawn from one seeded
generator on the device. It is replayed frame to frame (`replayer`) or with
keyframed window BA (`ba_replayer`). A batched workload
(`make_batched_workload`, config c4) is S such scenes, one generator per
lane, replayed in lockstep by `batched_replayer`. An image-mode workload
(`make_image_workload`) is a preset as written, `"mode": "images"`: the
room and trajectory of `sosvo/cli.py` rendered on the device, the frontend's
LUTs and the extracted observations. `pgo_leg` closes loops over a
replayed trajectory as the JAX package's c3 command line does after its
replay.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from sosvo_torch.frontend.image_frontend import build_frontend_luts, extract_sequence
from sosvo_torch.sensor.rig import default_rig
from sosvo_torch.synth.render import RoomScene, render_sequence
from sosvo_torch.synth.scene import FrameObservations, make_scene, make_trajectory, observe_sequence
from sosvo_torch.utils.config import PipelineConfig, load_pipeline_config
from sosvo_torch.vo.ba_pipeline import init_ba_state, run_replay_ba
from sosvo_torch.vo.batched import (init_batched_ba_states, init_batched_states, lane_generators,
                                    run_replay_ba_batched, run_replay_batched)
from sosvo_torch.vo.image_pipeline import run_replay_images_ba
from sosvo_torch.vo.loop_closure import LoopClosure, close_loops
from sosvo_torch.vo.pipeline import run_replay
from sosvo_torch.vo.state import init_track_state, stack_lanes

CONFIGS = Path(__file__).resolve().parents[2] / "configs"
PIXEL_NOISE = 0.3
DESC_FLIP = 0.02
SEED = 0
ROOM = RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6, texture_scale=2.0)  # sosvo/cli.py's
TRAJECTORY_RADIUS = 0.4                                                      # sosvo/cli.py's
# The c4 batched replay's lane counts, and the first frames of it that
# `profile_replay --batched` profiles and `sync_check` counts.
BATCHED_LANES = (1, 2, 4, 8)
BATCHED_PROFILED_FRAMES = 20


def load_preset(name: str) -> tuple[PipelineConfig, dict]:
    """(config in observation mode, its "run" block) of configs/<name>.json."""
    path = CONFIGS / f"{name}.json"
    cfg = dataclasses.replace(load_pipeline_config(path), mode="observations")
    return cfg, json.loads(path.read_text())["run"]


def load_image_preset(name: str) -> tuple[PipelineConfig, dict]:
    """(config as written, its "run" block) of an image-mode preset."""
    path = CONFIGS / f"{name}.json"
    cfg = load_pipeline_config(path)
    if cfg.mode != "images":
        raise ValueError(f"configs/{name}.json is not an image-mode preset")
    return cfg, json.loads(path.read_text())["run"]


def render_frames(rig, n_frames: int, frames, device) -> torch.Tensor:
    """The CLI's room rendered at `frames` of its n_frames-long trajectory."""
    poses = make_trajectory(n_frames, radius=TRAJECTORY_RADIUS, device=device)
    return render_sequence(rig, poses[list(frames)], ROOM)


def make_image_workload(cfg: PipelineConfig, n_frames: int, device, chunk: int = 64,
                        keep_images: bool = True):
    """(rig, ground-truth poses, rendered images, LUTs, observations) of an
    image-mode preset on `device`: the CLI's room along its trajectory
    through `default_rig()` (768 x 768), rendered and extracted `chunk`
    frames at a time, as the CLI does with its `render_chunk`. With
    `keep_images=False` each chunk's images are dropped once extracted
    (None in their place), so memory stays at one chunk's."""
    rig = default_rig(device=device)
    poses = make_trajectory(n_frames, radius=TRAJECTORY_RADIUS, device=device)
    luts = build_frontend_luts(rig, cfg.frontend)
    images, parts = [], []
    for f0 in range(0, n_frames, chunk):
        imgs = render_sequence(rig, poses[f0:f0 + chunk], ROOM)
        if keep_images:
            images.append(imgs)
        parts.append(extract_sequence(rig, luts, cfg.frontend, imgs))
    obs = FrameObservations(*(torch.cat(x) for x in zip(*parts)))
    return rig, poses, torch.cat(images) if keep_images else None, luts, obs


def make_workload(cfg: PipelineConfig, n_frames: int, n_landmarks: int, device,
                  pixel_noise: float = PIXEL_NOISE, desc_flip: float = DESC_FLIP):
    """(rig, scene, observations) drawn from SEED on `device`."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    rig = default_rig(device=device)
    scene = make_scene(gen, n_frames, n_landmarks, device=device)
    obs = observe_sequence(rig, scene, cfg.frontend.max_features, gen, pixel_noise, desc_flip)
    return rig, scene, obs


def make_batched_workload(cfg: PipelineConfig, n_lanes: int, n_frames: int, n_landmarks: int,
                          device, pixel_noise: float = PIXEL_NOISE, desc_flip: float = DESC_FLIP):
    """(rig, ground-truth poses (S, F, 4, 4), observations (S, F, ...)) of a
    batched workload: lane s's scene and observations are drawn from the
    generator `vo/batched.py:lane_generators(SEED, S)[s]` on `device`."""
    rig = default_rig(device=device)
    scenes, obs = [], []
    for gen in lane_generators(SEED, n_lanes, device):
        scene = make_scene(gen, n_frames, n_landmarks, device=device)
        scenes.append(scene.poses)
        obs.append(observe_sequence(rig, scene, cfg.frontend.max_features, gen, pixel_noise,
                                    desc_flip))
    return rig, torch.stack(scenes), stack_lanes(obs)


def batched_replayer(cfg: PipelineConfig, rig, gt_poses, obs, device, mode: str):
    """A function that replays a batched workload from the lanes' first
    poses (lane generators from SEED + 2), frame to frame (`mode="f2f"`) or
    with window BA (`"ba"`), and returns (final state, stacked outputs)."""
    def replay():
        if mode == "ba":
            state = init_batched_ba_states(gt_poses.shape[0], cfg, SEED + 2, T0=gt_poses[:, 0],
                                           device=device)
            return run_replay_ba_batched(rig, cfg, state, obs)
        state = init_batched_states(gt_poses.shape[0], cfg.frontend.max_features, SEED + 2,
                                    T0=gt_poses[:, 0], device=device,
                                    descriptor=cfg.frontend.descriptor)
        return run_replay_batched(rig, cfg, state, obs)
    return replay


def replayer(cfg: PipelineConfig, rig, scene, obs, device):
    """A function that replays the whole sequence from the same initial state
    (RANSAC draws from SEED + 2) and returns (final state, stacked outputs)."""
    def replay():
        gen = torch.Generator(device=device).manual_seed(SEED + 2)
        state = init_track_state(cfg.frontend.max_features, gen, T0=scene.poses[0],
                                 device=device, descriptor=cfg.frontend.descriptor)
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


def image_ba_replayer(cfg: PipelineConfig, rig, poses, images, luts, device, draws=None):
    """A function that extracts every image and replays the observations with
    keyframed window BA (`run_replay_images_ba`) from the first pose; RANSAC
    draws are `draws` (`StepDraws` stacked over frames, e.g. the JAX
    package's from `tools/reference_draws.py`), else from SEED + 2. Returns
    (final state, stacked outputs)."""
    def replay():
        gen = torch.Generator(device=device).manual_seed(SEED + 2)
        state = init_ba_state(cfg, gen, T0=poses[0], device=device)
        return run_replay_images_ba(rig, cfg, state, images, luts, draws)
    return replay


def pgo_leg(cfg: PipelineConfig, rig, obs, T_world: torch.Tensor,
            kf_idx: np.ndarray, gumbels=None) -> LoopClosure:
    """Loop closure and PGO over a replayed trajectory with the preset's
    loop settings (`loop_candidates`, 0 = all pairs, `loop_min_inliers`,
    `pgo_robust`, `pgo_robust_delta`), min_gap=3 and 10 GN iterations, as
    `sosvo/cli.py` passes them to `pgo_refine_trajectory`; RANSAC draws are
    `gumbels` (one (H, K) matrix per candidate pair), else from a generator
    seeded 17 on the trajectory's device."""
    return close_loops(rig, cfg, obs, T_world, min_gap=3, min_inliers=cfg.loop_min_inliers,
                       iters=10, max_candidates=cfg.loop_candidates or None,
                       robust=cfg.pgo_robust, robust_delta=cfg.pgo_robust_delta, kf_idx=kf_idx,
                       gumbels=gumbels)


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
