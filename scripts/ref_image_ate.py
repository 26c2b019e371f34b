#!/usr/bin/env python
"""The JAX package's ATE for the image-mode c2 and c3 presets, on the CPU.

    JAX_PLATFORMS=cpu python scripts/ref_image_ate.py [--presets c2 c3] [--seeds 0 1 2]

Each preset runs as `sosvo/cli.py` runs it in image mode with `--mode ba`:
the CLI's room (`RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6,
texture_scale=2.0)`) rendered along `make_trajectory(n_frames, radius=0.4)`
through `default_rig()` at 768x768, panorama / Harris / BRIEF extraction in
chunks of the preset's `render_chunk` (64), then the keyframed window-BA
replay. c3 (`pose_graph: true`) then closes loops over the replay's own
keyframes with the preset's 160 candidates, 300 inliers and DCS 0.1,
min_gap 3, 10 iterations. The rendered sequence and its observations do not
depend on the seed: seed s only seeds the replay's RANSAC draws with
PRNGKey(s + 2), so seed 0 is the CLI's own run. Prints one JSON line per
(preset, seed): ATE of the BA replay, pose_ok, keyframes and, for c3, the
ATE after the loop leg and n_loops. These are the reference figures the
image-mode replays of the PyTorch port (`chip_smoke.py` 7b, 7c) are held
against.
"""

import sys as _sys
from pathlib import Path as _Path
_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))

import argparse
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from sosvo.eval.ate import ate_rmse
from sosvo.frontend.image_frontend import build_frontend_luts, extract_observations
from sosvo.sensor.rig import default_rig
from sosvo.synth.render import RoomScene, render_sequence
from sosvo.synth.scene import make_trajectory
from sosvo.utils.config import load_pipeline_config
from sosvo.vo.ba_pipeline import init_ba_state, run_replay_ba
from sosvo.vo.loop_closure import pgo_refine_trajectory

CONFIGS = _Path(__file__).resolve().parents[1] / "configs"
PRESETS = {"c2": "c2_chip_ba.json", "c3": "c3_host_pgo.json"}
ROOM = RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6, texture_scale=2.0)


def extract_sequence(rig, cfg, poses, chunk: int):
    """The CLI's chunked render + extract (tail chunk padded with the last pose)."""
    luts = build_frontend_luts(rig, cfg.frontend)
    n = poses.shape[0]
    chunk = min(chunk, n)
    fn = jax.jit(lambda P: jax.lax.map(
        lambda im: extract_observations(rig, luts, cfg.frontend, im),
        render_sequence(rig, P, ROOM)))
    n_pad = (-n) % chunk
    poses_p = jnp.concatenate([poses, jnp.tile(poses[-1:], (n_pad, 1, 1))]) if n_pad else poses
    parts = [fn(poses_p[f0:f0 + chunk]) for f0 in range(0, n + n_pad, chunk)]
    return jax.tree.map(lambda *xs: jnp.concatenate(xs)[:n], *parts)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--presets", nargs="+", default=["c2", "c3"], choices=sorted(PRESETS))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    rig = default_rig()
    for name in args.presets:
        path = CONFIGS / PRESETS[name]
        cfg = load_pipeline_config(path)
        run = json.loads(path.read_text())["run"]
        n_frames = run["n_frames"]
        poses = make_trajectory(n_frames, radius=0.4)
        t0 = time.perf_counter()
        obs = jax.block_until_ready(extract_sequence(rig, cfg, poses,
                                                     int(run.get("render_chunk", 64))))
        extract_s = time.perf_counter() - t0
        gt = poses[1:, :3, 3]
        replay = jax.jit(lambda s, o: run_replay_ba(rig, cfg, s, o))
        for seed in args.seeds:
            t0 = time.perf_counter()
            _, outs = jax.block_until_ready(
                replay(init_ba_state(cfg, jax.random.PRNGKey(seed + 2), T0=poses[0]), obs))
            T_vo = outs.vo.T_world
            kf_idx = np.nonzero(np.asarray(outs.is_keyframe))[0]
            row = {"preset": name, "seed": seed, "platform": jax.devices()[0].platform,
                   "frames": n_frames, "K": cfg.frontend.max_features,
                   "ate_ba_m": float(ate_rmse(T_vo[1:, :3, 3], gt)[0]),
                   "pose_ok": int(np.asarray(outs.vo.pose_ok)[1:].sum()),
                   "keyframes": len(kf_idx),
                   "extract_s_with_compile": extract_s,
                   "replay_s_with_compile": time.perf_counter() - t0}
            if cfg.pose_graph:
                t0 = time.perf_counter()
                T_pgo, n_loops = pgo_refine_trajectory(
                    rig, cfg, obs, T_vo, min_gap=3, min_inliers=cfg.loop_min_inliers,
                    max_candidates=cfg.loop_candidates or None, robust=cfg.pgo_robust,
                    robust_delta=cfg.pgo_robust_delta, kf_idx=kf_idx)
                T_pgo = jax.block_until_ready(T_pgo)
                row.update(ate_after_pgo_m=float(ate_rmse(T_pgo[1:, :3, 3], gt)[0]),
                           n_loops=int(n_loops),
                           leg_s_with_compile=time.perf_counter() - t0)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
