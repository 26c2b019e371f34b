#!/usr/bin/env python
"""The JAX package's ATE before and after the c3_long_mesh loop-closing leg,
on the CPU.

    JAX_PLATFORMS=cpu python scripts/ref_c3_long_ate.py [--seeds 0 1 2]

configs/c3_long_mesh.json as `sosvo/cli.py` runs it on the 8-device virtual
CPU mesh (observation mode, 1024 frames, 16384 scene landmarks, K=512,
H=256, W=5, L=512, 3 iterations, stride-8 keyframes, 256 candidates, 60
inliers, `dist.pgo_shards` 8; 0.3 px noise and 2 % descriptor bit flips):
the scene and observations from `PRNGKey(seed)` and `PRNGKey(seed + 1)`,
the replay state from `PRNGKey(seed + 2)`. Each seed is replayed with
keyframed window BA (the CLI's default `--mode ba`, whose leg takes the BA
replay's own keyframes) and frame to frame (stride keyframes), and each
replay then closes loops with `sosvo.dist.c3_dist.pgo_refine_trajectory_sharded`
on `data_mesh(8)`, as the CLI does. Seed 0 is the CLI's own run. Prints one
JSON line per (seed, replay): ATE before and after the leg, n_loops,
keyframes; then per replay the limit the PyTorch port's leg over the same
replay (`chip_smoke.py` phase 13) is held to: the worst ATE after the leg
over the seeds plus twice their spread.
"""

import os
import sys as _sys
from pathlib import Path as _Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))

import argparse
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from sosvo.dist.c3_dist import pgo_refine_trajectory_sharded
from sosvo.dist.mesh import data_mesh
from sosvo.eval.ate import ate_rmse
from sosvo.sensor.rig import default_rig
from sosvo.synth.scene import make_scene, observe_sequence
from sosvo.utils.config import load_pipeline_config
from sosvo.vo.ba_pipeline import init_ba_state, run_replay_ba
from sosvo.vo.pipeline import run_replay
from sosvo.vo.state import init_track_state

PRESET = _Path(__file__).resolve().parents[1] / "configs" / "c3_long_mesh.json"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--replays", nargs="+", default=["ba", "f2f"], choices=["ba", "f2f"])
    args = ap.parse_args()
    cfg = load_pipeline_config(PRESET)
    run = json.loads(PRESET.read_text())["run"]
    n_frames, k = run["n_frames"], cfg.frontend.max_features
    rig = default_rig()
    mesh = data_mesh(min(cfg.dist.pgo_shards, len(jax.devices())))
    f2f = jax.jit(lambda s, o: run_replay(rig, cfg, s, o))
    ba = jax.jit(lambda s, o: run_replay_ba(rig, cfg, s, o))
    after = {name: [] for name in args.replays}
    for seed in args.seeds:
        scene = make_scene(jax.random.PRNGKey(seed), n_frames=n_frames,
                           n_landmarks=run["n_landmarks"])
        obs = observe_sequence(rig, scene, k, jax.random.PRNGKey(seed + 1),
                               pixel_noise=0.3, desc_flip_prob=0.02)
        gt = scene.poses[1:, :3, 3]
        for name in args.replays:
            key = jax.random.PRNGKey(seed + 2)
            t0 = time.perf_counter()
            if name == "f2f":
                _, outs = jax.block_until_ready(f2f(init_track_state(k, key, T0=scene.poses[0]),
                                                    obs))
                T_vo, kf_idx, pose_ok = outs.T_world, None, outs.pose_ok
            else:
                _, outs = jax.block_until_ready(ba(init_ba_state(cfg, key, T0=scene.poses[0]),
                                                   obs))
                T_vo, pose_ok = outs.vo.T_world, outs.vo.pose_ok
                kf_idx = np.nonzero(np.asarray(outs.is_keyframe))[0]
            t1 = time.perf_counter()
            T_pgo, n_loops = pgo_refine_trajectory_sharded(
                mesh, rig, cfg, obs, T_vo, min_gap=3, min_inliers=cfg.loop_min_inliers,
                max_candidates=cfg.loop_candidates or None, robust=cfg.pgo_robust,
                robust_delta=cfg.pgo_robust_delta, kf_idx=kf_idx)
            T_pgo = jax.block_until_ready(T_pgo)
            after[name].append(float(ate_rmse(T_pgo[1:, :3, 3], gt)[0]))
            n_kf = len(range(0, n_frames, cfg.keyframe_every)) if kf_idx is None else len(kf_idx)
            print(json.dumps({
                "seed": seed, "replay": name, "platform": jax.devices()[0].platform,
                "pgo_shards": mesh.shape["data"], "keyframes": n_kf,
                "pose_ok": int(np.asarray(pose_ok)[1:].sum()),
                "ate_before_m": float(ate_rmse(T_vo[1:, :3, 3], gt)[0]),
                "ate_after_m": float(ate_rmse(T_pgo[1:, :3, 3], gt)[0]),
                "n_loops": int(n_loops), "replay_s_with_compile": t1 - t0,
                "leg_s_with_compile": time.perf_counter() - t1}), flush=True)
    for name, ates in after.items():
        worst, spread = max(ates), max(ates) - min(ates)
        print(json.dumps({"replay": name, "seeds": args.seeds, "worst_ate_after_m": worst,
                          "spread_m": spread, "limit_m": worst + 2 * spread}), flush=True)


if __name__ == "__main__":
    main()
