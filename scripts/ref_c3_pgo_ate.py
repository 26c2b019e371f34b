#!/usr/bin/env python
"""The JAX package's ATE for the c3 loop-closure leg at c3's sizes, on the CPU.

    JAX_PLATFORMS=cpu python scripts/ref_c3_pgo_ate.py [--seeds 0 1 2]

configs/c3_host_pgo.json in observation mode (K=2048, H=1024, W=5, L=1024,
200 frames, 16384 landmarks, 0.3 px noise and 2 % bit flips as bench.py
draws them), one scene per seed: PRNGKey(seed) for the scene, seed + 1 for
the observations, seed + 2 for the replay. Each seed is replayed frame to
frame and with keyframed window BA, and each replay then closes loops as
`sosvo/cli.py` does after a c3 replay: `pgo_refine_trajectory` with the
preset's 160 candidates, 300 inliers and DCS 0.1, min_gap 3, 10 iterations,
stride keyframes after the frame-to-frame replay and the BA replay's own
keyframes after it. Prints one JSON line per (seed, replay): ATE before and
after, n_loops, keyframes. These are the reference figures the c3 legs of
the PyTorch port are held against.
"""

import sys as _sys
from pathlib import Path as _Path
_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))

import argparse
import dataclasses
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from sosvo.eval.ate import ate_rmse
from sosvo.sensor.rig import default_rig
from sosvo.synth.scene import make_scene, observe_sequence
from sosvo.utils.config import load_pipeline_config
from sosvo.vo.ba_pipeline import init_ba_state, run_replay_ba
from sosvo.vo.loop_closure import pgo_refine_trajectory
from sosvo.vo.pipeline import run_replay
from sosvo.vo.state import init_track_state

PRESET = _Path(__file__).resolve().parents[1] / "configs" / "c3_host_pgo.json"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    cfg = dataclasses.replace(load_pipeline_config(PRESET), mode="observations")
    run = json.loads(PRESET.read_text())["run"]
    n_frames, k = run["n_frames"], cfg.frontend.max_features
    rig = default_rig()
    f2f = jax.jit(lambda s, o: run_replay(rig, cfg, s, o))
    ba = jax.jit(lambda s, o: run_replay_ba(rig, cfg, s, o))
    for seed in args.seeds:
        scene = make_scene(jax.random.PRNGKey(seed), n_frames=n_frames,
                           n_landmarks=run["n_landmarks"])
        obs = observe_sequence(rig, scene, k, jax.random.PRNGKey(seed + 1),
                               pixel_noise=0.3, desc_flip_prob=0.02)
        gt = scene.poses[1:, :3, 3]
        for name in ("f2f", "ba"):
            key = jax.random.PRNGKey(seed + 2)
            if name == "f2f":
                _, outs = f2f(init_track_state(k, key, T0=scene.poses[0]), obs)
                T_vo, kf_idx = outs.T_world, None
            else:
                _, outs = ba(init_ba_state(cfg, key, T0=scene.poses[0]), obs)
                T_vo, kf_idx = outs.vo.T_world, np.nonzero(np.asarray(outs.is_keyframe))[0]
            t0 = time.perf_counter()
            T_pgo, n_loops = pgo_refine_trajectory(
                rig, cfg, obs, T_vo, min_gap=3, min_inliers=cfg.loop_min_inliers,
                max_candidates=cfg.loop_candidates or None, robust=cfg.pgo_robust,
                robust_delta=cfg.pgo_robust_delta, kf_idx=kf_idx)
            T_pgo = jax.block_until_ready(T_pgo)
            n_kf = len(range(0, n_frames, cfg.keyframe_every)) if kf_idx is None else len(kf_idx)
            print(json.dumps({
                "seed": seed, "replay": name, "platform": jax.devices()[0].platform,
                "keyframes": n_kf,
                "ate_before_m": float(ate_rmse(T_vo[1:, :3, 3], gt)[0]),
                "ate_after_m": float(ate_rmse(T_pgo[1:, :3, 3], gt)[0]),
                "n_loops": int(n_loops), "leg_s_with_compile": time.perf_counter() - t0}),
                flush=True)


if __name__ == "__main__":
    main()
