#!/usr/bin/env python
"""The JAX package's ATE for the image-mode presets with the SIFT and AKAZE
descriptor options, on the CPU.

    JAX_PLATFORMS=cpu python scripts/ref_descriptor_ate.py [--runs c2_sift c2_akaze c3_sift]
                                                          [--seeds 0 1 2]
                                                          [--shifts 1e-7 -1e-7 3e-7 -3e-7]

Each run is a preset as `sosvo/cli.py` runs it in image mode with `--mode
ba`, with `frontend.descriptor` replaced: the same room, trajectory, rig and
chunked render + extract as `scripts/ref_image_ate.py` (whose helpers this
script imports), then the keyframed window-BA replay; c3 (`pose_graph:
true`) then closes loops over the replay's own keyframes with the preset's
160 candidates, 300 inliers and DCS 0.1, min_gap 3, 10 iterations. The runs:
  * c2_sift:  configs/c2_chip_ba.json with descriptor "sift";
  * c2_akaze: configs/c2_chip_ba.json with descriptor "akaze";
  * c3_sift:  configs/c3_host_pgo.json with descriptor "sift", and its leg.
The rendered sequence and its observations do not depend on the seed: seed
s only seeds the replay's RANSAC draws with PRNGKey(s + 2), so seed 0 is the
command line's own run.

The seeds measure only the RANSAC draws. The rendered room is a checker
texture, and a pixel whose hit point lies within rounding of a cell edge
takes either cell's value (0.25 apart) depending on how the trigonometry
rounds (tests/test_torch_render.py counts such pixels between the two
packages; the card and the CPU differ the same way). Keypoints sit on those
edges, so these presets' ATE moves with the rounding of the render. Each
`--shifts` value re-renders the sequence with every pose translated by that
many metres along x (0.1-0.3 um: a few f32 steps of the camera position)
and replays it with seed 0: the reference's own spread under rounding-sized
changes of its input.

Prints one JSON line per (run, shift, seed). These are the reference
figures `chip_smoke.py` phases 14c-14e hold the port to: the worst of all
of a run's rows plus twice their spread.
"""

import sys as _sys
from pathlib import Path as _Path
_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))
_sys.path.insert(0, str(_Path(__file__).resolve().parent))

import argparse
import dataclasses
import json
import time

import jax
import numpy as np

from ref_image_ate import CONFIGS, extract_sequence

from sosvo.eval.ate import ate_rmse
from sosvo.sensor.rig import default_rig
from sosvo.synth.scene import make_trajectory
from sosvo.utils.config import load_pipeline_config
from sosvo.vo.ba_pipeline import init_ba_state, run_replay_ba
from sosvo.vo.loop_closure import pgo_refine_trajectory

RUNS = {"c2_sift": ("c2_chip_ba.json", "sift"), "c2_akaze": ("c2_chip_ba.json", "akaze"),
        "c3_sift": ("c3_host_pgo.json", "sift")}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", nargs="+", default=list(RUNS), choices=list(RUNS))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--shifts", type=float, nargs="*", default=[1e-7, -1e-7, 3e-7, -3e-7],
                    help="render shifts (m) replayed with the first seed")
    args = ap.parse_args()
    rig = default_rig()
    for name in args.runs:
        preset, descriptor = RUNS[name]
        path = CONFIGS / preset
        cfg = load_pipeline_config(path)
        cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                    descriptor=descriptor))
        run = json.loads(path.read_text())["run"]
        n_frames = run["n_frames"]
        poses = make_trajectory(n_frames, radius=0.4)
        gt = poses[1:, :3, 3]
        replay = jax.jit(lambda s, o: run_replay_ba(rig, cfg, s, o))
        for shift, seed in [(0.0, s) for s in args.seeds] + [(x, args.seeds[0])
                                                               for x in args.shifts]:
            if seed == args.seeds[0]:  # a new rendering
                t0 = time.perf_counter()
                obs = jax.block_until_ready(extract_sequence(
                    rig, cfg, poses.at[:, 0, 3].add(shift), int(run.get("render_chunk", 64))))
                extract_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, outs = jax.block_until_ready(
                replay(init_ba_state(cfg, jax.random.PRNGKey(seed + 2), T0=poses[0]), obs))
            T_vo = outs.vo.T_world
            kf_idx = np.nonzero(np.asarray(outs.is_keyframe))[0]
            row = {"run": name, "preset": preset, "descriptor": descriptor, "seed": seed,
                   "render_shift_m": shift,
                   "platform": jax.devices()[0].platform, "frames": n_frames,
                   "K": cfg.frontend.max_features,
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
