#!/usr/bin/env python
"""The JAX package's ATE for c2 as a staged 8-bit capture, on the CPU.

    JAX_PLATFORMS=cpu python scripts/ref_sequence_ate.py [--seeds 0 1 2]
                                                        [--shifts 1e-7 -1e-7 3e-7 -3e-7]

configs/c2_chip_ba.json (60 frames, 768x768, K=512, W=5, L=512) as
`sosvo/cli.py --mode ba --sequence BUNDLE` runs it on a capture staged by
`scripts/stage_sequence.py`: the command line's room rendered along
`make_trajectory(60, radius=0.4)` through `default_rig()`, each frame
quantised to 8 bits as the staged PGM files hold it (`(clip(im, 0, 1) *
255).astype(uint8)`, read back as `uint8 / 255.0` in float32), the ground
truth through a TUM file (`save_tum_trajectory` then
`load_tum_trajectory`, six decimals) as the bundle carries it; the replay
starts at the first ground-truth pose, with `default_rig(image_size=768)`
(no `--rig`). Frames are extracted one at a time (`lax.map`), which bounds
this script's memory (the command line vmaps them all). Seed s seeds the
replay's RANSAC draws with PRNGKey(s + 2), so seed 0 is the command line's
own run. Each `--shifts` value re-renders the sequence with every pose
translated that many metres along x and replays it with the first seed:
the render's rounding at checker edges moves these presets' ATE more than
the seed does (scripts/ref_descriptor_ate.py). The ground truth stays the
unshifted trajectory.

Prints one JSON line per (shift, seed). `chip_smoke.py` phase 15 holds the
port's staged c2 to the worst of these rows plus twice their spread.
"""

import sys as _sys
from pathlib import Path as _Path
_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))

import argparse
import json
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from sosvo.data.sequence import load_tum_trajectory, save_tum_trajectory
from sosvo.eval.ate import ate_rmse
from sosvo.frontend.image_frontend import build_frontend_luts, extract_observations
from sosvo.sensor.rig import default_rig
from sosvo.synth.render import RoomScene, render_sequence
from sosvo.synth.scene import make_trajectory
from sosvo.utils.config import load_pipeline_config
from sosvo.vo.ba_pipeline import init_ba_state, run_replay_ba

PRESET = _Path(__file__).resolve().parents[1] / "configs" / "c2_chip_ba.json"
ROOM = RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6, texture_scale=2.0)


def staged_frames(rig, poses) -> jnp.ndarray:
    """The rendered frames as an 8-bit capture stages them."""
    imgs = np.asarray(jax.jit(lambda P: render_sequence(rig, P, ROOM))(poses))
    return jnp.asarray((np.clip(imgs, 0, 1) * 255).astype(np.uint8).astype(np.float32) / 255.0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--shifts", type=float, nargs="*", default=[1e-7, -1e-7, 3e-7, -3e-7],
                    help="render shifts (m) replayed with the first seed")
    args = ap.parse_args()
    cfg = load_pipeline_config(PRESET)
    n_frames = json.loads(PRESET.read_text())["run"]["n_frames"]
    rig = default_rig(image_size=768)
    poses = make_trajectory(n_frames, radius=0.4)
    with tempfile.TemporaryDirectory() as d:
        save_tum_trajectory(_Path(d) / "gt.txt", np.asarray(poses))
        gt_poses = jnp.asarray(load_tum_trajectory(_Path(d) / "gt.txt")[1])
    gt = gt_poses[1:, :3, 3]
    luts = build_frontend_luts(rig, cfg.frontend)
    extract = jax.jit(lambda ims: jax.lax.map(
        lambda im: extract_observations(rig, luts, cfg.frontend, im), ims))
    replay = jax.jit(lambda s, o: run_replay_ba(rig, cfg, s, o))
    for shift, seed in [(0.0, s) for s in args.seeds] + [(x, args.seeds[0]) for x in args.shifts]:
        if seed == args.seeds[0]:  # a new rendering
            t0 = time.perf_counter()
            obs = jax.block_until_ready(extract(staged_frames(
                rig, poses.at[:, 0, 3].add(shift))))
            extract_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, outs = jax.block_until_ready(
            replay(init_ba_state(cfg, jax.random.PRNGKey(seed + 2), T0=gt_poses[0]), obs))
        print(json.dumps({
            "preset": PRESET.name, "source": "staged 8-bit capture", "seed": seed,
            "render_shift_m": shift, "platform": jax.devices()[0].platform, "frames": n_frames,
            "K": cfg.frontend.max_features,
            "ate_ba_m": float(ate_rmse(outs.vo.T_world[1:, :3, 3], gt)[0]),
            "pose_ok": int(np.asarray(outs.vo.pose_ok)[1:].sum()),
            "keyframes": int(np.asarray(outs.is_keyframe).sum()),
            "render_and_extract_s_with_compile": extract_s,
            "replay_s_with_compile": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
