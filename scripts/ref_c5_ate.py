#!/usr/bin/env python
"""The JAX package's ATE for the c5 preset, on the CPU.

    JAX_PLATFORMS=cpu python scripts/ref_c5_ate.py [--seeds 0 1 2]

configs/c5_multihost.json as `sosvo/cli.py` runs it on the 8-device virtual
CPU mesh (`dist.model_parallel` 8: K=1024, H=512, W=8, L=4096, 5 iterations,
100 frames, 32768 scene landmarks, 0.3 px noise and 2 % descriptor bit
flips): the scene and observations from `PRNGKey(seed)` and
`PRNGKey(seed + 1)`, the replay state from `PRNGKey(seed + 2)`, replayed by
`sosvo.dist.replay_dist.run_replay_ba_sharded` on `model_mesh(8)`. Seed 0 is
the CLI's own run. Prints one JSON line per seed with the ATE, pose_ok count
and keyframes, then the limit the PyTorch port's c5 replay
(`chip_smoke.py` phase 12) is held to: the worst ATE over the seeds plus
twice their spread (largest minus smallest).
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

from sosvo.dist.mesh import model_mesh
from sosvo.dist.replay_dist import run_replay_ba_sharded
from sosvo.eval.ate import ate_rmse
from sosvo.sensor.rig import default_rig
from sosvo.synth.scene import make_scene, observe_sequence
from sosvo.utils.config import load_pipeline_config
from sosvo.vo.ba_pipeline import init_ba_state

PRESET = _Path(__file__).resolve().parents[1] / "configs" / "c5_multihost.json"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    cfg = load_pipeline_config(PRESET)
    run = json.loads(PRESET.read_text())["run"]
    n_frames, n_landmarks = run["n_frames"], run["n_landmarks"]
    K = cfg.frontend.max_features
    rig = default_rig()
    mesh = model_mesh(min(cfg.dist.model_parallel, len(jax.devices())))
    replay = jax.jit(lambda s, o: run_replay_ba_sharded(mesh, rig, cfg, s, o))
    ates = []
    for seed in args.seeds:
        scene = make_scene(jax.random.PRNGKey(seed), n_frames=n_frames, n_landmarks=n_landmarks)
        obs = observe_sequence(rig, scene, K, jax.random.PRNGKey(seed + 1), pixel_noise=0.3,
                               desc_flip_prob=0.02)
        state = init_ba_state(cfg, jax.random.PRNGKey(seed + 2), T0=scene.poses[0])
        t0 = time.perf_counter()
        _, outs = jax.block_until_ready(replay(state, obs))
        ate = float(ate_rmse(outs.vo.T_world[1:, :3, 3], scene.poses[1:, :3, 3])[0])
        ates.append(ate)
        print(json.dumps({"seed": seed, "ate_m": ate, "pose_ok": int(outs.vo.pose_ok[1:].sum()),
                          "keyframes": int(outs.is_keyframe.sum()), "frames": n_frames,
                          "model_axis": mesh.shape["model"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    worst, spread = max(ates), max(ates) - min(ates)
    print(json.dumps({"seeds": args.seeds, "worst_ate_m": worst, "spread_m": spread,
                      "limit_m": worst + 2 * spread}), flush=True)


if __name__ == "__main__":
    main()
