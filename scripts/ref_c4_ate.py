#!/usr/bin/env python
"""The JAX package's per-lane ATE for the c4 batched preset, on the CPU.

    JAX_PLATFORMS=cpu python scripts/ref_c4_ate.py [--modes f2f ba] [--seeds 0 1 2]

configs/c4_batched_replay.json as `sosvo/cli.py` runs it (`dist.data_parallel
> 1`: S=4 lanes, K=512, H=512, 100 frames, 8192 landmarks, 0.3 px noise and
2 % descriptor bit flips, BA defaults W=5, L=512, a keyframe every 4
frames): S scenes and their observations from `split(PRNGKey(seed), S)`,
lane states from `PRNGKey(seed + 2)`, replayed in lockstep by
`sosvo.vo.batched` in frame-to-frame (`run_replay_batched`) and window-BA
(`run_replay_ba_batched`) mode. Seed 0 is the CLI's own run. Prints one JSON
line per (mode, seed) with each lane's ATE and pose_ok count, then one line
per mode with the limit the PyTorch port's c4 replays (`chip_smoke.py`
phase 10) are held to: the worst lane ATE over all seeds plus twice the
spread (largest minus smallest) of those lane ATEs.
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

from sosvo.eval.ate import ate_rmse
from sosvo.sensor.rig import default_rig
from sosvo.synth.scene import make_scene, observe_sequence
from sosvo.utils.config import load_pipeline_config
from sosvo.vo.batched import (init_batched_ba_states, init_batched_states, run_replay_ba_batched,
                              run_replay_batched)

PRESET = _Path(__file__).resolve().parents[1] / "configs" / "c4_batched_replay.json"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", nargs="+", default=["f2f", "ba"], choices=["f2f", "ba"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    cfg = load_pipeline_config(PRESET)
    run = json.loads(PRESET.read_text())["run"]
    n_frames, n_landmarks, S = run["n_frames"], run["n_landmarks"], run["n_sequences"]
    K = cfg.frontend.max_features
    rig = default_rig()
    replays = {"f2f": jax.jit(lambda s, o: run_replay_batched(rig, cfg, s, o)),
               "ba": jax.jit(lambda s, o: run_replay_ba_batched(rig, cfg, s, o))}
    lane_ates = {m: [] for m in args.modes}
    for seed in args.seeds:
        keys = jax.random.split(jax.random.PRNGKey(seed), S)
        scenes = [make_scene(k, n_frames=n_frames, n_landmarks=n_landmarks) for k in keys]
        obs = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[observe_sequence(rig, sc, K, k, pixel_noise=0.3, desc_flip_prob=0.02)
                             for sc, k in zip(scenes, keys)])
        T0 = jnp.stack([sc.poses[0] for sc in scenes])
        for mode in args.modes:
            if mode == "ba":
                state = init_batched_ba_states(S, cfg, jax.random.PRNGKey(seed + 2), T0=T0)
            else:
                state = init_batched_states(S, K, jax.random.PRNGKey(seed + 2), T0=T0)
            t0 = time.perf_counter()
            _, outs = jax.block_until_ready(replays[mode](state, obs))
            seconds = time.perf_counter() - t0
            vo = outs.vo if mode == "ba" else outs
            ates = [float(ate_rmse(vo.T_world[s, 1:, :3, 3], scenes[s].poses[1:, :3, 3])[0])
                    for s in range(S)]
            lane_ates[mode] += ates
            print(json.dumps({"mode": mode, "seed": seed, "ate_per_lane_m": ates,
                              "pose_ok_per_lane": [int(x) for x in
                                                   jnp.sum(vo.pose_ok[:, 1:], axis=1)],
                              "frames": n_frames, "lanes": S, "seconds": seconds}), flush=True)
    for mode, ates in lane_ates.items():
        worst, spread = max(ates), max(ates) - min(ates)
        print(json.dumps({"mode": mode, "seeds": args.seeds, "worst_lane_ate_m": worst,
                          "spread_m": spread, "limit_m": worst + 2 * spread}), flush=True)


if __name__ == "__main__":
    main()
