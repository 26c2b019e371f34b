"""Replay frames/s of one or more source trees, in turns, one process each.

    python -m sosvo_torch.tools.paired TREE [TREE ...] [--rounds N] [--reps R]

Each TREE is the root of a checkout of the port (give `.` for this one).
A round starts one process per tree, in order on even rounds and in reverse
on odd ones (A B, B A, ...), so trees share the card's and host's drift.
Each process builds the workloads once, warms up, and times R replays of
bench.py's c1 workload (10 frames) and R replays of the first 40 frames at
c3's sizes in observation mode, on the host clock after a synchronise; it
prints one line per workload with the median and every sample. With one
tree, the spread between its processes is the run-to-run noise that a
comparison has to beat. The worker uses only the port's public entry
points, so an older checkout of the port runs unchanged.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from sosvo_torch.tools.workload import card_info
from sosvo_torch.utils.device import default_device

WORKER = r"""
import dataclasses, json, statistics, sys, time
import torch
from sosvo_torch.sensor.rig import default_rig
from sosvo_torch.synth.scene import make_scene, observe_sequence
from sosvo_torch.utils.config import load_pipeline_config
from sosvo_torch.vo.pipeline import run_replay
from sosvo_torch.vo.state import init_track_state

tree, reps = sys.argv[1], int(sys.argv[2])
dev = torch.device("cuda", 0)
for label, preset, frames in (("c1", "c1_cpu_smoke", 10), ("c3_40f", "c3_host_pgo", 40)):
    path = f"configs/{preset}.json"
    cfg = dataclasses.replace(load_pipeline_config(path), mode="observations")
    n_lm = json.load(open(path))["run"]["n_landmarks"]
    gen = torch.Generator(device=dev).manual_seed(0)
    rig = default_rig(device=dev)
    scene = make_scene(gen, frames, n_lm, device=dev)
    obs = observe_sequence(rig, scene, cfg.frontend.max_features, gen, 0.3, 0.02)

    def replay():
        g = torch.Generator(device=dev).manual_seed(2)
        st = init_track_state(cfg.frontend.max_features, g, T0=scene.poses[0], device=dev)
        return run_replay(rig, cfg, st, obs)

    replay()
    torch.cuda.synchronize()
    fps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        replay()
        torch.cuda.synchronize()
        fps.append(frames / (time.perf_counter() - t0))
    print(f"PAIRED {tree} {label} median_fps={statistics.median(fps)} all={fps}", flush=True)
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()
    default_device()
    print(f"card: {card_info()}", flush=True)
    for r in range(args.rounds):
        for tree in (args.trees if r % 2 == 0 else args.trees[::-1]):
            env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
            subprocess.run([sys.executable, "-c", WORKER, tree, str(args.reps)],
                           cwd=tree, env=env, check=True, timeout=900)


if __name__ == "__main__":
    main()
