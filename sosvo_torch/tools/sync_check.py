"""Count the host<->device synchronisations of one c1 replay on the card.

    python -m sosvo_torch.tools.sync_check

Runs bench.py's workload (configs/c1_cpu_smoke.json, 10 frames) once to
warm up, then once under `torch.cuda.set_sync_debug_mode("warn")`, and
prints the number of synchronising calls grouped by the port's source line.
The debug mode is PyTorch's own and does not see every sync: a blocking
host->device copy of a Python list, for one, passes unflagged.
"""

from __future__ import annotations

import collections
import os
import warnings

import torch

from sosvo_torch.tools.workload import card_info, load_preset, make_workload, replayer, require_cuda


def main() -> None:
    device = require_cuda()
    print(f"card: {card_info()}", flush=True)
    cfg, run = load_preset("c1_cpu_smoke")
    rig, scene, obs = make_workload(cfg, run["n_frames"], run["n_landmarks"], device)
    replay = replayer(cfg, rig, scene, obs, device)
    replay()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        replay()
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    where = collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in syncs)
    print(f"syncs in one {run['n_frames']}-frame c1 replay: {len(syncs)}", flush=True)
    for loc, n in where.most_common():
        print(f"  {n} at {loc}", flush=True)


if __name__ == "__main__":
    main()
