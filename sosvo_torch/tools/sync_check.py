"""Count the host<->device synchronisations of a replay on the card.

    python -m sosvo_torch.tools.sync_check

Runs each workload once to warm up, then once under
`torch.cuda.set_sync_debug_mode("warn")`, and prints the number of
synchronising calls, per replay and per frame, grouped by the port's source
line: bench.py's c1 workload frame to frame (configs/c1_cpu_smoke.json, 10
frames), and the keyframed window-BA replay of configs/c2_chip_ba.json in
observation mode (its first 20 frames: 5 keyframes, 4 window solves). The
BA replay is expected to sync once per frame at the lazy gate, once per
frame at the relocalisation predicate once the map holds a keyframe, once
at its start (reading the frame and keyframe counters), and never inside
`insert_keyframe` or `ba_solve`. The debug mode is PyTorch's own and does
not see every sync: a blocking host->device copy of a Python list, for
one, passes unflagged.
"""

from __future__ import annotations

import collections
import os
import warnings

import torch

from sosvo_torch.tools.workload import (
    ba_replayer,
    card_info,
    load_preset,
    make_workload,
    replayer,
)
from sosvo_torch.utils.device import default_device


def count_syncs(label: str, replay, n_frames: int) -> None:
    replay()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        replay()
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    where = collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in syncs)
    print(f"syncs in one {n_frames}-frame {label} replay: {len(syncs)} "
          f"({len(syncs) / n_frames} per frame)", flush=True)
    for loc, n in where.most_common():
        print(f"  {n} at {loc}", flush=True)


def main() -> None:
    device = default_device()
    print(f"card: {card_info()}", flush=True)
    cfg, run = load_preset("c1_cpu_smoke")
    rig, scene, obs = make_workload(cfg, run["n_frames"], run["n_landmarks"], device)
    count_syncs("c1 frame-to-frame", replayer(cfg, rig, scene, obs, device), run["n_frames"])
    cfg, run = load_preset("c2_chip_ba")
    n_frames = 20
    rig, scene, obs = make_workload(cfg, n_frames, run["n_landmarks"], device)
    count_syncs("c2 window-BA", ba_replayer(cfg, rig, scene, obs, device), n_frames)


if __name__ == "__main__":
    main()
