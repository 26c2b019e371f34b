"""Count the host<->device synchronisations of a replay on the card.

    python -m sosvo_torch.tools.sync_check [--adaptive-only]

Runs each workload once to warm up, then once under
`torch.cuda.set_sync_debug_mode("warn")`, and prints the number of
synchronising calls, per replay and per frame, grouped by the port's source
line: bench.py's c1 workload frame to frame (configs/c1_cpu_smoke.json, 10
frames), and the keyframed window-BA replay of configs/c2_chip_ba.json in
observation mode (its first 20 frames: 5 keyframes, 4 window solves), the same preset as written in
image mode (`tools/workload.py:image_ba_replayer`: extraction of its first
20 rendered frames, then the window-BA replay; the frontend is expected to
add no sync), configs/c3_adaptive.json the same way (its first 20 frames,
motion-adaptive keyframes: the trigger is read with the relocalisation
predicate, so a tracked frame is expected to sync twice, as in stride
mode; `--adaptive-only` counts this replay alone), and c3's loop-closure leg (`tools/workload.py:pgo_leg`: 160 candidate pairs,
300 inliers, DCS) over a frame-to-frame replay at c3's sizes (K=2048,
H=1024, 200 frames, 50 stride keyframes). The BA replay is expected to
sync once per frame at the lazy gate, once per frame at the relocalisation
predicate once the map holds a keyframe, once at its start (reading the
frame and keyframe counters), and never inside `insert_keyframe` or
`ba_solve`; the leg only where its keyframe and governing-keyframe indices
go from the host to the card (3 per leg), never per pair and never inside
`pgo_solve` (n_loops stays on the device). Then the c4 batched replay
(configs/c4_batched_replay.json's widths, its first 20 frames) frame to
frame and with window BA at S = 1, 2, 4 and 8 lanes: the batch is expected
to sync once per frame at the batch gate and, in BA mode, once more at the
batch relocalisation predicate once the maps hold a keyframe, plus once at
the start, whatever S is (never per lane). The debug mode is PyTorch's own and does
not see every sync: a blocking host->device copy of a Python list, for
one, passes unflagged. Beside each count it prints the pipeline's own
`sync.<site>` counters (`sosvo_torch/utils/spans.py`) over the same run,
which should add up to it.
"""

from __future__ import annotations

import argparse
import collections
import os
import warnings

import torch

from sosvo_torch.tools.workload import (
    BATCHED_LANES,
    BATCHED_PROFILED_FRAMES,
    ba_replayer,
    batched_replayer,
    card_info,
    image_ba_replayer,
    load_image_preset,
    load_preset,
    make_batched_workload,
    make_image_workload,
    make_workload,
    pgo_leg,
    replayer,
)
from sosvo_torch.utils import spans
from sosvo_torch.utils.device import default_device
from sosvo_torch.vo.loop_closure import keyframe_indices


def syncs_during(fn):
    """(fn's result, the warnings of the synchronising calls PyTorch's sync
    debug mode flags while it runs)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [w for w in caught if "called a synchronizing" in str(w.message)]


def count_syncs(label: str, replay, n_frames: int, unit: str = "frame") -> None:
    """Syncs of one run of `replay` after a warm-up run, in all and per
    `unit` (n_frames of them), by source line."""
    replay()
    torch.cuda.synchronize()
    spans.reset()
    spans.enable()
    try:
        _, syncs = syncs_during(replay)
    finally:
        spans.disable()
    counted = collections.Counter()
    for s in spans.spans():
        counted.update({k: n for k, n in s.counts.items() if k.startswith("sync.")})
    spans.reset()
    where = collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in syncs)
    print(f"syncs in one {label} run ({n_frames} {unit}s): {len(syncs)} "
          f"({len(syncs) / n_frames} per {unit})", flush=True)
    for loc, n in where.most_common():
        print(f"  {n} at {loc}", flush=True)
    print(f"  the pipeline's counters: {sum(counted.values())} {dict(sorted(counted.items()))}",
          flush=True)


def count_batched_syncs(device) -> None:
    """c4's batched replay in both modes at each lane count (module docstring)."""
    cfg, run = load_preset("c4_batched_replay")
    n_frames = BATCHED_PROFILED_FRAMES
    for n_lanes in BATCHED_LANES:
        rig, gt, obs = make_batched_workload(cfg, n_lanes, n_frames, run["n_landmarks"], device)
        for mode in ("f2f", "ba"):
            count_syncs(f"c4 batched {mode}, S={n_lanes} lanes",
                        batched_replayer(cfg, rig, gt, obs, device, mode), n_frames)


def count_adaptive_syncs(device, n_frames: int = 20) -> None:
    """configs/c3_adaptive.json's image-mode window-BA replay over its first
    `n_frames` rendered frames (module docstring)."""
    cfg, _ = load_image_preset("c3_adaptive")
    rig, poses, images, luts, _ = make_image_workload(cfg, n_frames, device)
    count_syncs("c3_adaptive image-mode window-BA, adaptive keyframes",
                image_ba_replayer(cfg, rig, poses, images, luts, device), n_frames)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--adaptive-only", action="store_true",
                    help="count configs/c3_adaptive.json's replay alone")
    args = ap.parse_args()
    device = default_device()
    print(f"card: {card_info()}", flush=True)
    if args.adaptive_only:
        count_adaptive_syncs(device)
        return
    cfg, run = load_preset("c1_cpu_smoke")
    rig, scene, obs = make_workload(cfg, run["n_frames"], run["n_landmarks"], device)
    count_syncs("c1 frame-to-frame", replayer(cfg, rig, scene, obs, device), run["n_frames"])
    cfg, run = load_preset("c2_chip_ba")
    n_frames = 20
    rig, scene, obs = make_workload(cfg, n_frames, run["n_landmarks"], device)
    count_syncs("c2 window-BA", ba_replayer(cfg, rig, scene, obs, device), n_frames)
    cfg, _ = load_image_preset("c2_chip_ba")
    rig, poses, images, luts, _ = make_image_workload(cfg, n_frames, device)
    count_syncs("c2 image-mode window-BA", image_ba_replayer(cfg, rig, poses, images, luts, device),
                n_frames)
    count_adaptive_syncs(device, n_frames)
    cfg, run = load_preset("c3_host_pgo")
    rig, scene, obs = make_workload(cfg, run["n_frames"], run["n_landmarks"], device)
    _, outs = replayer(cfg, rig, scene, obs, device)()
    kf_idx = keyframe_indices(run["n_frames"], cfg.keyframe_every)
    count_syncs("c3 loop-closure leg", lambda: pgo_leg(cfg, rig, obs, outs.T_world, kf_idx),
                cfg.loop_candidates, unit="candidate pair")
    count_batched_syncs(device)


if __name__ == "__main__":
    main()
