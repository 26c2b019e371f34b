"""Throughput of the batched replay with its lanes split over D ranks
(counterpart of `sosvo/dist/scaling.py`).

    python -m sosvo_torch.dist.scaling [--ranks 8] [--frames 16] [--seqs-per-rank 2] [--device cpu]

For D = 1, 2, 4, 8 (up to --ranks), `dist/launch.py` starts D ranks; each
replays `seqs_per_rank` lanes of a c4-style batched workload (its block of
S = seqs_per_rank x D lanes, `vo/batched.py:shard_batched_inputs`) frame to
frame once to warm up, then once timed between two all-reduces that line
the ranks up. frames/s is S x frames over the slowest rank's wall time.
The report names the device: where the ranks share one card (D ranks, one
H100) the figure is the card's throughput under D processes, not a scaling
efficiency across devices; on the CPU it is the CPU's.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from sosvo_torch.dist import mesh as dmesh
from sosvo_torch.dist.launch import launch


def _rank(ranks, n_frames: int, k: int, seqs_per_rank: int, n_landmarks: int):
    """One rank's timed replay of its lanes: (seconds, lanes)."""
    from sosvo_torch.tools.workload import SEED, make_batched_workload
    from sosvo_torch.utils.config import FrontendConfig, PipelineConfig
    from sosvo_torch.vo.batched import init_batched_states, run_replay_batched, \
        shard_batched_inputs

    m = dmesh.make_mesh(ranks, ranks.world, 1)
    axis = m.axis(dmesh.DATA_AXIS)
    cfg = PipelineConfig(frontend=FrontendConfig(max_features=k))
    S = seqs_per_rank * ranks.world
    dev = ranks.device
    rig, gt, obs = make_batched_workload(cfg, S, n_frames, n_landmarks, dev)

    def replay(frames):
        states = init_batched_states(S, k, SEED + 2, T0=gt[:, 0], device=dev)
        states, o = shard_batched_inputs(m, states, obs)
        run_replay_batched(rig, cfg, states, type(o)(*(x[:, :frames] for x in o)))

    def line_up():
        axis.psum(torch.zeros(1, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    replay(2)  # warm-up
    line_up()
    t0 = time.perf_counter()
    replay(n_frames)
    line_up()
    return time.perf_counter() - t0, seqs_per_rank


def measure_scaling(rank_counts=(1, 2, 4, 8), n_frames: int = 16, k: int = 256,
                    seqs_per_rank: int = 2, n_landmarks: int = 2048, device: str | None = None,
                    timeout_s: float = 600.0) -> dict:
    """Frames/s of the batched replay at each rank count."""
    rows, base = [], None
    for D in rank_counts:
        outs = launch("sosvo_torch.dist.scaling:_rank", D,
                      dict(n_frames=n_frames, k=k, seqs_per_rank=seqs_per_rank,
                           n_landmarks=n_landmarks), timeout_s=timeout_s, device=device)
        seconds = max(s for s, _ in outs)
        S = seqs_per_rank * D
        fps = S * n_frames / seconds
        base = base or fps / D
        rows.append({"ranks": D, "sequences": S, "seconds": seconds, "frames_per_s": fps,
                     "frames_per_s_per_rank": fps / D, "per_rank_vs_one_rank": fps / D / base})
    on_card = device != "cpu"
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    cards = torch.cuda.device_count() if on_card else 0
    shared = on_card and max(rank_counts) > cards
    return {"device": kind, "cards": cards,
            "note": (f"ranks share {cards} card(s): frames/s of one card under D processes, "
                     "not a scaling efficiency" if shared else
                     "the CPU: validates the lane split, not a device rate" if not on_card else
                     "one card per rank"),
            "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--seqs-per-rank", type=int, default=2)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sosvo_torch.dist.scaling: no CUDA device; pass --device cpu")
    counts = [n for n in (1, 2, 4, 8, 16) if n <= args.ranks]
    print(json.dumps(measure_scaling(counts, args.frames, args.k, args.seqs_per_rank,
                                     device="cpu" if args.device == "cpu" else None), indent=2))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
