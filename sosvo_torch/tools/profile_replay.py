"""Where a replay's time goes on the card: torch.profiler over one replay.

    python -m sosvo_torch.tools.profile_replay

For bench.py's c1 workload (10 frames) and c3's sizes in observation mode
(K=2048, H=1024, the first 40 of its frames, 16384 landmarks), after one
warm-up replay:
  * frames/s of one unprofiled replay (host clock, synchronised);
  * device time: the sum of the profiler's device events (kernels, copies,
    fills) over one profiled replay, and that sum's share of the unprofiled
    replay's wall time (the device busy share; the rest is idle);
  * device events per frame;
  * host ms per frame of each pipeline stage (record_function ranges);
then the matcher's device time per call, kernel vs plain twin, at the
stereo match of a c1 frame (K=512) and of a frame at c3's sizes (K=2048).
"""

from __future__ import annotations

import functools
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sosvo_torch.frontend.match import match_stats
from sosvo_torch.kernels.match_cuda import match_stats_cuda
from sosvo_torch.tools.workload import card_info, load_preset, make_workload, replayer, require_cuda
from sosvo_torch.vo import pipeline

STAGES = {"stereo_triangulate": "stereo match + triangulate", "ransac_rigid": "rigid RANSAC",
          "refine_pose_bearings": "refine", "_gate_check": "essential gate"}


def _label_stages() -> None:
    """Wrap the pipeline's stage functions in named profiler ranges."""
    for name, label in STAGES.items():
        f = getattr(pipeline, name)

        def wrapped(*a, _f=f, _label=label, **k):
            with record_function(f"stage: {_label}"):
                return _f(*a, **k)
        setattr(pipeline, name, functools.wraps(f)(wrapped))
    match = pipeline._match

    def temporal_or_stereo(cfg, *a, **k):
        if k.get("band", 0.0) > 0.0:  # the stereo match, inside its own stage
            return match(cfg, *a, **k)
        with record_function("stage: temporal match"):
            return match(cfg, *a, **k)
    pipeline._match = temporal_or_stereo


def _device_events(prof) -> list:
    """The profiler's device events: kernels, copies and fills, without the
    device-side copies of the record_function ranges, which span whole stages."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.name.startswith("stage: ")]


def profile_replay(label: str, preset: str, n_frames: int | None, device) -> None:
    cfg, run = load_preset(preset)
    n_frames = n_frames or run["n_frames"]
    rig, scene, obs = make_workload(cfg, n_frames, run["n_landmarks"], device)
    replay = replayer(cfg, rig, scene, obs, device)
    replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replay()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize()
    dev = _device_events(prof)
    dev_s = sum(e.time_range.elapsed_us() for e in dev) / 1e6
    print(f"{label}: K={cfg.frontend.max_features} H={cfg.ransac.n_hyps} frames={n_frames} "
          f"frames_per_s_unprofiled={n_frames / wall} wall_s={wall} device_s={dev_s} "
          f"device_busy_share={dev_s / wall} device_events_per_frame={len(dev) / n_frames}",
          flush=True)
    for e in sorted(prof.key_averages(), key=lambda e: e.key):
        if e.key.startswith("stage: ") and e.device_type == torch.autograd.DeviceType.CPU:
            print(f"  host {e.key[7:]}: calls={e.count} "
                  f"ms_per_frame={e.cpu_time_total / 1e3 / n_frames}", flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=10,
                                    max_name_column_width=50), flush=True)


def profile_matcher(device) -> None:
    for name, preset in (("c1 K=512 stereo", "c1_cpu_smoke"), ("c3 K=2048 stereo", "c3_host_pgo")):
        cfg, run = load_preset(preset)
        _, _, obs = make_workload(cfg, 1, run["n_landmarks"], device)
        f0 = obs.frame(0)
        band = cfg.frontend.stereo_band_rad
        args = (f0.desc_top, f0.desc_bottom, f0.valid_top, f0.valid_bottom,
                pipeline.azimuth_of(f0.ray_top), pipeline.azimuth_of(f0.ray_bottom))
        for which, fn in (("kernel", match_stats_cuda), ("plain", match_stats)):
            for _ in range(5):
                fn(*args, band=band)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    fn(*args, band=band)
                torch.cuda.synchronize()
            dev = _device_events(prof)
            by_name: dict[str, float] = {}
            for e in dev:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            top = sorted(by_name.items(), key=lambda x: -x[1])[:3]
            print(f"matcher {name} {which}: device_us_per_call="
                  f"{sum(by_name.values()) / 50} device_events_per_call={len(dev) / 50} "
                  f"top={[(n[:40], t / 50) for n, t in top]}", flush=True)


def main() -> None:
    device = require_cuda()
    print(f"card: {card_info()}", flush=True)
    _label_stages()
    profile_replay("c1 bench shape", "c1_cpu_smoke", None, device)
    profile_replay("c3 sizes, observation mode, first 40 frames", "c3_host_pgo", 40, device)
    profile_matcher(device)


if __name__ == "__main__":
    main()
