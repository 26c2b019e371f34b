"""Where a replay's time goes on the card: torch.profiler over one replay.

    python -m sosvo_torch.tools.profile_replay [--ba]

For bench.py's c1 workload (10 frames) and c3's sizes in observation mode
(K=2048, H=1024, the first 40 of its frames, 16384 landmarks), after one
warm-up replay:
  * frames/s of one unprofiled replay (host clock, synchronised);
  * device time: the sum of the profiler's device events (kernels, copies,
    fills) over one profiled replay, and that sum's share of the unprofiled
    replay's wall time (the device busy share; the rest is idle);
  * device events per frame;
  * host ms per frame and per call of each pipeline stage (record_function
    ranges);
then the matcher's device time per call, kernel vs plain twin, at the
stereo match of a c1 frame (K=512) and of a frame at c3's sizes (K=2048).

With --ba the same for the keyframed window-BA replay instead: c2
(configs/c2_chip_ba.json in observation mode, 60 frames) and c3's sizes
(first 40 frames), with the BA stages (map association + insertion, window
BA, relocalisation) labelled beside the frame step's, so a keyframe's BA
can be set against the frame step; then the Schur kernel's device time per
call against its plain version on a late c2 window (W=5, L=512).
"""

from __future__ import annotations

import argparse
import functools
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sosvo_torch.frontend.match import match_stats
from sosvo_torch.kernels.match_cuda import match_stats_cuda
from sosvo_torch.kernels.schur_cuda import schur_reduce_cuda, schur_reduce_plain
from sosvo_torch.tools.workload import (
    ba_replayer,
    card_info,
    load_preset,
    make_workload,
    replayer,
)
from sosvo_torch.utils.device import default_device
from sosvo_torch.vo import ba_pipeline, pipeline

STAGES = {"stereo_triangulate": "stereo match + triangulate", "ransac_rigid": "rigid RANSAC",
          "refine_pose_bearings": "refine", "_gate_check": "essential gate"}
BA_STAGES = {"step_full": "frame step (frame to frame)",
             "insert_keyframe": "keyframe: map association + insertion",
             "run_window_ba": "keyframe: window BA", "try_relocalize": "relocalisation"}


def _label(module, stages: dict) -> None:
    for name, label in stages.items():
        f = getattr(module, name)

        def wrapped(*a, _f=f, _label=label, **k):
            with record_function(f"stage: {_label}"):
                return _f(*a, **k)
        setattr(module, name, functools.wraps(f)(wrapped))


def _label_stages() -> None:
    """Wrap the pipeline's stage functions in named profiler ranges."""
    _label(pipeline, STAGES)
    _label(ba_pipeline, BA_STAGES)
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


def profile_replay(label: str, preset: str, n_frames: int | None, device,
                   ba: bool = False) -> None:
    cfg, run = load_preset(preset)
    n_frames = n_frames or run["n_frames"]
    rig, scene, obs = make_workload(cfg, n_frames, run["n_landmarks"], device)
    replay = (ba_replayer if ba else replayer)(cfg, rig, scene, obs, device)
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
                  f"ms_per_frame={e.cpu_time_total / 1e3 / n_frames} "
                  f"ms_per_call={e.cpu_time_total / 1e3 / e.count}", flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=10,
                                    max_name_column_width=50), flush=True)


def _device_us_per_call(fn, calls: int = 50) -> tuple[float, float, list]:
    """(device us per call, device events per call, top 3 by name) of `fn`."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = _device_events(prof)
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda x: -x[1])[:3]
    return (sum(by_name.values()) / calls, len(dev) / calls,
            [(n[:40], t / calls) for n, t in top])


def profile_matcher(device) -> None:
    for name, preset in (("c1 K=512 stereo", "c1_cpu_smoke"), ("c3 K=2048 stereo", "c3_host_pgo")):
        cfg, run = load_preset(preset)
        _, _, obs = make_workload(cfg, 1, run["n_landmarks"], device)
        f0 = obs.frame(0)
        band = cfg.frontend.stereo_band_rad
        args = (f0.desc_top, f0.desc_bottom, f0.valid_top, f0.valid_bottom,
                pipeline.azimuth_of(f0.ray_top), pipeline.azimuth_of(f0.ray_bottom))
        for which, fn in (("kernel", match_stats_cuda), ("plain", match_stats)):
            us, events, top = _device_us_per_call(lambda: fn(*args, band=band))
            print(f"matcher {name} {which}: device_us_per_call={us} "
                  f"device_events_per_call={events} top={top}", flush=True)


def profile_schur(device) -> None:
    """The Schur kernel's device time per call against its plain version,
    on the window a c2 replay leaves after its last keyframe."""
    from sosvo_torch.backend.ba import BAWindow, build_blocks
    from sosvo_torch.sensor.model import viewpoint

    cfg, run = load_preset("c2_chip_ba")
    rig, scene, obs = make_workload(cfg, run["n_frames"], run["n_landmarks"], device)
    final, _ = ba_replayer(cfg, rig, scene, obs, device)()
    m = final.map
    vps = torch.stack([viewpoint(rig.top), viewpoint(rig.bottom)])
    blocks = build_blocks(BAWindow(m.kf_X, m.lm_pos, m.obs_rays, m.obs_w, vps))[:5]
    for which, fn in (("kernel", schur_reduce_cuda), ("plain", schur_reduce_plain)):
        us, events, top = _device_us_per_call(lambda: fn(*blocks, cfg.ba.damping_init))
        print(f"schur c2 W=5 L=512 {which}: device_us_per_call={us} "
              f"device_events_per_call={events} top={top}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ba", action="store_true", help="profile the window-BA replay")
    args = ap.parse_args()
    device = default_device()
    print(f"card: {card_info()}", flush=True)
    _label_stages()
    if args.ba:
        profile_replay("c2 window BA, observation mode", "c2_chip_ba", None, device, ba=True)
        profile_replay("c3 sizes window BA, observation mode, first 40 frames", "c3_host_pgo", 40,
                       device, ba=True)
        profile_schur(device)
        return
    profile_replay("c1 bench shape", "c1_cpu_smoke", None, device)
    profile_replay("c3 sizes, observation mode, first 40 frames", "c3_host_pgo", 40, device)
    profile_matcher(device)


if __name__ == "__main__":
    main()
