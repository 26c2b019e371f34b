"""Where a replay's time goes on the card: torch.profiler over one replay.

    python -m sosvo_torch.tools.profile_replay [--ba | --pgo | --images | --batched]
    python -m sosvo_torch.tools.profile_replay --images --descriptor brief sift akaze
    python -m sosvo_torch.tools.profile_replay --kernels [TREE ...] [--rounds N]

For bench.py's c1 workload (10 frames) and c3's sizes in observation mode
(K=2048, H=1024, the first 40 of its frames, 16384 landmarks), after one
warm-up replay:
  * frames/s of one unprofiled replay (host clock, synchronised);
  * device time: the sum of the profiler's device events (kernels, copies,
    fills) over one profiled replay;
  * device events per frame;
  * host ms per frame and per call of each pipeline stage: the spans the
    pipeline records itself (`sosvo_torch/utils/spans.py`), over the
    profiled replay;
then the matcher's device time per call, kernel vs plain twin, at the
stereo match of a c1 frame (K=512) and of a frame at c3's sizes (K=2048).

With --ba the same for the keyframed window-BA replay instead: c2
(configs/c2_chip_ba.json in observation mode, 60 frames) and c3's sizes
(first 40 frames), whose spans add the keyframe stage's (the read,
relocalisation, map association + insertion, window BA and its LM
iterations' parts) beside the frame step's; then the Schur kernel's device
time per call against its plain version on a late c2 window (W=5, L=512).

With --pgo, c3's loop-closure leg (`tools/workload.py:pgo_leg`: 160
candidate pairs, 300 inliers, DCS) over the keyframes of a BA replay at
c3's sizes (200 frames, 50 keyframes), as chip_smoke.py's phase 6c runs it:
the leg's host-clock seconds unprofiled, its device time and events, and
host ms per call of its spans (keyframe stereo features, candidates, the
pairs with their two-frame BAs' LM parts, the PGO solve, the correction).

With --images, the image-mode presets as written (configs/c2_chip_ba.json,
60 frames, and configs/c3_host_pgo.json, its first 40 frames; rendered on
the card): the frontend alone (`extract_sequence` over the frames) and the
image-mode BA replay (extraction, then the window-BA replay), each after a
warm-up: host ms per frame of the extraction, unprofiled; the frontend's
device events and device ms per frame and its share of the replay's device
time; the replay's frames/s and device events per frame, and its ATE and
pose_ok with the port's own RANSAC generator.
`--descriptor brief sift akaze` runs them once per descriptor family
(`frontend.descriptor` replaced in each preset; default brief).

With --batched, the c4 batched replay (configs/c4_batched_replay.json:
K=512, H=512, 8192 landmarks, W=5, L=512, a keyframe every 4 frames) frame
to frame and with window BA at S = 1, 2, 4 and 8 lanes, after a warm-up:
frames/s summed over the lanes, host ms per frame and each lane's ATE of
one unprofiled replay of the preset's 100 frames; device time and device
events per frame of its first 20 frames
(`workload.BATCHED_PROFILED_FRAMES`), timed unprofiled and then profiled
with device activity only (the profiler's host-side events at S=8 over
100 frames take it many minutes to read).

With --kernels, both kernels alone at every main-path shape, for each
source TREE (the root of a checkout of the port; `.` for this one), one
process per tree, in turns (A B, B A, ...): device us per call and device
events per call (profiler over 50 calls) and wrapper ms (CUDA events over
200 back-to-back calls). Matcher: the stereo and temporal matches of a c1
frame (K=512) and of a frame at c3's sizes (K=2048), and the map
associations L x K at 512x512 (c2), 1024x2048 (c3 sizes) and 4096x1024
(c5) on random descriptors with 40 planted matches, and c3's loop pair
(the stereo features of frames 0 and 100 at c3's sizes, 2048x2048, no
band), c5's stereo and temporal matches (K=1024, every rank's frame), c4
lane 0's frame-0 stereo match (K=512), and c2 as written in image mode
(frames 0 and 30 rendered and extracted on the card: stereo, temporal);
Schur: random SPD windows at W5/L512 (c2, and every c4 lane's window),
W5/L1024 (c3 sizes), W8/L4096 (c5 on one device), W2/L2048 (c3's two-frame
loop window) and W8/L512 (one of c5's 8 landmark shards). The worker
uses only entry points that every tree of the port has. Then, in this
process: the library yardstick of each shape (one torch.matmul of the same
product, which the port never calls), the launch floors (probes with no
work through the same ctypes route: an empty kernel, the matcher's grid
taking its tickets, the Schur kernel's clusters syncing; device us and
wrapper ms) and a host
breakdown of one wrapper call of each kernel; with no TREE, only these.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from sosvo_torch.frontend.match import match_stats
from sosvo_torch.kernels import match_cuda
from sosvo_torch.kernels.match_cuda import match_stats_cuda
from sosvo_torch.kernels.schur_cuda import schur_reduce_cuda, schur_reduce_plain
from sosvo_torch.tools.paired import run_in_turns
from sosvo_torch.eval.ate import ate_rmse
from sosvo_torch.frontend.image_frontend import extract_sequence
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
    replayer,
)
from sosvo_torch.utils import spans
from sosvo_torch.utils.device import default_device
from sosvo_torch.vo import pipeline


def _device_events(prof) -> list:
    """The profiler's device events: kernels, copies and fills."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _profiled_with_spans(fn):
    """One call of `fn` under the profiler (device activity) with the
    pipeline's spans on -> (profile, {span name: (calls, host ns)})."""
    spans.reset()
    spans.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        spans.disable()
    by_name: dict[str, list[int]] = defaultdict(lambda: [0, 0])
    for s in spans.spans():
        by_name[s.name][0] += 1
        by_name[s.name][1] += s.end_ns - s.start_ns
    spans.reset()
    return prof, by_name


def _print_spans(by_name: dict, n_frames: int | None = None) -> None:
    for name, (calls, ns) in sorted(by_name.items()):
        per_frame = "" if n_frames is None else f"ms_per_frame={ns / 1e6 / n_frames} "
        print(f"  host {name}: calls={calls} ms_total={ns / 1e6} {per_frame}"
              f"ms_per_call={ns / 1e6 / calls}", flush=True)


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
    prof, by_name = _profiled_with_spans(replay)
    dev = _device_events(prof)
    dev_s = sum(e.time_range.elapsed_us() for e in dev) / 1e6
    print(f"{label}: K={cfg.frontend.max_features} H={cfg.ransac.n_hyps} frames={n_frames} "
          f"frames_per_s_unprofiled={n_frames / wall} wall_s={wall} device_s={dev_s} "
          f"device_events_per_frame={len(dev) / n_frames}", flush=True)
    _print_spans(by_name, n_frames)
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=10,
                                    max_name_column_width=50), flush=True)


def profile_pgo(device) -> None:
    """c3's loop-closure leg over a BA replay at c3's sizes (see the module
    docstring): one warm-up leg, one timed, one profiled."""
    from sosvo_torch.tools import workload

    cfg, run = load_preset("c3_host_pgo")
    rig, scene, obs = make_workload(cfg, run["n_frames"], run["n_landmarks"], device)
    _, outs = ba_replayer(cfg, rig, scene, obs, device)()
    kf_idx = torch.nonzero(outs.is_keyframe).flatten().cpu().numpy()

    def leg():
        return workload.pgo_leg(cfg, rig, obs, outs.vo.T_world, kf_idx)

    leg()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = leg()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof, by_name = _profiled_with_spans(leg)
    dev = _device_events(prof)
    dev_s = sum(e.time_range.elapsed_us() for e in dev) / 1e6
    print(f"c3 loop-closure leg over the BA replay: keyframes={len(kf_idx)} "
          f"candidates={cfg.loop_candidates} n_loops={int(out.n_loops)} leg_s_unprofiled={wall} "
          f"device_s={dev_s} device_events={len(dev)}", flush=True)
    _print_spans(by_name)
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=10,
                                    max_name_column_width=50), flush=True)


def timed_and_profiled(fn) -> tuple[float, float, int]:
    """(unprofiled wall s, device s, device events) of one call of `fn`
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = _device_events(prof)
    return wall, sum(e.time_range.elapsed_us() for e in dev) / 1e6, len(dev)


def _wall(fn):
    """(host s of one synchronised call of `fn`, its result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def profile_batched(device) -> None:
    """c4's batched replay at each lane count (module docstring)."""
    from sosvo_torch.synth.scene import FrameObservations

    cfg, run = load_preset("c4_batched_replay")
    n, n_profiled = run["n_frames"], BATCHED_PROFILED_FRAMES
    for n_lanes in BATCHED_LANES:
        rig, gt, obs = make_batched_workload(cfg, n_lanes, n, run["n_landmarks"], device)
        head = FrameObservations(*(x[:, :n_profiled] for x in obs))
        for mode in ("f2f", "ba"):
            short = batched_replayer(cfg, rig, gt, head, device, mode)
            short()  # warm-up
            wall, (_, outs) = _wall(batched_replayer(cfg, rig, gt, obs, device, mode))
            wall_short, _ = _wall(short)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                short()
                torch.cuda.synchronize()
            dev = _device_events(prof)
            dev_s = sum(e.time_range.elapsed_us() for e in dev) / 1e6
            vo = outs if mode == "f2f" else outs.vo
            ates = [float(ate_rmse(vo.T_world[s, 1:, :3, 3], gt[s, 1:, :3, 3])[0])
                    for s in range(n_lanes)]
            print(f"c4 batched {mode}: S={n_lanes} K={cfg.frontend.max_features} "
                  f"H={cfg.ransac.n_hyps} frames={n}: frames_per_s_summed_over_lanes="
                  f"{n_lanes * n / wall} host_ms_per_frame={1e3 * wall / n} wall_s={wall} "
                  f"ATE_per_lane_m={ates} pose_ok={int(vo.pose_ok[:, 1:].sum())}/"
                  f"{n_lanes * (n - 1)}; first {n_profiled} frames: wall_s={wall_short} "
                  f"device_s={dev_s} device_events_per_frame={len(dev) / n_profiled} "
                  f"device_events_per_lane_frame={len(dev) / (n_profiled * n_lanes)}", flush=True)


def profile_images(device, descriptor: str = "brief") -> None:
    """The image-mode presets' frontend and BA replay (module docstring),
    with `descriptor` in place of each preset's."""
    for preset, n_frames in (("c2_chip_ba", None), ("c3_host_pgo", 40)):
        cfg, run = load_image_preset(preset)
        cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                    descriptor=descriptor))
        n = n_frames or run["n_frames"]
        rig, poses, images, luts, _ = make_image_workload(cfg, n, device)
        fe_wall, fe_dev, fe_events = timed_and_profiled(
            lambda: extract_sequence(rig, luts, cfg.frontend, images))
        replay = image_ba_replayer(cfg, rig, poses, images, luts, device)
        wall, dev_s, events = timed_and_profiled(replay)
        outs = replay()[1]
        ate = float(ate_rmse(outs.vo.T_world[1:, :3, 3], poses[1:, :3, 3])[0])
        print(f"{preset} image mode, window BA, descriptor={descriptor}: "
              f"K={cfg.frontend.max_features} "
              f"pano={cfg.frontend.pano_height}x{cfg.frontend.pano_width} frames={n} "
              f"frontend: host_ms_per_frame_unprofiled={1e3 * fe_wall / n} "
              f"device_ms_per_frame={1e3 * fe_dev / n} device_events_per_frame={fe_events / n} "
              f"share_of_replay_device_time={fe_dev / dev_s} replay (extraction included): "
              f"frames_per_s_unprofiled={n / wall} wall_s={wall} device_s={dev_s} "
              f"device_events_per_frame={events / n} "
              f"ATE_m={ate} pose_ok={int(outs.vo.pose_ok[1:].sum())}/{n - 1} (the port's "
              f"generator)", flush=True)


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


KERNEL_WORKER = r"""
import sys
import torch
from sosvo_torch.kernels.match_cuda import match_stats_cuda
from sosvo_torch.kernels.schur_cuda import schur_reduce_cuda
from sosvo_torch.tools.profile_replay import _device_us_per_call
from sosvo_torch.tools.workload import (cuda_ms, load_image_preset, load_preset,
                                        make_batched_workload, make_image_workload, make_workload)
from sosvo_torch.vo.pipeline import azimuth_of, stereo_triangulate

tree = sys.argv[1]
dev = torch.device("cuda", 0)


def report(kind, shape, fn):
    us, ev, _ = _device_us_per_call(fn)
    print(f"KERNEL {tree} {kind} {shape} device_us={us} events={ev} wrapper_ms={cuda_ms(fn, 200)}",
          flush=True)


gen = torch.Generator(device=dev).manual_seed(11)
for label, preset in (("512", "c1_cpu_smoke"), ("2048", "c3_host_pgo")):
    cfg, run = load_preset(preset)
    rig, _, obs = make_workload(cfg, 2, run["n_landmarks"], dev)
    f0, f1 = obs.frame(0), obs.frame(1)
    v0, v1 = stereo_triangulate(rig, f0, cfg)[4], stereo_triangulate(rig, f1, cfg)[4]
    band = cfg.frontend.stereo_band_rad
    st = (f0.desc_top, f0.desc_bottom, f0.valid_top, f0.valid_bottom,
          azimuth_of(f0.ray_top), azimuth_of(f0.ray_bottom))
    report("matcher", f"{label}_stereo", lambda: match_stats_cuda(*st, band=band))
    report("matcher", f"{label}_temporal",
           lambda: match_stats_cuda(f0.desc_top, f1.desc_top, v0, v1))
# c3's loop pair: two keyframes' stereo features 100 frames apart, no band
cfg, run = load_preset("c3_host_pgo")
rig, _, obs = make_workload(cfg, 101, run["n_landmarks"], dev)
fa, fb = obs.frame(0), obs.frame(100)
va, vb = stereo_triangulate(rig, fa, cfg)[4], stereo_triangulate(rig, fb, cfg)[4]
report("matcher", "loop_pair_2048x2048", lambda: match_stats_cuda(fa.desc_top, fb.desc_top, va, vb))
for ka, kb in ((512, 512), (1024, 2048), (4096, 1024)):
    da = torch.randint(-2**31, 2**31, (ka, 8), generator=gen, dtype=torch.int32, device=dev)
    db = torch.randint(-2**31, 2**31, (kb, 8), generator=gen, dtype=torch.int32, device=dev)
    db[:40] = da[:40]
    va = torch.rand(ka, generator=gen, device=dev) < 0.9
    vb = torch.rand(kb, generator=gen, device=dev) < 0.9
    report("matcher", f"association_{ka}x{kb}", lambda: match_stats_cuda(da, db, va, vb))
# c5: every rank's stereo and temporal match at K=1024
cfg, run = load_preset("c5_multihost")
rig, _, obs = make_workload(cfg, 2, run["n_landmarks"], dev)
f0, f1 = obs.frame(0), obs.frame(1)
v0, v1 = stereo_triangulate(rig, f0, cfg)[4], stereo_triangulate(rig, f1, cfg)[4]
st5 = (f0.desc_top, f0.desc_bottom, f0.valid_top, f0.valid_bottom, azimuth_of(f0.ray_top),
       azimuth_of(f0.ray_bottom))
report("matcher", "c5_1024_stereo", lambda: match_stats_cuda(*st5, band=cfg.frontend.stereo_band_rad))
report("matcher", "c5_1024_temporal", lambda: match_stats_cuda(f0.desc_top, f1.desc_top, v0, v1))
# c4 lane 0's frame-0 stereo match (K=512)
cfg, run = load_preset("c4_batched_replay")
rig, _, obs = make_batched_workload(cfg, 1, 1, run["n_landmarks"], dev)
f0 = type(obs)(*(x[0, 0] for x in obs))
st4 = (f0.desc_top, f0.desc_bottom, f0.valid_top, f0.valid_bottom, azimuth_of(f0.ray_top),
       azimuth_of(f0.ray_bottom))
report("matcher", "c4_lane0_512_stereo",
       lambda: match_stats_cuda(*st4, band=cfg.frontend.stereo_band_rad))
# c2 as written, image mode: frames 0 and 30, extracted on the card
cfg, run = load_image_preset("c2_chip_ba")
rig, _, _, _, obs = make_image_workload(cfg, 31, dev, keep_images=False)
f0, f30 = obs.frame(0), obs.frame(30)
v0, v30 = stereo_triangulate(rig, f0, cfg)[4], stereo_triangulate(rig, f30, cfg)[4]
sti = (f0.desc_top, f0.desc_bottom, f0.valid_top, f0.valid_bottom, azimuth_of(f0.ray_top),
       azimuth_of(f0.ray_bottom))
report("matcher", "c2_image_512_stereo",
       lambda: match_stats_cuda(*sti, band=cfg.frontend.stereo_band_rad))
report("matcher", "c2_image_512_temporal_0_30",
       lambda: match_stats_cuda(f0.desc_top, f30.desc_top, v0, v30))
for W, L in ((5, 512), (5, 1024), (8, 4096), (2, 2048), (8, 512)):
    J = torch.randn((L, 6, 3), generator=gen, device=dev)
    H_ll = torch.einsum("lri,lrj->lij", J, J) + torch.eye(3, device=dev)
    G = torch.randn((W, 8, 6), generator=gen, device=dev)
    H_cc = 50.0 * (torch.einsum("wri,wrj->wij", G, G) + torch.eye(6, device=dev))
    H_cl = torch.randn((W, L, 6, 3), generator=gen, device=dev)
    b_c, b_l = torch.randn((W, 6), generator=gen, device=dev), torch.randn((L, 3), generator=gen, device=dev)
    lam = torch.full((), 1e-3, device=dev)  # a device tensor, as the BA path passes it
    report("schur", f"W{W}_L{L}", lambda: schur_reduce_cuda(H_cc, H_cl, H_ll, b_c, b_l, lam))
"""

# the main path's ka x kb; 1024x1024: every c5 rank's frame
MATCHER_SHAPES = ((512, 512), (1024, 2048), (2048, 2048), (4096, 1024), (1024, 1024))
# W, L; W2/L2048: c3's loop window; W8/L512: one of c5's 8 landmark shards
SCHUR_SHAPES = ((5, 512), (5, 1024), (8, 4096), (2, 2048), (8, 512))


def library_yardsticks(device) -> None:
    """One torch.matmul per shape computing the kernels' product (f32):
    the +/-1 bits' product of the matcher, A (6W x 3L) @ H_cl (3L x 6W) for
    the Schur reduction's S_off."""
    from sosvo_torch.frontend.match import unpack_bits_pm1
    from sosvo_torch.tools.workload import cuda_ms

    gen = torch.Generator(device=device).manual_seed(11)
    for (ka, kb) in MATCHER_SHAPES:
        a = unpack_bits_pm1(torch.randint(-2**31, 2**31, (ka, 8), generator=gen, dtype=torch.int32,
                                          device=device))
        bt = unpack_bits_pm1(torch.randint(-2**31, 2**31, (kb, 8), generator=gen,
                                           dtype=torch.int32, device=device)).T.contiguous()
        print(f"library matcher {ka}x{kb}: torch.matmul ({ka}x256)@(256x{kb}) f32 "
              f"ms={cuda_ms(lambda: torch.matmul(a, bt), 200)}", flush=True)
    for W, L in SCHUR_SHAPES:
        A = torch.randn((6 * W, 3 * L), generator=gen, device=device)
        H = torch.randn((3 * L, 6 * W), generator=gen, device=device)
        print(f"library schur W{W}_L{L}: torch.matmul ({6 * W}x{3 * L})@({3 * L}x{6 * W}) f32 "
              f"ms={cuda_ms(lambda: torch.matmul(A, H), 200)}", flush=True)


def launch_floor(device) -> None:
    """Device us and events per call (profiler) and wrapper ms (CUDA
    events) of probes with no work, through the package's ctypes route: an
    empty kernel; the matcher's grid at each main-path shape, as
    `sosvo_match_grid` sizes it, with every block taking a ticket, as its
    column decode does; one launch of the
    Schur kernel's clusters at its shared memory, two cluster.sync() each."""
    import ctypes

    from sosvo_torch.kernels import build, schur_cuda
    from sosvo_torch.tools.workload import cuda_ms

    lib = build.load()
    ticket = torch.zeros(1, dtype=torch.int32, device=device)
    grid = (ctypes.c_int * 4)()

    def probe(fn, *args):
        def run():
            if build.launch(device, fn, *args, build.stream_of(device)) != 0:
                raise RuntimeError(f"{fn.__name__} launch failed")
        us, events, _ = _device_us_per_call(run)
        return f"device_us_per_call={us} device_events_per_call={events} wrapper_ms={cuda_ms(run, 200)}"

    print(f"launch floor: empty kernel {probe(lib.sosvo_empty_kernel)}", flush=True)
    for ka, kb in MATCHER_SHAPES:
        if build.launch(device, lib.sosvo_match_grid, ka, kb, grid) != 0:
            raise RuntimeError("sosvo_match_grid failed")
        print(f"launch floor: ticket grid of the matcher at {ka}x{kb} ({grid[0]}x{grid[1]} blocks "
              f"of {grid[2]}) {probe(lib.sosvo_ticket_kernel, ka, kb, ticket.data_ptr())}", flush=True)
    cluster, resident = schur_cuda.cluster_shape(device)
    for W, L in SCHUR_SHAPES:
        clusters, tile, groups = schur_cuda.schedule(W, L, cluster, resident)
        smem = schur_cuda.smem_bytes(W, tile, groups)
        print(f"launch floor: Schur clusters at W{W}_L{L} ({clusters} x {cluster} CTAs, {smem} B) "
              f"{probe(lib.sosvo_cluster_kernel, clusters, smem)}", flush=True)


def _host_us(fn, n: int = 2000) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def wrapper_host_breakdown(device) -> None:
    """Host us of one wrapper call of each kernel at its main-path shape
    (512x512 stereo; W5/L512) and of the steps it is made of, each timed
    alone over 2000 calls (enqueue only, no synchronisation)."""
    from sosvo_torch.kernels import build, schur_cuda

    lib = build.load()
    empty = lambda: build.launch(device, lib.sosvo_empty_kernel, build.stream_of(device))  # noqa: E731
    cfg, run = load_preset("c1_cpu_smoke")
    _, _, obs = make_workload(cfg, 1, run["n_landmarks"], device)
    f0 = obs.frame(0)
    args = (f0.desc_top, f0.desc_bottom, f0.valid_top, f0.valid_bottom,
            pipeline.azimuth_of(f0.ray_top), pipeline.azimuth_of(f0.ray_bottom))
    band = cfg.frontend.stereo_band_rad
    out = torch.empty(4 * 512, device=device)
    checks = [(args[0], torch.int32, (512, 8)), (args[1], torch.int32, (512, 8)),
              (args[2], torch.bool, (512,)), (args[3], torch.bool, (512,)),
              (args[4], torch.float32, (512,)), (args[5], torch.float32, (512,))]
    steps = {
        "match_stats_cuda (whole wrapper)": lambda: match_stats_cuda(*args, band=band),
        "six argument checks": lambda: [match_cuda._check("x", t, d, sh, device)
                                        for t, d, sh in checks],
        "six .contiguous() calls": lambda: [a.contiguous() for a in args],
        "torch.empty of the outputs": lambda: torch.empty(4 * 512, device=device),
        "the outputs' views (split_with_sizes, view, split_with_sizes)":
            lambda: (out.split_with_sizes((512, 512, 1024)),
                     out[1024:].view(torch.int32).split_with_sizes((512, 512))),
        "the scratch's pointers": lambda: match_cuda._scratch_for(device, build.stream_of(device), 512),
        "ten .data_ptr() calls": lambda: [a.data_ptr() for a in args + args[:4]],
        "build.launch of the empty kernel (ctypes call and launch)": empty,
    }
    for name, fn in steps.items():
        print(f"host matcher: {name}: us_per_call={_host_us(fn)}", flush=True)
    gen = torch.Generator(device=device).manual_seed(3)
    W, L = 5, 512
    blocks = (torch.eye(6, device=device).expand(W, 6, 6).contiguous(),
              torch.randn((W, L, 6, 3), generator=gen, device=device),
              torch.eye(3, device=device).expand(L, 3, 3).contiguous(),
              torch.randn((W, 6), generator=gen, device=device),
              torch.randn((L, 3), generator=gen, device=device))
    lam = torch.full((), 1e-3, device=device)
    shapes = [(W, L, 6, 3), (W, 6, 6), (L, 3, 3), (W, 6), (L, 3)]
    n_out = 2 * W * W * 36 + 12 * W + 9 * L
    out = torch.empty(n_out, device=device)
    steps = {
        "schur_reduce_cuda (whole wrapper)": lambda: schur_reduce_cuda(*blocks, lam),
        "five argument checks": lambda: [schur_cuda._check("x", t, sh, device, contiguous=False)
                                         for t, sh in zip((blocks[1], blocks[0], *blocks[2:]), shapes)],
        "the schedule": lambda: schur_cuda.schedule(W, L, *schur_cuda.cluster_shape(device)),
        "torch.empty of the outputs": lambda: torch.empty(n_out, device=device),
        "the outputs' views (split_with_sizes, five views)":
            lambda: [t.view(-1) for t in out.split_with_sizes((W * W * 36, 6 * W, 9 * L, W * W * 36, 6 * W))],
        "build.launch of the empty kernel (ctypes call and launch)": empty,
    }
    for name, fn in steps.items():
        print(f"host schur W5/L512: {name}: us_per_call={_host_us(fn)}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ba", action="store_true", help="profile the window-BA replay")
    ap.add_argument("--pgo", action="store_true", help="profile c3's loop-closure leg")
    ap.add_argument("--images", action="store_true",
                    help="profile the image-mode presets' frontend and BA replay")
    ap.add_argument("--descriptor", nargs="+", default=["brief"],
                    choices=["brief", "sift", "akaze"],
                    help="with --images: the descriptor families to profile, in turn")
    ap.add_argument("--batched", action="store_true",
                    help="profile c4's batched replay at S = 1, 2, 4 and 8 lanes")
    ap.add_argument("--kernels", nargs="*", metavar="TREE",
                    help="the kernels alone at every main-path shape, for each source tree "
                         "(none: only the yardsticks, the launch floor and the host breakdown)")
    ap.add_argument("--rounds", type=int, default=2, help="turns over the trees (--kernels)")
    args = ap.parse_args()
    device = default_device()
    print(f"card: {card_info()}", flush=True)
    if args.kernels is not None:
        device = torch.device("cuda", torch.cuda.current_device())  # the index the tensors carry
        run_in_turns(KERNEL_WORKER, args.kernels, args.rounds, "KERNEL")
        library_yardsticks(device)
        launch_floor(device)
        wrapper_host_breakdown(device)
        return
    if args.pgo:
        profile_pgo(device)
        return
    if args.images:
        for descriptor in args.descriptor:
            profile_images(device, descriptor)
        return
    if args.batched:
        profile_batched(device)
        return
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
