"""Where a replay's time goes on the card: torch.profiler over one replay.

    python -m sosvo_torch.tools.profile_replay [--ba]
    python -m sosvo_torch.tools.profile_replay --kernels [TREE ...] [--rounds N]

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

With --kernels, both kernels alone at every main-path shape, for each
source TREE (the root of a checkout of the port; `.` for this one), one
process per tree, in turns (A B, B A, ...): device us per call and device
events per call (profiler over 50 calls) and wrapper ms (CUDA events over
200 back-to-back calls). Matcher: the stereo and temporal matches of a c1
frame (K=512) and of a frame at c3's sizes (K=2048), and the map
associations L x K at 512x512 (c2), 1024x2048 (c3 sizes) and 4096x1024
(c5) on random descriptors with 40 planted matches; Schur: random SPD
windows at W5/L512 (c2), W5/L1024 (c3 sizes) and W8/L4096 (c5). The worker
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
import functools
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sosvo_torch.frontend.match import match_stats
from sosvo_torch.kernels import match_cuda
from sosvo_torch.kernels.match_cuda import match_stats_cuda
from sosvo_torch.kernels.schur_cuda import schur_reduce_cuda, schur_reduce_plain
from sosvo_torch.tools.paired import run_in_turns
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


KERNEL_WORKER = r"""
import sys
import torch
from sosvo_torch.kernels.match_cuda import match_stats_cuda
from sosvo_torch.kernels.schur_cuda import schur_reduce_cuda
from sosvo_torch.tools.profile_replay import _device_us_per_call
from sosvo_torch.tools.workload import cuda_ms, load_preset, make_workload
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
for ka, kb in ((512, 512), (1024, 2048), (4096, 1024)):
    da = torch.randint(-2**31, 2**31, (ka, 8), generator=gen, dtype=torch.int32, device=dev)
    db = torch.randint(-2**31, 2**31, (kb, 8), generator=gen, dtype=torch.int32, device=dev)
    db[:40] = da[:40]
    va = torch.rand(ka, generator=gen, device=dev) < 0.9
    vb = torch.rand(kb, generator=gen, device=dev) < 0.9
    report("matcher", f"association_{ka}x{kb}", lambda: match_stats_cuda(da, db, va, vb))
for W, L in ((5, 512), (5, 1024), (8, 4096)):
    J = torch.randn((L, 6, 3), generator=gen, device=dev)
    H_ll = torch.einsum("lri,lrj->lij", J, J) + torch.eye(3, device=dev)
    G = torch.randn((W, 8, 6), generator=gen, device=dev)
    H_cc = 50.0 * (torch.einsum("wri,wrj->wij", G, G) + torch.eye(6, device=dev))
    H_cl = torch.randn((W, L, 6, 3), generator=gen, device=dev)
    b_c, b_l = torch.randn((W, 6), generator=gen, device=dev), torch.randn((L, 3), generator=gen, device=dev)
    lam = torch.full((), 1e-3, device=dev)  # a device tensor, as the BA path passes it
    report("schur", f"W{W}_L{L}", lambda: schur_reduce_cuda(H_cc, H_cl, H_ll, b_c, b_l, lam))
"""

MATCHER_SHAPES = ((512, 512), (1024, 2048), (2048, 2048), (4096, 1024))  # the main path's ka x kb


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
    for W, L in ((5, 512), (5, 1024), (8, 4096)):
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
    for W, L in ((5, 512), (5, 1024), (8, 4096)):
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
