#!/usr/bin/env python
"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints its numbers; any failure raises and exits non-zero):
  1. build the CUDA kernels from sosvo_torch/csrc with nvcc;
  2. hold the Hamming-match kernel against its plain PyTorch twin on the card
     -- every statistic must be equal, every index in range -- and time both
     with CUDA events: random descriptors at 200x170 with and without the
     azimuth band, the ragged 1x300, 300x1 and 513x257, and 2048x2048; the
     stereo and temporal matches of a c1 frame (K=512) and of a frame at
     c3's sizes (K=2048);
  3. replay the c1 workload at bench.py's shape (configs/c1_cpu_smoke.json,
     0.3 px noise, 2 % descriptor bit flips): ATE < 0.02 m, pose_ok on
     frames 1-9, exactly 2 kernel launches per frame;
  4. replay at c3's sizes (K=2048, H=1024, 200 frames, 16384 landmarks) in
     OBSERVATION mode -- not the c3 image pipeline: ATE < 0.2 m, pose_ok on
     all 199 tracked frames, 2 launches per frame.
Then it prints the card's name and power limit, one JSON line describing
each kernel, and as the last line {"ok": true, "device": {...}}.
Exits non-zero, printing no result, without a CUDA device or outside the
repository.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def random_problem(gen, ka: int, kb: int, device, planted: int = 40):
    """Random descriptors with `planted` shared rows (tests/test_match_pallas.py's shape)."""
    import torch

    def bits(n):
        return torch.randint(-2**31, 2**31, (n, 8), generator=gen, dtype=torch.int32,
                             device=device)

    n = min(planted, ka, kb)
    da, db = bits(ka), bits(kb)
    db[:n] = da[:n]
    va = torch.rand(ka, generator=gen, device=device) < 0.9
    vb = torch.rand(kb, generator=gen, device=device) < 0.9
    aza = (torch.rand(ka, generator=gen, device=device) * 2 - 1) * torch.pi
    azb = (torch.rand(kb, generator=gen, device=device) * 2 - 1) * torch.pi
    azb[:n] = aza[:n] + 0.01
    return da, db, va, vb, aza, azb


def compare_kernel(name, args, band, cfg):
    """Kernel vs plain on one input: all four statistics equal, every index
    in range, the match contract equal, and both timed.
    Returns (max_abs_err, ms, plain_ms)."""
    import torch
    from sosvo_torch.frontend.match import match_from_stats, match_stats
    from sosvo_torch.kernels.match_cuda import match_stats_cuda
    from sosvo_torch.tools.workload import cuda_ms

    da, db, va, vb, aza, azb = args
    ka, kb = da.shape[0], db.shape[0]
    got = match_stats_cuda(da, db, va, vb, aza, azb, band)
    ref = match_stats(da, db, va, vb, aza, azb, band)
    torch.cuda.synchronize()
    for field, g, r in zip(ref._fields, got, ref):
        check(torch.equal(g, r), f"{name}: kernel {field} differs from plain")
    check(0 <= int(got.idx_b.min()) and int(got.idx_b.max()) < kb, f"{name}: idx_b out of range")
    check(0 <= int(got.col_argmin.min()) and int(got.col_argmin.max()) < ka,
          f"{name}: col_argmin out of range")
    err = max(float(torch.where(g == r, 0.0, (g - r).abs()).max())
              for g, r in ((got.d_best, ref.d_best), (got.d_second, ref.d_second)))
    fe = cfg.frontend
    m_got = match_from_stats(got, va, fe.match_max_distance, fe.match_ratio)
    m_ref = match_from_stats(ref, va, fe.match_max_distance, fe.match_ratio)
    check(torch.equal(m_got.valid, m_ref.valid), f"{name}: valid differs")
    v = m_ref.valid
    check(torch.equal(m_got.idx_b[v], m_ref.idx_b[v]) and torch.equal(m_got.dist[v], m_ref.dist[v]),
          f"{name}: idx_b/dist differ where valid")
    n_valid = int(v.sum())

    def kern():
        return match_stats_cuda(da, db, va, vb, aza, azb, band)

    def plain():
        return match_stats(da, db, va, vb, aza, azb, band)

    # In turns (plain, kernel, kernel, plain) on one card.
    p1, k1, k2, p2 = cuda_ms(plain, 200), cuda_ms(kern, 200), cuda_ms(kern, 200), cuda_ms(plain, 200)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"kernel_vs_plain {name}: {ka}x{kb} band={band} equal=yes "
          f"valid_matches={n_valid} max_abs_err={err} kernel_ms={ms:.6f} plain_ms={plain_ms:.6f}",
          flush=True)
    return err, ms, plain_ms


def compare_frame_matches(label, cfg, n_landmarks, device, results):
    """Kernel vs plain on the stereo match of frame 0 and the temporal match
    of frame 0 -> 1 of a two-frame workload with `cfg`'s K."""
    from sosvo_torch.tools.workload import make_workload
    from sosvo_torch.vo.pipeline import azimuth_of, stereo_triangulate

    rig, _, obs = make_workload(cfg, 2, n_landmarks, device)
    f0, f1 = obs.frame(0), obs.frame(1)
    valid0 = stereo_triangulate(rig, f0, cfg)[4]
    valid1 = stereo_triangulate(rig, f1, cfg)[4]
    results[f"{label}_stereo"] = compare_kernel(
        f"{label}_stereo", (f0.desc_top, f0.desc_bottom, f0.valid_top, f0.valid_bottom,
                            azimuth_of(f0.ray_top), azimuth_of(f0.ray_bottom)),
        cfg.frontend.stereo_band_rad, cfg)
    results[f"{label}_temporal"] = compare_kernel(
        f"{label}_temporal", (f0.desc_top, f1.desc_top, valid0, valid1, None, None), 0.0, cfg)


def replay_phase(label: str, cfg, n_frames: int, n_landmarks: int, max_ate: float,
                 device, timed_reps: int):
    """One checked replay (launch count, pose_ok, ATE), then timed replays."""
    import torch
    from sosvo_torch.eval.ate import ate_rmse
    from sosvo_torch.kernels import match_cuda
    from sosvo_torch.tools.workload import DESC_FLIP, PIXEL_NOISE, make_workload, replayer

    k = cfg.frontend.max_features
    rig, scene, obs = make_workload(cfg, n_frames, n_landmarks, device)
    replay = replayer(cfg, rig, scene, obs, device)
    torch.cuda.synchronize()

    match_cuda.reset_launches()
    _, outs = replay()
    torch.cuda.synchronize()
    launches = match_cuda.launches
    rmse = float(ate_rmse(outs.T_world[1:, :3, 3], scene.poses[1:, :3, 3])[0])
    pose_ok = outs.pose_ok.cpu()
    n_ok = int(pose_ok[1:].sum())
    gate_runs = int((outs.ess_angle_err[1:] != 0).sum())
    check(launches == 2 * n_frames, f"{label}: {launches} kernel launches, expected {2 * n_frames}")
    check(bool(torch.isfinite(outs.T_world).all()), f"{label}: non-finite pose")
    check(n_ok == n_frames - 1, f"{label}: pose_ok on {n_ok}/{n_frames - 1} frames")
    check(rmse < max_ate, f"{label}: ATE {rmse} m >= {max_ate} m")

    times = []
    for _ in range(timed_reps):
        t0 = time.perf_counter()
        replay()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(f"replay {label}: K={k} H={cfg.ransac.n_hyps} frames={n_frames} "
          f"landmarks={n_landmarks} noise={PIXEL_NOISE}px flips={DESC_FLIP} "
          f"ATE_m={rmse} pose_ok={n_ok}/{n_frames - 1} kernel_launches={launches} "
          f"gate_ran_on={gate_runs}/{n_frames - 1} replay_s_median={med} "
          f"frames_per_s={n_frames / med} (host clock, {timed_reps} runs after one checked run)",
          flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this test needs one card", file=sys.stderr)
        return 1
    try:
        from sosvo_torch.kernels import build
        from sosvo_torch.kernels.match_cuda import match_stats_cuda
        from sosvo_torch.tools.workload import card_info, load_preset
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the repository root",
              file=sys.stderr)
        return 1

    device = torch.device("cuda", 0)
    card = card_info()
    print(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)

    # 1. build
    t0 = time.perf_counter()
    build.load()
    print(f"build: {build.library_path().relative_to(ROOT)} ready in "
          f"{time.perf_counter() - t0:.3f} s (nvcc, sm_90a)", flush=True)
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: ptxas {line.strip()}", flush=True)

    # 2. kernel against plain
    c1, c1_run = load_preset("c1_cpu_smoke")
    c3, c3_run = load_preset("c3_host_pgo")
    gen = torch.Generator(device=device).manual_seed(7)
    results = {}
    for ka, kb, band in ((200, 170, 0.0), (200, 170, 0.06), (1, 300, 0.06), (300, 1, 0.0),
                         (513, 257, 0.06)):
        results[f"{ka}x{kb}_band{band}"] = compare_kernel(
            f"random_{ka}x{kb}_band{band}", random_problem(gen, ka, kb, device), band, c1)
    results["2048"] = compare_kernel(
        "random_2048", random_problem(gen, 2048, 2048, device, planted=400),
        c1.frontend.stereo_band_rad, c1)
    compare_frame_matches("c1_512", c1, c1_run["n_landmarks"], device, results)
    compare_frame_matches("c3_2048", c3, c3_run["n_landmarks"], device, results)
    da, db, va, vb, _, _ = random_problem(gen, 16, 16, device)
    for bad, why in (((da.float(), db, va, vb), "float descriptors"),
                     ((da, db, va, vb, None, None, 0.06), "a band without azimuths")):
        try:
            match_stats_cuda(*bad)
        except ValueError:
            continue
        check(False, f"match_stats_cuda accepted {why}")

    # 3. replay at bench.py's shape
    c1_launches = replay_phase("c1_bench_shape", c1, c1_run["n_frames"], c1_run["n_landmarks"],
                               0.02, device, timed_reps=5)

    # 4. replay at c3's sizes, observation mode
    print("replay c3_sizes: observation mode at c3's K, H, frames and landmarks -- "
          "not the c3 image pipeline (frontend, BA, loop closure are not ported)", flush=True)
    replay_phase("c3_sizes_observations", c3, c3_run["n_frames"], c3_run["n_landmarks"],
                 0.2, device, timed_reps=3)

    err = max(r[0] for r in results.values())
    _, ms, plain_ms = results["c1_512_stereo"]
    print(card, flush=True)  # name, power limit: nvidia-smi's own line
    print(json.dumps({"kernels": [{
        "name": "match_hamming", "route": "cuda",
        "source": "sosvo_torch/csrc/match_hamming.cu",
        "replaces": "sosvo/kernels/match_pallas.py:162",
        "launches": c1_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
