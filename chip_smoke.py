#!/usr/bin/env python
"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints its numbers; any failure raises and exits non-zero):
  1. build the CUDA kernels from sosvo_torch/csrc with nvcc (one nvcc per
     source, all started together);
  2. hold the Hamming-match kernel against its plain PyTorch twin on the card
     -- every statistic must be equal, every index in range -- and time both
     with CUDA events: random descriptors at 200x170 with and without the
     azimuth band, the ragged 1x300, 300x1, 513x257, 17x9 and 1x1, all
     descriptors equal (a tie at every column), all rows invalid, azimuths
     straddling +/-pi in the band, and 2048x2048; the stereo and temporal
     matches of a c1 frame (K=512) and of a frame at c3's sizes (K=2048);
     three matcher calls back to back on one stream with no host sync
     (the column scratch must come back clean after each); each wrapper
     counts exactly one launch per call, and a call that raises none;
  3. replay the c1 workload at bench.py's shape (configs/c1_cpu_smoke.json,
     0.3 px noise, 2 % descriptor bit flips): ATE < 0.02 m, pose_ok on
     frames 1-9, exactly 2 matcher launches per frame;
  4. replay at c3's sizes (K=2048, H=1024, 200 frames, 16384 landmarks) in
     OBSERVATION mode, frame to frame: ATE < 0.2 m, pose_ok on all 199
     tracked frames, 2 launches per frame;
  5. replay c2 with keyframed window BA at full width (configs/c2_chip_ba.json
     in observation mode: K=512, H=512, W=5, L=512, 60 frames, 8192
     landmarks): pose_ok 59/59, 15 keyframes, exactly 70 Schur launches,
     2 x 60 + 15 + (relocalisations) matcher launches, all 512 map slots
     filled, ATE < 0.02 m and below the frame-to-frame replay's on the same
     observations;
  6. the same BA replay at c3's sizes (K=2048, H=1024, W=5, L=1024, 200
     frames): pose_ok 199/199, 50 keyframes, 245 Schur launches, ATE < 0.02 m
     (not the c3 image pipeline: no frontend, no loop closure);
 6b. a 24-frame BA replay at c2's widths whose frames 8-12 lose their
     descriptors: relocalisation runs (on at least one frame), pose_ok holds
     outside the dropout, the pose is re-acquired after it, and matcher
     launches are 2 x 24 + keyframes + relocalisations;
  7. hold the Schur-reduction kernel against its plain version on the card
     (raw S_off, b_sub and inverses, each relative to its own largest
     magnitude: 1e-5, 1e-5, 1e-4), check that two calls are bit-identical,
     and time kernel, plain version and a library yardstick: a late c2
     window (W=5, L=512), a late window at c3's sizes (W=5, L=1024), a
     synthetic c5-size window (W=8, L=4096), ragged L=1, 100 and 513 and
     W=2; wrong dtype, device and layout must raise;
  8. hold the matcher against its plain twin at the map-association shapes
     (L x K: a late c2 keyframe's 512x512, 1024x2048 at c3's sizes, and
     4096x1024), with its bound and a library yardstick.
Each replay resets the launch counts just before it and reads them just
after. Then it counts each kernel's device events per call (profiler; 1
each: one launch, no fills or copies), prints the card's name and power
limit, one JSON line describing each kernel (with its route: the matcher's
b1 tensor-core product, the Schur kernel's cluster size), and as the last
line {"ok": true, "device": {...}}.
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
SCHUR_TOL = {"S_off": 1e-5, "b_sub": 1e-5, "H_ll_inv": 1e-4}


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


def in_turns(plain, kern, reps: int = 200) -> tuple[float, float]:
    """(kernel ms, plain ms) per call: CUDA events in turns plain, kernel,
    kernel, plain on one card."""
    from sosvo_torch.tools.workload import cuda_ms

    p1, k1, k2, p2 = cuda_ms(plain, reps), cuda_ms(kern, reps), cuda_ms(kern, reps), cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def compare_kernel(name, args, band, cfg):
    """Kernel vs plain on one input: all four statistics equal, every index
    in range, the match contract equal, and both timed.
    Returns a dict with max_abs_err, ms, plain_ms, bound_ms, bound_by."""
    import torch
    from sosvo_torch.frontend.match import match_from_stats, match_stats
    from sosvo_torch.kernels.match_cuda import match_stats_cuda
    from sosvo_torch.tools.bounds import matcher_bound_ms

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

    ms, plain_ms = in_turns(lambda: match_stats(da, db, va, vb, aza, azb, band),
                            lambda: match_stats_cuda(da, db, va, vb, aza, azb, band))
    bound_ms, bound_by = matcher_bound_ms(ka, kb, band > 0.0)
    print(f"kernel_vs_plain {name}: {ka}x{kb} band={band} equal=yes "
          f"valid_matches={n_valid} max_abs_err={err} kernel_ms={ms:.6f} plain_ms={plain_ms:.6f} "
          f"bound_ms={bound_ms:.6g} ({bound_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def matcher_library_ms(label: str, ka: int, kb: int, device) -> float:
    """One torch.matmul of the +/-1-unpacked bits at ka x kb (f32): the
    distances' product, as a library call the port never makes."""
    import torch
    from sosvo_torch.frontend.match import unpack_bits_pm1
    from sosvo_torch.tools.workload import cuda_ms

    gen = torch.Generator(device=device).manual_seed(11)
    a = unpack_bits_pm1(torch.randint(-2**31, 2**31, (ka, 8), generator=gen, dtype=torch.int32,
                                      device=device))
    bt = unpack_bits_pm1(torch.randint(-2**31, 2**31, (kb, 8), generator=gen, dtype=torch.int32,
                                       device=device)).T.contiguous()
    ms = cuda_ms(lambda: torch.matmul(a, bt), 200)
    print(f"matcher_library {label}: torch.matmul of +/-1 bits ({ka}x256)@(256x{kb}) f32 "
          f"ms={ms:.6f}", flush=True)
    return ms


def main_matcher_args(cfg, n_landmarks, device):
    """The stereo match's inputs of frame 0 of a workload with `cfg`'s K."""
    from sosvo_torch.tools.workload import make_workload
    from sosvo_torch.vo.pipeline import azimuth_of

    _, _, obs = make_workload(cfg, 1, n_landmarks, device)
    f0 = obs.frame(0)
    return (f0.desc_top, f0.desc_bottom, f0.valid_top, f0.valid_bottom,
            azimuth_of(f0.ray_top), azimuth_of(f0.ray_bottom))


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


def timed_replays(replay, reps: int) -> float:
    import torch

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        replay()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def replay_phase(label: str, cfg, n_frames: int, n_landmarks: int, max_ate: float,
                 device, timed_reps: int):
    """One checked frame-to-frame replay (launch count, pose_ok, ATE), then
    timed replays. Returns the matcher's launches."""
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

    med = timed_replays(replay, timed_reps)
    print(f"replay {label}: K={k} H={cfg.ransac.n_hyps} frames={n_frames} "
          f"landmarks={n_landmarks} noise={PIXEL_NOISE}px flips={DESC_FLIP} "
          f"ATE_m={rmse} pose_ok={n_ok}/{n_frames - 1} kernel_launches={launches} "
          f"gate_ran_on={gate_runs}/{n_frames - 1} replay_s_median={med} "
          f"frames_per_s={n_frames / med} (host clock, {timed_reps} runs after one checked run)",
          flush=True)
    return launches


def ba_replay_phase(label: str, cfg, n_frames: int, n_landmarks: int, max_ate: float,
                    device, timed_reps: int, vs_f2f: bool):
    """One checked keyframed-BA replay, then timed replays. Returns
    (matcher launches, Schur launches, rig, scene, obs, final state)."""
    import torch
    from sosvo_torch.eval.ate import ate_rmse
    from sosvo_torch.kernels import match_cuda, schur_cuda
    from sosvo_torch.tools.workload import ba_replayer, make_workload, replayer

    rig, scene, obs = make_workload(cfg, n_frames, n_landmarks, device)
    replay = ba_replayer(cfg, rig, scene, obs, device)
    torch.cuda.synchronize()

    match_cuda.reset_launches()
    schur_cuda.reset_launches()
    final, outs = replay()
    torch.cuda.synchronize()
    m_launches, s_launches = match_cuda.launches, schur_cuda.launches
    gt = scene.poses[1:, :3, 3]
    rmse = float(ate_rmse(outs.vo.T_world[1:, :3, 3], gt)[0])
    n_ok = int(outs.vo.pose_ok[1:].sum())
    n_kf = int(outs.is_keyframe.sum())
    n_reloc = int(outs.reloc_tried.sum())
    n_lm = int(outs.n_landmarks[-1])
    kf_every = cfg.keyframe_every
    want_kf = (n_frames + kf_every - 1) // kf_every
    want_schur = (want_kf - 1) * cfg.ba.iters
    check(bool(torch.isfinite(outs.vo.T_world).all()), f"{label}: non-finite pose")
    check(n_ok == n_frames - 1, f"{label}: pose_ok on {n_ok}/{n_frames - 1} frames")
    check(n_kf == want_kf, f"{label}: {n_kf} keyframes, expected {want_kf}")
    check(s_launches == want_schur, f"{label}: {s_launches} Schur launches, expected {want_schur}")
    check(m_launches == 2 * n_frames + n_kf + n_reloc,
          f"{label}: {m_launches} matcher launches, expected {2 * n_frames} + {n_kf} + {n_reloc}")
    check(n_lm == cfg.ba.max_landmarks, f"{label}: map holds {n_lm}/{cfg.ba.max_landmarks}")
    check(rmse < max_ate, f"{label}: ATE {rmse} m >= {max_ate} m")
    f2f = ""
    if vs_f2f:
        _, o_f2f = replayer(cfg, rig, scene, obs, device)()
        rmse_f2f = float(ate_rmse(o_f2f.T_world[1:, :3, 3], gt)[0])
        check(rmse < rmse_f2f, f"{label}: BA ATE {rmse} m not below frame-to-frame {rmse_f2f} m")
        f2f = f" ATE_frame_to_frame_m={rmse_f2f}"

    med = timed_replays(replay, timed_reps)
    print(f"replay {label}: K={cfg.frontend.max_features} H={cfg.ransac.n_hyps} "
          f"W={cfg.ba.window} L={cfg.ba.max_landmarks} iters={cfg.ba.iters} "
          f"huber={cfg.ba.huber_delta} frames={n_frames} landmarks={n_landmarks} "
          f"ATE_m={rmse}{f2f} pose_ok={n_ok}/{n_frames - 1} keyframes={n_kf} "
          f"relocalisations={n_reloc} map_slots={n_lm}/{cfg.ba.max_landmarks} "
          f"schur_launches={s_launches} matcher_launches={m_launches} "
          f"replay_s_median={med} frames_per_s={n_frames / med} "
          f"(host clock, {timed_reps} runs after one checked run)", flush=True)
    return m_launches, s_launches, rig, scene, obs, final


def ba_dropout_phase(cfg, n_landmarks: int, device) -> tuple[int, int]:
    """A 24-frame BA replay at `cfg`'s widths whose frames 8-12 lose their
    descriptors in both views while the rig keeps moving
    (tests/test_reloc.py's dropout): relocalisation runs on the card, tracking
    holds outside the dropout and its next frame, the pose after it is
    re-acquired (ATE over frames 14.. < 0.05 m), and every matcher launch is
    accounted for. Returns (matcher launches, Schur launches)."""
    import torch
    from sosvo_torch.eval.ate import ate_rmse
    from sosvo_torch.kernels import match_cuda, schur_cuda
    from sosvo_torch.tools.workload import ba_replayer, make_workload

    n_frames, drop = 24, slice(8, 13)
    rig, scene, obs = make_workload(cfg, n_frames, n_landmarks, device)
    gen = torch.Generator(device=device).manual_seed(7)
    dead = {}
    for name in ("desc_top", "desc_bottom"):
        d = getattr(obs, name).clone()
        d[drop] = torch.randint(-2**31, 2**31, d[drop].shape, generator=gen, dtype=d.dtype,
                                device=device)
        dead[name] = d
    replay = ba_replayer(cfg, rig, scene, obs._replace(**dead), device)
    torch.cuda.synchronize()

    match_cuda.reset_launches()
    schur_cuda.reset_launches()
    _, outs = replay()
    torch.cuda.synchronize()
    m_launches, s_launches = match_cuda.launches, schur_cuda.launches
    ok = outs.vo.pose_ok.cpu()
    tried = outs.reloc_tried.cpu()
    n_kf, n_reloc = int(outs.is_keyframe.sum()), int(tried.sum())
    held = torch.cat([ok[1:drop.start], ok[drop.stop + 1:]])
    rmse = float(ate_rmse(outs.vo.T_world[drop.stop + 1:, :3, 3],
                          scene.poses[drop.stop + 1:, :3, 3])[0])
    label = "c2_ba_dropout"
    check(bool(torch.isfinite(outs.vo.T_world).all()), f"{label}: non-finite pose")
    check(n_reloc > 0, f"{label}: relocalisation never ran")
    check(not bool(tried[:drop.start].any()), f"{label}: relocalised before the dropout")
    check(bool(held.all()), f"{label}: pose_ok lost outside the dropout: {ok.tolist()}")
    check(rmse < 0.05, f"{label}: ATE after the dropout {rmse} m >= 0.05 m")
    check(s_launches == (n_kf - 1) * cfg.ba.iters,
          f"{label}: {s_launches} Schur launches, expected {(n_kf - 1) * cfg.ba.iters}")
    check(m_launches == 2 * n_frames + n_kf + n_reloc,
          f"{label}: {m_launches} matcher launches, expected {2 * n_frames} + {n_kf} + {n_reloc}")
    print(f"replay {label}: K={cfg.frontend.max_features} H={cfg.ransac.n_hyps} W={cfg.ba.window} "
          f"L={cfg.ba.max_landmarks} frames={n_frames} dead_descriptors=frames "
          f"{drop.start}-{drop.stop - 1} relocalisations={n_reloc} on frames "
          f"{torch.nonzero(tried).flatten().tolist()} pose_ok={ok.int().tolist()} "
          f"ATE_after_dropout_m={rmse} keyframes={n_kf} schur_launches={s_launches} "
          f"matcher_launches={m_launches}", flush=True)
    return m_launches, s_launches


def window_blocks(rig, cfg, m):
    """The blocks `lm_step` reduces in the first LM iteration of the window
    `m`: Huber-weighted observations, as `ba_solve` builds them."""
    import torch
    from sosvo_torch.backend.ba import BAWindow, build_blocks, huber_weights
    from sosvo_torch.sensor.model import viewpoint

    vps = torch.stack([viewpoint(rig.top), viewpoint(rig.bottom)])
    win = BAWindow(X=m.kf_X, landmarks=m.lm_pos, rays=m.obs_rays, weights=m.obs_w, viewpoints=vps)
    win = win._replace(weights=win.weights * huber_weights(win, cfg.ba.huber_delta))
    return build_blocks(win)[:5]


def synthetic_window_blocks(device, W: int = 8, L: int = 4096):
    """A c5-size window (W keyframes 4 frames apart, L landmarks, exact
    bearings where both views see the landmark, perturbed poses and
    landmarks) as `tests/test_ba.py::_make_window` builds one."""
    import torch
    from sosvo_torch.backend.ba import BAWindow, build_blocks
    from sosvo_torch.geom.lie import mat_inv, se3_exp, transform_points
    from sosvo_torch.sensor.model import project, viewpoint
    from sosvo_torch.sensor.rig import default_rig
    from sosvo_torch.synth.scene import make_landmarks, make_trajectory

    gen = torch.Generator(device=device).manual_seed(5)
    rig = default_rig(device=device)
    X = mat_inv(make_trajectory(4 * W, device=device)[::4])
    lms = make_landmarks(gen, L, device=device)
    vps = torch.stack([viewpoint(rig.top), viewpoint(rig.bottom)])
    p_rig = transform_points(X, lms)                              # (W, L, 3)
    d = p_rig[:, :, None, :] - vps
    rays = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    seen = project(rig.top, d[:, :, 0])[1] & project(rig.bottom, d[:, :, 1])[1]
    weights = seen[..., None].expand(W, L, 2).to(torch.float32)
    xi = 0.01 * torch.randn((W, 6), generator=gen, device=device)
    xi[0] = 0.0
    X0 = se3_exp(xi) @ X
    lms0 = lms + 0.02 * torch.randn(lms.shape, generator=gen, device=device)
    return build_blocks(BAWindow(X0, lms0, rays, weights, vps))[:5]


def compare_schur(name: str, blocks, lam: float):
    """Schur kernel vs plain on one window: raw outputs within SCHUR_TOL of
    the plain version relative to their own largest magnitude, two calls
    bit-identical, and kernel, plain and library yardstick timed."""
    import torch
    from sosvo_torch.kernels.schur_cuda import schur_reduce_cuda, schur_reduce_plain
    from sosvo_torch.tools.bounds import schur_bound_ms
    from sosvo_torch.tools.workload import cuda_ms

    H_cc, H_cl, H_ll, b_c, b_l = blocks
    W, L = H_cl.shape[:2]
    got = schur_reduce_cuda(H_cc, H_cl, H_ll, b_c, b_l, lam)
    again = schur_reduce_cuda(H_cc, H_cl, H_ll, b_c, b_l, lam)
    ref = schur_reduce_plain(H_cc, H_cl, H_ll, b_c, b_l, lam)
    torch.cuda.synchronize()
    for field, g, a in zip(got._fields, got, again):
        check(torch.equal(g, a), f"schur {name}: two calls differ in {field}")
    err, rel = {}, {}
    for field, tol in SCHUR_TOL.items():
        g, r = getattr(got, field), getattr(ref, field)
        check(bool(torch.isfinite(g).all()), f"schur {name}: non-finite {field}")
        err[field] = float((g - r).abs().max())
        rel[field] = err[field] / (float(r.abs().max()) + 1e-30)
        check(rel[field] < tol, f"schur {name}: {field} relative error {rel[field]} >= {tol}")
    ms, plain_ms = in_turns(lambda: schur_reduce_plain(H_cc, H_cl, H_ll, b_c, b_l, lam),
                            lambda: schur_reduce_cuda(H_cc, H_cl, H_ll, b_c, b_l, lam))
    # Library yardstick: S_off as one product of a precomputed A with H_cl,
    # both laid out (3L, 6W). The port never makes this call.
    A = torch.einsum("wlij,ljk->wlik", H_cl, ref.H_ll_inv)
    A_mat = A.permute(1, 3, 0, 2).reshape(3 * L, 6 * W).T.contiguous()
    H_mat = H_cl.permute(1, 3, 0, 2).reshape(3 * L, 6 * W).contiguous()
    lib = torch.matmul(A_mat, H_mat)
    lib_ref = ref.S_off.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
    check(float((lib - lib_ref).abs().max()) <= 1e-4 * float(lib_ref.abs().max()),
          f"schur {name}: library yardstick computes another function")
    library_ms = cuda_ms(lambda: torch.matmul(A_mat, H_mat), 200)
    bound_ms, bound_by = schur_bound_ms(W, L)
    print(f"schur_vs_plain {name}: W={W} L={L} lam={lam} bit_identical=yes "
          f"max_abs_err S_off={err['S_off']:.3e} b_sub={err['b_sub']:.3e} "
          f"H_ll_inv={err['H_ll_inv']:.3e} max_rel_err S_off={rel['S_off']:.3e} "
          f"b_sub={rel['b_sub']:.3e} H_ll_inv={rel['H_ll_inv']:.3e} kernel_ms={ms:.6f} "
          f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} bound_ms={bound_ms:.6g} "
          f"({bound_by})", flush=True)
    return dict(max_abs_err=max(err.values()), ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def schur_rejects(blocks) -> None:
    """Wrong dtype, device or layout raise (no silent copy, no fallback)."""
    from sosvo_torch.kernels.schur_cuda import schur_reduce_cuda

    H_cc, H_cl, H_ll, b_c, b_l = blocks
    bad = {"a float64 input": (H_cc.double(), H_cl, H_ll, b_c, b_l),
           "a CPU input": (H_cc, H_cl, H_ll.cpu(), b_c, b_l),
           "a non-contiguous H_ll": (H_cc, H_cl, H_ll.transpose(1, 2), b_c, b_l),
           "a non-contiguous H_cl block": (H_cc, H_cl.transpose(2, 3).contiguous().transpose(2, 3),
                                           H_ll, b_c, b_l)}
    for why, args in bad.items():
        try:
            schur_reduce_cuda(*args, 1e-3)
        except ValueError:
            continue
        check(False, f"schur_reduce_cuda accepted {why}")


def edge_problems(gen, device):
    """(name, args, band) of the matcher's edge cases: ragged shapes that
    are not multiples of its 16-row and 8-column tiles, all descriptors
    equal (every column ties across all rows), all rows invalid, and
    azimuths straddling +/-pi inside the band."""
    import torch

    out = [(f"random_{ka}x{kb}", random_problem(gen, ka, kb, device), band)
           for ka, kb, band in ((17, 9, 0.06), (1, 1, 0.0))]
    da, db, va, vb, aza, azb = random_problem(gen, 64, 48, device)
    out.append(("all_equal_64x48", (da[:1].expand(64, 8).contiguous(), da[:1].expand(48, 8).contiguous(),
                                    va, vb, aza, azb), 0.0))
    da, db, va, vb, aza, azb = random_problem(gen, 96, 80, device)
    out.append(("all_rows_invalid_96x80", (da, db, torch.zeros_like(va), vb, aza, azb), 0.0))
    da, db, va, vb, _, _ = random_problem(gen, 120, 100, device)
    aza = torch.pi - 0.05 * torch.rand(120, generator=gen, device=device)
    azb = -torch.pi + 0.05 * torch.rand(100, generator=gen, device=device)
    out.append(("band_straddles_pi_120x100", (da, db, va, vb, aza, azb), 0.06))
    return out


def matcher_back_to_back(gen, device) -> None:
    """Three calls on one stream, no host sync between them, on inputs of
    different widths: each equals the plain twin, so the column keys and
    the ticket are clean after every call."""
    import torch
    from sosvo_torch.frontend.match import match_stats
    from sosvo_torch.kernels.match_cuda import match_stats_cuda

    calls = [(random_problem(gen, 700, 600, device), 0.06), (random_problem(gen, 600, 900, device), 0.0),
             (random_problem(gen, 700, 600, device), 0.06)]
    got = [match_stats_cuda(*args, band=band) for args, band in calls]
    torch.cuda.synchronize()
    for i, ((args, band), g) in enumerate(zip(calls, got)):
        ref = match_stats(*args, band=band)
        for field, x, y in zip(ref._fields, g, ref):
            check(torch.equal(x, y), f"back-to-back call {i}: {field} differs from plain")
    print("matcher_back_to_back: 3 calls, no host sync between them, each equal to plain", flush=True)


def launch_counts(gen, device, blocks) -> None:
    """Each wrapper counts exactly one launch per call, and a call that
    raises counts none."""
    from sosvo_torch.kernels import match_cuda, schur_cuda

    args = random_problem(gen, 40, 30, device)
    for _ in range(3):
        before = match_cuda.launches
        match_cuda.match_stats_cuda(*args)
        check(match_cuda.launches == before + 1, "match_stats_cuda did not count one launch")
        before = schur_cuda.launches
        schur_cuda.schur_reduce_cuda(*blocks, 1e-3)
        check(schur_cuda.launches == before + 1, "schur_reduce_cuda did not count one launch")
    before = match_cuda.launches, schur_cuda.launches
    for fn, bad in ((match_cuda.match_stats_cuda, (args[0].float(), *args[1:4])),
                    (schur_cuda.schur_reduce_cuda, (blocks[0].double(), *blocks[1:], 1e-3))):
        try:
            fn(*bad)
        except ValueError:
            pass
    check((match_cuda.launches, schur_cuda.launches) == before, "a refused call counted a launch")
    print("launch_counts: one per call for each wrapper, none for a refused call", flush=True)


def device_events_per_call(fn, calls: int = 20) -> float:
    """Device events (kernels, copies, fills) per call of `fn`, from the
    profiler over `calls` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    return len(events) / calls


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this test needs one card", file=sys.stderr)
        return 1
    try:
        from sosvo_torch.kernels import build, schur_cuda
        from sosvo_torch.kernels.match_cuda import match_stats_cuda
        from sosvo_torch.kernels.schur_cuda import schur_reduce_cuda
        from sosvo_torch.tools.workload import card_info, load_preset
        from sosvo_torch.vo.pipeline import stereo_triangulate
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
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"build: ptxas {line.strip()}", flush=True)

    # 2. matcher against plain
    c1, c1_run = load_preset("c1_cpu_smoke")
    c2, c2_run = load_preset("c2_chip_ba")
    c3, c3_run = load_preset("c3_host_pgo")
    gen = torch.Generator(device=device).manual_seed(7)
    results = {}
    for ka, kb, band in ((200, 170, 0.0), (200, 170, 0.06), (1, 300, 0.06), (300, 1, 0.0),
                         (513, 257, 0.06)):
        results[f"{ka}x{kb}_band{band}"] = compare_kernel(
            f"random_{ka}x{kb}_band{band}", random_problem(gen, ka, kb, device), band, c1)
    for name, args, band in edge_problems(gen, device):
        results[name] = compare_kernel(name, args, band, c1)
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
    matcher_back_to_back(gen, device)

    # 3. frame-to-frame replay at bench.py's shape
    launches = {"c1_bench_shape": replay_phase(
        "c1_bench_shape", c1, c1_run["n_frames"], c1_run["n_landmarks"], 0.02, device,
        timed_reps=5)}

    # 4. frame-to-frame replay at c3's sizes, observation mode
    print("replay c3_sizes: observation mode at c3's K, H, frames and landmarks -- "
          "not the c3 image pipeline (frontend and loop closure are not ported)", flush=True)
    launches["c3_sizes_observations"] = replay_phase(
        "c3_sizes_observations", c3, c3_run["n_frames"], c3_run["n_landmarks"], 0.2, device,
        timed_reps=2)

    # 5. the slice's main path: c2 with keyframed window BA, full width
    c2_m, c2_s, c2_rig, _, c2_obs, c2_final = ba_replay_phase(
        "c2_ba_observations", c2, c2_run["n_frames"], c2_run["n_landmarks"], 0.02, device,
        timed_reps=3, vs_f2f=True)

    # 6. BA replay at c3's sizes
    c3_m, c3_s, c3_rig, _, c3_obs, c3_final = ba_replay_phase(
        "c3_sizes_ba_observations", c3, c3_run["n_frames"], c3_run["n_landmarks"], 0.02, device,
        timed_reps=1, vs_f2f=False)
    launches.update(c2_ba_observations=c2_m, c3_sizes_ba_observations=c3_m)

    # 6b. BA replay through a sensor dropout: relocalisation on the card
    drop_m, drop_s = ba_dropout_phase(c2, c2_run["n_landmarks"], device)
    launches["c2_ba_dropout"] = drop_m

    # 7. Schur kernel against its plain version
    c2_blocks = window_blocks(c2_rig, c2, c2_final.map)
    c3_blocks = window_blocks(c3_rig, c3, c3_final.map)
    lam = c2.ba.damping_init
    schur = {"c2_W5_L512": compare_schur("c2_late_window_W5_L512", c2_blocks, lam),
             "c3_W5_L1024": compare_schur("c3_late_window_W5_L1024", c3_blocks, lam),
             "c5_W8_L4096": compare_schur("c5_synthetic_W8_L4096",
                                          synthetic_window_blocks(device), lam)}
    H_cc, H_cl, H_ll, b_c, b_l = c2_blocks
    for n_lm in (1, 100):  # strided L slices of the c2 window: no copy
        schur[f"L{n_lm}"] = compare_schur(f"c2_ragged_L{n_lm}",
                                          (H_cc, H_cl[:, :n_lm], H_ll[:n_lm], b_c, b_l[:n_lm]), 1e-2)
    C_cc, C_cl, C_ll, C_c, C_l = c3_blocks
    schur["L513"] = compare_schur("c3_ragged_L513",
                                  (C_cc, C_cl[:, :513], C_ll[:513], C_c, C_l[:513]), lam)
    schur["W2"] = compare_schur("c2_W2_L512", (H_cc[:2], H_cl[:2], H_ll, b_c[:2], b_l), lam)
    schur_rejects(c2_blocks)
    launch_counts(gen, device, c2_blocks)

    # 8. matcher at the map-association shapes (L x K)
    def association(label, cfg, rig, final, obs, n_frames):
        """The final map against the last keyframe's features."""
        f = obs.frame((n_frames - 1) // cfg.keyframe_every * cfg.keyframe_every)
        _, desc, _, _, valid, _ = stereo_triangulate(rig, f, cfg)
        m = final.map
        results[label] = compare_kernel(label, (m.lm_desc, desc, m.lm_valid, valid, None, None),
                                        0.0, cfg)

    association("c2_map_association_512x512", c2, c2_rig, c2_final, c2_obs, c2_run["n_frames"])
    association("c3_map_association_1024x2048", c3, c3_rig, c3_final, c3_obs, c3_run["n_frames"])
    results["c5_4096x1024"] = compare_kernel(
        "random_map_association_4096x1024", random_problem(gen, 4096, 1024, device, planted=700),
        0.0, c1)
    lib512 = matcher_library_ms("512x512", 512, 512, device)
    matcher_library_ms("2048x2048", 2048, 2048, device)

    m_main = results["c1_512_stereo"]
    s_main = schur["c2_W5_L512"]
    m_args = main_matcher_args(c1, c1_run["n_landmarks"], device)
    m_events = device_events_per_call(lambda: match_stats_cuda(*m_args, band=c1.frontend.stereo_band_rad))
    lam_t = torch.full((), lam, device=device)
    s_events = device_events_per_call(lambda: schur_reduce_cuda(*c2_blocks, lam_t))
    check(m_events == 1.0 and s_events == 1.0,
          f"device events per call: matcher {m_events}, Schur {s_events}; expected 1 each")
    cluster, resident = schur_cuda.cluster_shape(device)
    clusters, _, _ = schur_cuda.schedule(5, c2.ba.max_landmarks, cluster, resident)
    print(f"device_events_per_call: matcher {m_events} Schur {s_events}; "
          f"Schur cluster size {cluster}, {resident} resident, clusters at W5/L512 {clusters}",
          flush=True)
    print(card, flush=True)  # name, power limit: nvidia-smi's own line
    print(json.dumps({"kernels": [
        {"name": "match_hamming", "route": "cuda",
         "source": "sosvo_torch/csrc/match_hamming.cu",
         "replaces": "sosvo/kernels/match_pallas.py:162",
         "launches": c2_m, "launches_by_path": launches,
         "max_abs_err": max(r["max_abs_err"] for r in results.values()),
         "ms": m_main["ms"], "plain_ms": m_main["plain_ms"], "bound_ms": m_main["bound_ms"],
         "bound_us": m_main["bound_ms"] * 1e3, "bound_by": m_main["bound_by"],
         "library_ms": lib512, "shape": "512x512 stereo (c1/c2 K=512, band 0.06)",
         "device_events_per_call": m_events,
         "tensor_core_route": "b1: mma.sync m16n8k256 .and.popc"},
        {"name": "schur_reduce", "route": "cuda",
         "source": "sosvo_torch/csrc/schur_reduce.cu",
         "replaces": "sosvo/kernels/schur_pallas.py:106",
         "launches": c2_s,
         "launches_by_path": {"c2_ba_observations": c2_s, "c3_sizes_ba_observations": c3_s,
                              "c2_ba_dropout": drop_s},
         "max_abs_err": max(r["max_abs_err"] for r in schur.values()),
         "ms": s_main["ms"], "plain_ms": s_main["plain_ms"], "bound_ms": s_main["bound_ms"],
         "bound_us": s_main["bound_ms"] * 1e3, "bound_by": s_main["bound_by"],
         "library_ms": s_main["library_ms"], "shape": "W=5, L=512 (late c2 window)",
         "device_events_per_call": s_events, "cluster_size": cluster,
         "clusters_at_shape": clusters},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
