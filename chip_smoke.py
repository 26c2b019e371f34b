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
     (observation mode; the preset's image pipeline is phase 7c);
 6c. c3's loop-closure leg on that BA replay, as sosvo/cli.py runs it after
     a c3 replay: `pgo_refine_trajectory` over the replay's keyframes with
     configs/c3_host_pgo.json's 160 candidates, 300 inliers and DCS 0.1:
     exactly one matcher launch per keyframe and per candidate pair and 4
     Schur launches per pair (the two-frame BA), every pose finite, at least
     one loop, and ATE at most the JAX package's for the same leg on the CPU
     (scripts/ref_c3_pgo_ate.py) plus a stated margin; then the matcher at
     the loop-pair shape (2048x2048, no band) and the Schur kernel on that
     pair's two-frame window (W=2, L=2048) against their plain versions;
     on the leg's pose graph, the f32 solves the leg runs: cg within 1e-3
     of dense, dense within 1e-4 of the same solve in float64 (cost within
     1e-4 relative), and the solve's cost below its initial cost with at
     least one step accepted; a second leg over the same trajectory, two
     builds of the normal equations and two dense solves bit-identical;
 6d. the same leg on phase 4's frame-to-frame replay (stride keyframes):
     ATE below the frame-to-frame ATE, and within the margin of the JAX
     package's figure;
 6b. a 24-frame BA replay at c2's widths whose frames 8-12 lose their
     descriptors: relocalisation runs (on at least one frame), pose_ok holds
     outside the dropout, the pose is re-acquired after it, and matcher
     launches are 2 x 24 + keyframes + relocalisations;
 7a. the image frontend on the card: frames 0 and 30 of c2's rendered
     sequence (sosvo/cli.py's room and trajectory, rendered on the card)
     extracted on the card and on the CPU from the same images and LUT
     values: validity, keypoint slots and descriptors equal (a slot may move
     only within a near-tie of responses, counted), uv within 1e-3 px, rays
     within 1e-6; the LUTs of both devices compared; then the matcher
     against its plain version on the extracted descriptors (stereo in the
     band, temporal);
 7b. c2 as written (configs/c2_chip_ba.json, image mode: rendered 768x768
     raw images, 128x1024 panoramas, K=512, window BA W=5, L=512, 60
     frames), with sosvo/cli.py's own RANSAC draws (jax.random's stream
     from PRNGKey(2), reproduced on the card by tools/reference_draws.py):
     pose_ok 59/59, 15 keyframes, 70 Schur launches, 2 x 60 + 15 +
     (relocalisations) matcher launches, ATE < 0.02 m and at most the JAX
     package's worst seed plus twice the spread (scripts/ref_image_ate.py);
     frames/s including extraction and the frontend's ms per frame;
 7c. c3 image-native (configs/c3_host_pgo.json as written: K=2048, W=5,
     L=1024, 200 frames), the BA replay held as 7b (pose_ok 199/199, 50
     keyframes; ATE against the reference alone: the JAX package's own c3
     image-mode BA ATE is 0.028-0.030 m), then the loop leg over its 50
     keyframes as 6c runs it, with the reference's per-pair draws, held to
     the JAX package's ATE after its leg, and two `build_system` calls on
     the leg's graph bit-identical;
 17. configs/c3_adaptive.json as written on 7c's rendered and extracted
     frames and its command-line draws (the preset renders and extracts as
     c3_host_pgo does): the window-BA replay with motion-adaptive keyframes
     (0.04 m, 0.08 rad, gaps 2 to 8) under PyTorch's sync debug mode, then
     the loop leg over the scan's own keyframes, `nonzero(is_keyframe)`,
     with the reference's per-pair draws: pose_ok 199/199, (n_kf - 1) x 5
     Schur and 2 x 200 + n_kf + relocalisations matcher launches in the
     replay, 2 host syncs per frame, every flag equal to the trigger's rule
     on the motion the replay saw, n_kf + 160 matcher and 640 Schur launches
     on the leg, a loop, the PoseGraph handed to `pgo_solve` with the scan's
     keyframes as its nodes, the correction constant within each governing
     segment, and the ATE before and after the leg under the JAX package's
     worst plus twice the spread over seeds 0-2 and shifted renders
     (scripts/ref_c3_adaptive_ate.py); it prints the card's keyframes beside
     the JAX package's seed 0 (the frames where they differ counted) and
     each threshold crossing's distance to its threshold;
  8. hold the Schur-reduction kernel against its plain version on the card
     (raw S_off, b_sub and inverses, each relative to its own largest
     magnitude: 1e-5, 1e-5, 1e-4), check that two calls are bit-identical,
     and time kernel, plain version and a library yardstick: a late c2
     window (W=5, L=512), a late window at c3's sizes (W=5, L=1024), a
     synthetic c5-size window (W=8, L=4096), ragged L=1, 100 and 513 and
     W=2; wrong dtype, device and layout must raise;
  9. hold the matcher against its plain twin at the map-association shapes
     (L x K: a late c2 keyframe's 512x512, 1024x2048 at c3's sizes, and
     4096x1024), with its bound and a library yardstick;
 10. c4 as written (configs/c4_batched_replay.json: S=4 lanes of 100
     frames, K=512, H=512, 8192 landmarks; W=5, L=512, a keyframe every 4
     frames), the lanes in lockstep, frame to frame and with window BA:
     pose_ok on every lane after frame 0, each lane's ATE under the JAX
     package's worst lane plus twice the spread (scripts/ref_c4_ate.py),
     matcher launches 2 x 4 x 100 (+ 4 x 25 associations + relocalisations
     in BA), Schur launches 0 and 4 x 24 x 5 = 480, syncs 1 and 2 per frame
     for the whole batch, and every lane equal to its sequential replay
     from the same generator (discrete outputs equal, poses within 1e-5
     and 1e-4); frames/s summed over the lanes; then both kernels at c4's
     shapes against their plain versions (lane 0's stereo match, its map
     association and its last window);
 14. the SIFT and AKAZE descriptor options (scripts/ref_descriptor_ate.py
     holds the JAX package's figures for the same presets):
     14a. each extractor at c2's width (K=512, 128x1024 panoramas) on the
          card against the port on the CPU, on frames 0 and 30 and the same
          LUT values: slots equal but for near-ties (counted), on equal
          slots validity, uv (1e-3 px) and rays (1e-6); AKAZE's M-LDB words
          (descriptors with a word apart counted, at most 1 %); SIFT's
          float descriptors within 1e-6 but for at most 1 % of them (a
          sample across an orientation-bin edge: the devices' `atan2`
          differ in the last bit), none 0.05 or more apart in L2; each
          extractor's host ms, device ms and device events per frame;
     14b. the Hamming kernel on frame 0's AKAZE descriptors, stereo in
          c2's band and temporal to frame 30: all four statistics equal
          the plain version (max_abs_err 0.0), both timed, and the
          kernel's device us and device events per call (profiler);
     14c. c2 as written with descriptor="akaze", window BA, the command
          line's draws (as 7b): pose_ok 59/59, 15 keyframes, 70 Schur and
          2 x 60 + 15 + relocalisations matcher launches, ATE at most the
          JAX package's worst plus twice the spread over seeds 0-2 and
          over seed 0 on the sequence rendered 0.1 and 0.3 um shifted
          (scripts/ref_descriptor_ate.py: the ATE moves with the render's
          rounding at checker edges, and the card's render rounds apart
          from the CPU's);
     14d. the same with descriptor="sift": its L2 matches are plain torch,
          so no matcher launch, 70 Schur launches, the same ATE rule; then
          the command line on a copy of the preset with "descriptor":
          "sift" (BA, a checkpoint every 16 frames), killed after frame 20
          and resumed: frames.jsonl byte for byte the uninterrupted run's;
     14e. c3 as written (configs/c3_host_pgo.json: K=2048, 200 frames) with
          descriptor="sift": the BA replay under the JAX package's limit
          (as 14c), then
          its loop leg (160 candidates; L2 loop-edge matches, float
          signatures) with the reference's pair draws: no matcher and 640
          Schur launches, a loop closed (the JAX package's rows close
          9-11), and ATE after the leg under its limit (as 14c);
 15. c2 as written (configs/c2_chip_ba.json) arriving as a staged capture:
     the port renders the command line's room, the frames are written as
     8-bit binary PGM files with the trajectory as a TUM file,
     sosvo_torch/tools/stage_sequence.py stages them to .npz and .sosq
     (frames equal to the quantised render exactly, through both) and
     save_rig writes the default rig; `python -m sosvo_torch.cli --mode ba
     --sequence` runs with and without `--rig` (two processes at once:
     pose_ok equal, counts within 2 and positions within 1e-4 m, the rig
     file's degrees round trip); in this process the command line's own
     replay path and `live_vo_ba` over SosqReader (with the rig read from
     the file too) equal the command line's trajectories bit for bit,
     pose_ok 59/59, 15 keyframes, 70 Schur and 2 x 60 + 15 (+
     relocalisations) matcher launches in the replay and in the live run,
     ATE under the JAX package's worst plus twice the spread
     (scripts/ref_sequence_ate.py: seeds 0-2 and seed 0 on shifted
     renders); then live with the JAX command line's draws (host syncs per
     live frame counted, `tools/sync_check.py`) and live frames/s against
     the replay's;
 16. calibration, then c2 on the fitted rig (tests/test_calib_to_vo.py's
     protocol at c2's widths; `calib_phase`): eight chessboard captures
     rendered on the card at 1536 px with a ground-truth rig perturbed in
     intrinsics, baseline, distortion and misalignment; corners detected
     from the nominal prior; `fit_rig_full_gum` (50 iterations) on the card:
     rms0 > 1 px and rms < 3.5 px, every term within CALIB_FIT_TOL of the
     port's CPU fit of the same corners; the fit rescaled to 768 px by
     `scale_rig`, written by `save_rig` and read back; c2 (60 frames, K=512,
     128x1024 panoramas, window BA) rendered with the truth and replayed by
     `python -m sosvo_torch.cli --mode ba --sequence` with `--rig` the
     ground-truth file, the fitted one and none (the nominal prior; three
     processes at once): every frame tracked, each ATE under the JAX
     package's worst plus twice the spread on the same rig
     (scripts/ref_calib_fit.py: there the fitted rig tracks 8x worse than
     the exact one at c2, and no better than the nominal prior, so
     tests/test_calib_to_vo.py's 6-frame bound, max(3 x exact, 0.02 m), is
     printed and not held); the command line's replay path on the fitted rig in this
     process, launches counted (70 Schur, 135 + relocalisations matcher),
     bit for bit the command line's trajectory; `export_html_viewer` and
     `save_ply` of its map; `--viz` refused up front without matplotlib;
     `phase_breakdown` at K=512 (each stage's ms on the card);
 12. c5 as written (configs/c5_multihost.json: 100 frames, K=1024, H=512,
     W=8, L=4096, 32768 scene landmarks) over 8 ranks on the one card
     (`sosvo_torch/dist/launch.py`, gloo: NCCL takes one rank per card),
     every window solve landmark-sharded (each rank's Schur kernel on its
     W8/L512 shard, the partials all-reduced): every rank's outputs
     bit-equal; against the port's one-device replay of the same inputs
     and draws, discrete outputs equal and poses within 1e-3; pose_ok after
     frame 0; ATE under the JAX package's worst seed plus twice the spread
     (scripts/ref_c5_ate.py); Schur launches per rank = windows x 5; each
     rank's shard kernel against its plain version and the 8 shards'
     all-reduced S_off and b_sub against one W8/L4096 launch within
     SCHUR_TOL; one more window solve's collectives counted and checked
     (1 + 3 x 5 all-reduces and one all-gather; under gloo each is one host
     sync) and its syncs counted; then
     the matcher at 1024x1024 and the Schur kernel on a W8/L512 shard
     against their plain versions, timed in this process;
 12b. sosvo_torch/dist/dryrun.py's step, in phase 12's ranks after their
     replay: one data-parallel VO step, the model-sharded BA, the
     time-sharded PGO on 16 nodes and the c5-scale BA (W8/L4096) on a 2
     data x 4 model layout, each against one rank, and its line printed;
 13. configs/c3_long_mesh.json in observation mode: the frame-to-frame
     replay of 1024 frames (128 stride keyframes) on one device, then its
     loop leg (256 candidates) on one device and over the 8 ranks (pairs
     split, nodes along time): the same loop count, above 0; poses within
     5e-3; ATE after the leg below the replay's; the sharded leg's ATE at
     most 1.05 x the one-device leg's + 1e-4; the leg's collectives (each
     one host sync under gloo) and syncs counted. Then the preset as
     written (`--mode ba`): the window-BA replay and its leg on one device,
     ATE after the leg under the JAX package's worst seed plus twice the
     spread (scripts/ref_c3_long_ate.py). The sharded leg takes the
     frame-to-frame replay because on the BA replay the JAX package's own
     leg raises ATE on two of three seeds: there is next to no drift to
     remove;
 11. the command line (`python -m sosvo_torch.cli`), one process per run:
     c4 in both modes (report mode, 4 lanes, every lane's ATE under phase
     10's limit), c2 and c3 as written (image mode, window BA, c3 with its
     loop leg: every frame tracked, a loop closed), and c1 frame to frame
     with --ckpt-every 4, with and without --pgo: a --fault-inject 5 run
     exits 42 and its --resume writes the uninterrupted run's frames.jsonl
     byte for byte, with the same pgo_loops and ATE; c3_adaptive as written
     (every frame tracked, a loop, both ATEs under phase 17's limits) and
     killed after frame 128 (--ckpt-every 32 --fault-inject 96) and
     resumed: frames.jsonl byte for byte, the same pgo_loops and ATE, and
     the keyframe flags it read back and handed PGO (kf_*.npy) the
     uninterrupted run's; then under `torchrun
     --nproc-per-node 8`, one process group per preset: c5 with
     --verify-sharded (the report's model axis 8 and its pose difference
     under 1e-3) and c3_long_sharded as written (1024 rendered frames,
     K=1024: rank 0 replays, the leg runs over the ranks, a loop closed).
Each replay and each loop-closure leg resets the launch counts just before
it and reads them just after (in each rank, for the ranks' paths); the
kernels line's `launches` are those of phase 7c (c3 image-native: its BA
replay plus its loop leg), phase 17 (c3_adaptive: its replay and its leg),
phase 10 (c4 in both modes), phase 12, phase 13's sharded leg (summed over
the ranks), phase 14's replays and leg and phase 15's staged replay and
live runs and phase 16's fitted-rig replay, `launches_by_path` every
path's. Each phase's wall time is printed. To keep the whole run inside
its time limit, the replays at c3's and c4's sizes (phases 4, 6, 7c, 10
and 14e) are checked once and not timed again.
`python3 chip_smoke.py --dist-only` runs the build and phases 12 (with
12b), 13 and 11's torchrun runs alone, `--descriptors-only` the build and
phase 14 alone, `--sequence-only` the build and phase 15 alone,
`--calib-only` the build and phase 16 alone, `--adaptive-only` the build
and phase 17 alone (on a render of its own); none prints a result line.
After phase 10, before phase 14, it counts each kernel's device events per
call (profiler; 1 each: one launch, no fills or copies): every profiler
session runs before the phases that start processes of their own on the
card (15's and 16's command lines, 12, 13, 11).
Every child process starts in a session of its own and is waited for; on a
timeout or an error its whole process group is killed (`run_children`).
Before its result it looks in /proc for any process below its own; if one
is left, it kills it and fails with no result line.
The phases run in the order 1-7c, 17, 8-10, 14, 15, 16, 12, 13, 11. At the
end it prints
the card's name and power limit, one JSON line describing
each kernel (with its route: the matcher's b1 tensor-core product, the
Schur kernel's cluster size), and as the last line
{"ok": true, "device": {...}}.
Exits non-zero, printing no result, without a CUDA device or outside the
repository.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
SCHUR_TOL = {"S_off": 1e-5, "b_sub": 1e-5, "H_ll_inv": 1e-4}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


class ChildResult(NamedTuple):
    returncode: int
    stdout: str
    stderr: str


def _kill_group(proc) -> None:
    """SIGKILL the process group a child leads (it and whatever it started,
    a torchrun's ranks too), then reap the child."""
    import os
    import signal

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    proc.wait()


def run_children(cmds: dict, timeout: float) -> dict:
    """Run each command of `cmds` ({name: argv}) as a child in a session of
    its own, all at once, from the repository root with output captured;
    wait for all of them within `timeout` seconds. Whatever happens (a
    timeout, an error while waiting), every child's process group is killed
    and reaped before this returns or raises: nothing they started outlives
    them. Returns {name: ChildResult}."""
    import subprocess

    procs, out = {}, {}
    deadline = time.monotonic() + timeout
    try:
        for name, cmd in cmds.items():
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True, cwd=ROOT, start_new_session=True)
        for name, proc in procs.items():
            o, e = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            out[name] = ChildResult(proc.returncode, o, e)
    finally:
        for proc in procs.values():
            _kill_group(proc)
    return out


def descendants() -> list[int]:
    """Pids of every live process below this one (children, theirs, ...),
    from /proc; zombies (exited, not yet reaped) are not counted."""
    import os

    parent, state = {}, {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            stat = Path(f"/proc/{d}/stat").read_text()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()  # after "pid (comm) "
        state[int(d)], parent[int(d)] = fields[0], int(fields[1])
    found, frontier = [], [os.getpid()]
    while frontier:
        kids = [c for c, pp in parent.items() if pp in frontier]
        found += kids
        frontier = kids
    return [c for c in found if state.get(c) != "Z"]


def kill_descendants() -> list[int]:
    """SIGKILL every live descendant (see `descendants`); returns their pids."""
    import os
    import signal

    left = descendants()
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return left


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
    """Median host seconds of `reps` replays; nan for none (not timed)."""
    import torch

    if reps == 0:
        return float("nan")
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
    timed replays. Returns (the matcher's launches, rig, scene, obs, the
    checked replay's outputs)."""
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
    return launches, rig, scene, obs, outs


def ba_replay_phase(label: str, cfg, n_frames: int, n_landmarks: int, max_ate: float,
                    device, timed_reps: int, vs_f2f: bool):
    """One checked keyframed-BA replay, then timed replays. Returns
    (matcher launches, Schur launches, rig, scene, obs, final state, the
    checked replay's outputs)."""
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
    want_m = 0 if _l2(cfg) else 2 * n_frames + n_kf + n_reloc  # L2 (SIFT): no kernel
    check(m_launches == want_m, f"{label}: {m_launches} matcher launches, expected {want_m}")
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
    return m_launches, s_launches, rig, scene, obs, final, outs


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
    want_m = 0 if _l2(cfg) else 2 * n_frames + n_kf + n_reloc  # L2 (SIFT): no kernel
    check(m_launches == want_m, f"{label}: {m_launches} matcher launches, expected {want_m}")
    print(f"replay {label}: K={cfg.frontend.max_features} H={cfg.ransac.n_hyps} W={cfg.ba.window} "
          f"L={cfg.ba.max_landmarks} frames={n_frames} dead_descriptors=frames "
          f"{drop.start}-{drop.stop - 1} relocalisations={n_reloc} on frames "
          f"{torch.nonzero(tried).flatten().tolist()} pose_ok={ok.int().tolist()} "
          f"ATE_after_dropout_m={rmse} keyframes={n_kf} schur_launches={s_launches} "
          f"matcher_launches={m_launches}", flush=True)
    return m_launches, s_launches


# The JAX package's ATE (m) after c3's loop-closure leg at c3's sizes on the
# CPU (scripts/ref_c3_pgo_ate.py, seeds 0-2; PERF.md section 5): the highest
# of its three seeds for each replay (BA 0.007946-0.010886 m, frame to frame
# 0.008817-0.011375 m). The port's leg replays a scene of its own, drawn on
# the card, so it may exceed that figure by C3_PGO_MARGIN_M: twice the
# largest spread between the reference's seeds (2.94 mm, BA).
C3_PGO_REF_ATE_M = {"ba": 0.010886459, "f2f": 0.011374913}
C3_PGO_MARGIN_M = 0.006


def pgo_phase(label: str, cfg, rig, gt_poses, obs, T_world, kf_idx, ref_ate: float,
              margin: float, device, must_drop: bool, gumbels=None):
    """c3's loop-closure leg over one replayed trajectory, as sosvo/cli.py
    runs it after a c3 replay (`tools/workload.py:pgo_leg`). Checks the
    launch counts (one matcher launch per keyframe's stereo match and per
    candidate pair, none with SIFT's L2 matcher; four Schur launches per
    pair's two-frame BA), finite
    poses, at least one loop, a solve that lowered the cost with at least
    one step accepted, the ATE against the JAX reference's `ref_ate` plus
    `margin`, and, with `must_drop`, below the ATE before. `gumbels`: the
    pairs' RANSAC draws (None: the port's generator seeded 17).
    Returns (the leg, matcher launches, Schur launches, ATE after)."""
    import torch
    from sosvo_torch.eval.ate import ate_rmse
    from sosvo_torch.kernels import match_cuda, schur_cuda
    from sosvo_torch.tools.workload import pgo_leg
    from sosvo_torch.vo.loop_closure import loop_pairs

    n_kf = len(kf_idx)
    n_pairs = cfg.loop_candidates or len(loop_pairs(n_kf, 3)[0])
    want_m = 0 if _l2(cfg) else n_kf + n_pairs  # SIFT's L2 matches launch no kernel
    torch.cuda.synchronize()
    match_cuda.reset_launches()
    schur_cuda.reset_launches()
    t0 = time.perf_counter()
    leg = pgo_leg(cfg, rig, obs, T_world, kf_idx, gumbels)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    m_launches, s_launches = match_cuda.launches, schur_cuda.launches
    gt = gt_poses[1:, :3, 3]
    before = float(ate_rmse(T_world[1:, :3, 3], gt)[0])
    after = float(ate_rmse(leg.T_corrected[1:, :3, 3], gt)[0])
    n_loops = int(leg.n_loops)
    limit = ref_ate + margin
    check(m_launches == want_m, f"{label}: {m_launches} matcher launches, expected {want_m}")
    check(s_launches == 4 * n_pairs, f"{label}: {s_launches} Schur launches, expected 4 x {n_pairs}")
    check(bool(torch.isfinite(leg.T_corrected).all()), f"{label}: non-finite pose")
    check(n_loops >= 1, f"{label}: no loop closed")
    res = leg.result
    check(float(res.cost) < float(res.cost0) and bool(res.accepted.any()),
          f"{label}: the pose-graph solve lowered no cost ({float(res.cost0)} -> {float(res.cost)}, "
          f"accepted {res.accepted.int().tolist()})")
    check(after <= limit, f"{label}: ATE after PGO {after} m above the JAX reference "
                          f"{ref_ate} m + {margin} m")
    if must_drop:
        check(after < before, f"{label}: ATE after PGO {after} m not below {before} m")
    print(f"pgo {label}: keyframes={n_kf} candidates={n_pairs} min_inliers={cfg.loop_min_inliers} "
          f"robust={cfg.pgo_robust} delta={cfg.pgo_robust_delta} n_loops={n_loops} "
          f"ATE_before_m={before} ATE_after_m={after} (limit {limit}: JAX CPU reference "
          f"{ref_ate} + {margin}) cost0={float(leg.result.cost0)} "
          f"cost={float(leg.result.cost)} accepted={leg.result.accepted.int().tolist()} "
          f"leg_s={seconds} (host clock) matcher_launches={m_launches} "
          f"schur_launches={s_launches}", flush=True)
    return leg, m_launches, s_launches, after


def leg_repeats(label: str, cfg, rig, obs, T_world, kf_idx, leg) -> None:
    """The same leg run again gives the same bits: the pose-graph assembly
    sums in a fixed order and every kernel repeats bit for bit."""
    import torch
    from sosvo_torch.tools.workload import pgo_leg

    again = pgo_leg(cfg, rig, obs, T_world, kf_idx)
    same = all(torch.equal(a, b) for a, b in ((again.T_corrected, leg.T_corrected),
                                              (again.result.X, leg.result.X),
                                              (again.result.cost, leg.result.cost),
                                              (again.n_loops, leg.n_loops)))
    check(same, f"{label}: a second leg over the same trajectory differs")
    print(f"pgo {label}: a second leg over the same trajectory is bit-identical "
          f"(T_corrected, X, cost, n_loops)", flush=True)


def build_system_repeats(label: str, g) -> None:
    """Two builds of the normal equations of one pose graph are bit-identical."""
    import torch
    from sosvo_torch.backend.pose_graph import build_system

    first, second = build_system(g), build_system(g)
    torch.cuda.synchronize()
    for name, a, b in zip(("H", "b", "cost"), first, second):
        check(torch.equal(a, b), f"{label}: two build_system calls differ in {name} "
                                 f"by {float((a - b).abs().max())}")
    print(f"build_system {label}: nodes={g.X.shape[0]} edges={g.w.shape[0]} two calls "
          f"bit-identical in H, b and cost", flush=True)


def loop_shape_kernels(cfg, rig, obs, kf_idx, leg, device):
    """Both kernels at the loop leg's shapes on its first accepted loop pair:
    the matcher on the two keyframes' features (K x K, no band), and the
    Schur kernel on the pair's two-frame window (W=2, L=K; its RANSAC from
    a draw of its own) in the first LM iteration. Returns the two
    comparisons' results."""
    import torch
    from sosvo_torch.backend.ba import build_blocks
    from sosvo_torch.geometry.ransac import gumbel
    from sosvo_torch.synth.scene import FrameObservations
    from sosvo_torch.vo.loop_closure import LOOP_SEED, _kf_features, pair_window
    from sosvo_torch.vo.state import KeyframeFeatures

    g, n_odom = leg.graph, len(kf_idx) - 1
    first = n_odom + int(torch.nonzero(g.w[n_odom:] > 0)[0])
    i, j = int(g.ej[first]), int(g.ei[first])   # a loop edge (j, i) measures X_j X_i^-1
    frames = torch.tensor([int(kf_idx[i]), int(kf_idx[j])], device=device)
    feats = _kf_features(rig, cfg, FrameObservations(*(x[frames] for x in obs)))
    a, b = (KeyframeFeatures(*(x[n] for x in feats)) for n in (0, 1))
    k = a.desc.shape[0]
    m = compare_kernel(f"c3_loop_pair_kf{i}_kf{j}_{k}x{k}",
                       (a.desc, b.desc, a.valid, b.valid, None, None), 0.0, cfg)
    gen = torch.Generator(device=device).manual_seed(LOOP_SEED)
    _, win = pair_window(rig, cfg, a, b, gumbel(gen, (cfg.ransac.n_hyps, k), device),
                         cfg.loop_min_inliers)
    s = compare_schur(f"c3_loop_window_kf{i}_kf{j}_W2_L{k}", build_blocks(win)[:5], 1e-3)
    return m, s


def pgo_solvers(cfg, leg) -> None:
    """The f32 solves the leg runs, on its pose graph: the cg solver (64
    iterations) within 1e-3 of the dense one (tests/test_pose_graph.py:165's
    tolerance), and the dense one within 1e-4 of the same solve in float64,
    its cost within 1e-4 relative (the f32 solve stops where a step's gain
    is below its cost's rounding: 0.8-1.7e-6 relative on the card). Also prints cg against dense in float64;
    two builds of the normal equations and two dense solves must be
    bit-identical, and so must the leg's own solve and a re-solve."""
    import torch
    from sosvo_torch.backend.pose_graph import build_system, pgo_solve

    kw = dict(iters=10, robust=cfg.pgo_robust, robust_delta=cfg.pgo_robust_delta)
    g = leg.graph
    g64 = g._replace(X=g.X.double(), T_meas=g.T_meas.double(), w=g.w.double())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = pgo_solve(g, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cg = pgo_solve(g, solver="cg", cg_iters=64, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dense64 = pgo_solve(g64, **kw)
    cg64 = pgo_solve(g64, solver="cg", cg_iters=64, **kw)
    err32 = float((cg.X - dense.X).abs().max())
    err64 = float((cg64.X - dense64.X).abs().max())
    off = {name: float((x.X.double() - dense64.X).abs().max()) for name, x in
           (("dense", dense), ("cg", cg))}
    cost_rel = abs(float(dense.cost) - float(dense64.cost)) / float(dense64.cost)
    H1, b1, _ = build_system(g)
    H2, b2, _ = build_system(g)
    again = pgo_solve(g, **kw)
    print(f"pgo_solvers: nodes={g.X.shape[0]} edges={g.w.shape[0]} cg_iters=64 "
          f"float32: max_abs_err_cg_vs_dense={err32} dense_vs_float64={off['dense']} "
          f"cg_vs_float64={off['cg']} cost dense={float(dense.cost)} float64={float(dense64.cost)} "
          f"(relative {cost_rel}) accepted dense={dense.accepted.int().tolist()} "
          f"cg={cg.accepted.int().tolist()} float64={dense64.accepted.int().tolist()} "
          f"float64: max_abs_err_cg_vs_dense={err64} dense_s={t1 - t0} cg_s={t2 - t1} (host clock) "
          f"build_system_repeats_max_abs_diff H={float((H1 - H2).abs().max())} "
          f"b={float((b1 - b2).abs().max())} "
          f"dense_solve_repeats_max_abs_diff={float((again.X - dense.X).abs().max())} "
          f"leg_solve_vs_dense_solve={float((leg.result.X - dense.X).abs().max())}", flush=True)
    check(bool(torch.isfinite(cg.X).all()) and bool(torch.isfinite(dense.X).all()),
          "pgo: non-finite pose")
    check(err32 < 1e-3, f"pgo cg vs dense in f32: X differs by {err32} >= 1e-3")
    check(torch.equal(H1, H2) and torch.equal(b1, b2), "pgo: two build_system calls differ")
    check(torch.equal(again.X, dense.X) and torch.equal(leg.result.X, dense.X),
          "pgo: two dense solves of the leg's graph differ")
    check(off["dense"] < 1e-4, f"pgo dense f32 vs float64: X differs by {off['dense']} >= 1e-4")
    check(cost_rel < 1e-4, f"pgo dense f32 vs float64: cost differs by {cost_rel} relative")


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


# The JAX package's ATE (m) for the image-mode presets as sosvo/cli.py runs
# them, on the CPU (scripts/ref_image_ate.py, seeds 0-2: the seed moves only
# the replay's RANSAC key, the rendered sequence is one; PERF.md section 5):
# c2's BA replay, c3's BA replay and c3 after its loop leg. The port's own
# draws are another seed, so its ATE may reach the worst seed plus twice the
# largest spread between seeds.
IMAGE_REF_ATE_M = {"c2_ba": (0.007460933178663254, 0.007471336517482996, 0.00739532383158803),
                   "c3_ba": (0.028098905459046364, 0.028617585077881813, 0.030325645580887794),
                   "c3_pgo": (0.01806194894015789, 0.01909755729138851, 0.01914658211171627),
                   # the same presets with frontend.descriptor replaced
                   # (scripts/ref_descriptor_ate.py): seeds 0-2, then seed 0
                   # on the sequence rendered with every pose shifted by
                   # +0.1, -0.1, +0.3 and -0.3 um along x. The ATE moves
                   # with the render's rounding at the checker edges far
                   # more than with the RANSAC seed, and the card's render
                   # rounds apart from the CPU's (PERF.md §6).
                   "c2_akaze_ba": (0.017416533082723618, 0.017600806429982185,
                                   0.018150372430682182, 0.014520280994474888,
                                   0.015394707210361958, 0.014667447656393051,
                                   0.019250430166721344),
                   "c2_sift_ba": (0.02233959175646305, 0.02232171967625618, 0.022374222055077553,
                                  0.0223611518740654, 0.02253340184688568, 0.02225263975560665,
                                  0.022539611905813217),
                   "c3_sift_ba": (0.021464167162775993, 0.021248359233140945,
                                  0.021415308117866516, 0.021393900737166405, 0.01979329250752926,
                                  0.019288048148155212, 0.02246752195060253),
                   "c3_sift_pgo": (0.01146115642040968, 0.011048964224755764, 0.01115184836089611,
                                   0.010822121985256672, 0.010546239092946053,
                                   0.011040992103517056, 0.010637504048645496),
                   # configs/c3_adaptive.json (scripts/ref_c3_adaptive_ate.py):
                   # the same seeds and shifted renders; its window-BA replay
                   # and after its loop leg over the scan's adaptive keyframes
                   "c3_adaptive_ba": (0.01612289622426033, 0.01279922854155302,
                                     0.013568253256380558, 0.013017147779464722,
                                     0.014509744942188263, 0.017512885853648186,
                                     0.016565706580877304),
                   "c3_adaptive_pgo": (0.014563639648258686, 0.01141697634011507,
                                      0.01774890162050724, 0.018167944625020027,
                                      0.012845265679061413, 0.01141277328133583,
                                      0.015943169593811035)}
C3_SIFT_REF_LOOPS = (9, 11)  # n_loops of c3's SIFT leg over those rows (the same script)


def _l2(cfg) -> bool:
    """Whether `cfg`'s descriptors match by L2 (SIFT): plain torch, no kernel."""
    from sosvo_torch.frontend.match import metric_params

    return metric_params(cfg.frontend)[0] == "l2"


def with_descriptor(cfg, descriptor: str):
    """`cfg` with `frontend.descriptor` replaced."""
    import dataclasses

    return dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                 descriptor=descriptor))


def image_ate_limit(name: str) -> tuple[float, float]:
    """(worst seed, margin) of one reference figure."""
    ref = IMAGE_REF_ATE_M[name]
    return max(ref), 2.0 * (max(ref) - min(ref))


def _luts_on(luts, device):
    """A copy of the frontend's LUTs on another device (the same values)."""
    from sosvo_torch.frontend.image_frontend import FrontendLUTs

    return FrontendLUTs(*(g._replace(**{f: getattr(g, f).to(device)
                                        for f in ("lut_uv", "valid", "u0", "v0", "fu", "fv")})
                          for g in luts))


def frontend_phase(cfg, n_frames: int, device, results) -> None:
    """7a: the image frontend on the card against the port on the CPU.

    Frames 0 and 30 of the preset's rendered sequence (rendered on the card)
    are extracted on the card and, from the same images and the same LUT
    values, on the CPU: validity, keypoint slots and descriptors must be
    equal, except slots whose response lies within 1e-6 of the map's largest
    magnitude of a neighbouring slot's or of the K-th value (counted; none
    expected), `uv` within 1e-3 px and rays within 1e-6 (sin/cos differ
    between the two devices). The LUTs built on each device are compared
    (within 1e-3 px), and the CPU's extraction on its own LUTs is compared
    the same way and printed, not held: the LUTs differ by f32 steps of
    sin/cos, which move the panorama and so the responses by more than the
    near-tie rule's rounding. Then the matcher kernel against its plain version
    on the image-extracted descriptors: stereo in the band, and temporal
    between the two frames."""
    import torch
    from sosvo_torch.frontend.detect import gaussian_smooth, harris_response
    from sosvo_torch.frontend.image_frontend import build_frontend_luts, extract_observations
    from sosvo_torch.frontend.panorama import warp_panorama
    from sosvo_torch.sensor.rig import default_rig
    from sosvo_torch.tools.frontend_parity import slot_mismatches, view_keypoints
    from sosvo_torch.tools.workload import render_frames
    from sosvo_torch.vo.pipeline import azimuth_of, stereo_triangulate

    fe, cpu = cfg.frontend, torch.device("cpu")
    rig, rig_cpu = default_rig(device=device), default_rig(device=cpu)
    luts = build_frontend_luts(rig, fe)
    luts_cpu_own = build_frontend_luts(rig_cpu, fe)
    luts_cpu = _luts_on(luts, cpu)
    for view in ("top", "bottom"):
        a, b = getattr(luts_cpu, view), getattr(luts_cpu_own, view)
        uv_err = float((a.lut_uv - b.lut_uv).abs().max())
        n_valid = int((a.valid != b.valid).sum())
        print(f"frontend LUT {view}: card vs CPU lut_uv max_abs_err={uv_err:.3e} px "
              f"valid_differs={n_valid}/{a.valid.numel()}", flush=True)
        check(uv_err < 1e-3, f"frontend LUT {view}: card and CPU differ by {uv_err} px")
    frames = (0, 30)
    images = render_frames(rig, n_frames, frames, device)
    torch.cuda.synchronize()
    extracted = []
    for f, img in zip(frames, images):
        got = extract_observations(rig, luts, fe, img)
        ref = extract_observations(rig_cpu, luts_cpu, fe, img.cpu())
        own = extract_observations(rig_cpu, luts_cpu_own, fe, img.cpu())
        kps_got = view_keypoints(luts, fe, img)
        kps_ref = view_keypoints(luts_cpu, fe, img.cpu())
        kps_own = view_keypoints(luts_cpu_own, fe, img.cpu())
        for i, view in enumerate(("top", "bottom")):
            geom = getattr(luts_cpu, view)
            scale = float(harris_response(gaussian_smooth(warp_panorama(img.cpu(), geom))).abs().max())
            kr = kps_ref[i]
            counts = {}
            for name, kg, obs in (("card", kps_got[i], got), ("cpu_own_luts", kps_own[i], own)):
                differ, unexplained = slot_mismatches(kr.rows, kr.cols, kr.response,
                                                      kg.rows.cpu(), kg.cols.cpu(), fe.pano_width,
                                                      1e-6 * scale)
                same = torch.as_tensor(~differ)
                valid_ok = torch.equal(getattr(obs, f"valid_{view}").cpu()[same],
                                       getattr(ref, f"valid_{view}")[same])
                bits = (getattr(obs, f"desc_{view}").cpu()[same]
                        ^ getattr(ref, f"desc_{view}")[same])
                n_bits = int(sum(int((bits >> k & 1).sum()) for k in range(32)))
                uv_err = float((getattr(obs, f"uv_{view}").cpu()[same]
                                - getattr(ref, f"uv_{view}")[same]).abs().max())
                ray_err = float((getattr(obs, f"ray_{view}").cpu()[same]
                                 - getattr(ref, f"ray_{view}")[same]).abs().max())
                counts[name] = (int(differ.sum()), int(unexplained.sum()), valid_ok, n_bits,
                                uv_err, ray_err)
                if name == "card":
                    check(not unexplained.any(),
                          f"frontend frame {f} {view}: {int(unexplained.sum())} keypoint slots "
                          f"differ between card and CPU with no near-tie")
                    check(valid_ok and n_bits == 0,
                          f"frontend frame {f} {view}: validity or descriptors of equal slots "
                          f"differ between card and CPU ({n_bits} bits)")
                    check(uv_err < 1e-3 and ray_err < 1e-6,
                          f"frontend frame {f} {view}: uv {uv_err} px or rays {ray_err} apart")
            n_valid = int(getattr(got, f"valid_{view}").sum())
            print(f"frontend frame {f} {view}: K={fe.max_features} valid={n_valid} " + " ".join(
                f"{name}: slots_differ={d} without_near_tie={u} valid_equal={v} "
                f"desc_bits_differ={nb} uv_max_abs_err={ue:.3e} ray_max_abs_err={re:.3e}"
                for name, (d, u, v, nb, ue, re) in counts.items()), flush=True)
        extracted.append(got)
    f0, f1 = extracted
    valid0 = stereo_triangulate(rig, f0, cfg)[4]
    valid1 = stereo_triangulate(rig, f1, cfg)[4]
    results["c2_images_stereo"] = compare_kernel(
        "c2_images_frame0_stereo", (f0.desc_top, f0.desc_bottom, f0.valid_top, f0.valid_bottom,
                                    azimuth_of(f0.ray_top), azimuth_of(f0.ray_bottom)),
        fe.stereo_band_rad, cfg)
    results["c2_images_temporal"] = compare_kernel(
        "c2_images_frame0_frame30_temporal", (f0.desc_top, f1.desc_top, valid0, valid1, None, None),
        0.0, cfg)


def image_ba_phase(label: str, cfg, n_frames: int, ref_name: str, max_ate: float | None,
                   device, timed_reps: int):
    """7b / 7c: an image-mode preset as written, with window BA, as
    sosvo/cli.py runs it: render on the card, then extract every frame and
    replay (`tools/workload.py:image_ba_replayer`) with the command line's
    own RANSAC draws (`tools/reference_draws.py`: PRNGKey(2), made on the
    card), so the ATE compares with the JAX package's seed 0 on the same
    sequence and random stream. Checks pose_ok on every frame, the stride
    keyframes, both kernels' launches (no matcher launch with SIFT, whose
    L2 matches are plain torch), and the ATE against the JAX package's
    worst seed plus twice the spread (and `max_ate` where given);
    prints the distance to seed 0. Prints frames/s of the replay including
    extraction and the frontend's ms per frame (host clock, synchronised).
    Returns (matcher launches, Schur launches, rig, poses, observations,
    outputs, the draws)."""
    import torch
    from sosvo_torch.eval.ate import ate_rmse
    from sosvo_torch.frontend.image_frontend import extract_sequence
    from sosvo_torch.kernels import match_cuda, schur_cuda
    from sosvo_torch.tools.reference_draws import replay_draws
    from sosvo_torch.tools.workload import image_ba_replayer, make_image_workload

    t0 = time.perf_counter()
    rig, poses, images, luts, obs = make_image_workload(cfg, n_frames, device)
    draws = replay_draws(n_frames, cfg.ransac.n_hyps, cfg.frontend.max_features, device,
                         reloc_slots=cfg.ba.max_landmarks)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    replay = image_ba_replayer(cfg, rig, poses, images, luts, device, draws)

    match_cuda.reset_launches()
    schur_cuda.reset_launches()
    _, outs = replay()
    torch.cuda.synchronize()
    m_launches, s_launches = match_cuda.launches, schur_cuda.launches
    rmse = float(ate_rmse(outs.vo.T_world[1:, :3, 3], poses[1:, :3, 3])[0])
    n_ok = int(outs.vo.pose_ok[1:].sum())
    n_kf = int(outs.is_keyframe.sum())
    n_reloc = int(outs.reloc_tried.sum())
    want_kf = (n_frames + cfg.keyframe_every - 1) // cfg.keyframe_every
    ref, margin = image_ate_limit(ref_name)
    check(bool(torch.isfinite(outs.vo.T_world).all()), f"{label}: non-finite pose")
    check(n_ok == n_frames - 1, f"{label}: pose_ok on {n_ok}/{n_frames - 1} frames")
    check(n_kf == want_kf, f"{label}: {n_kf} keyframes, expected {want_kf}")
    check(s_launches == (want_kf - 1) * cfg.ba.iters,
          f"{label}: {s_launches} Schur launches, expected {(want_kf - 1) * cfg.ba.iters}")
    want_m = 0 if _l2(cfg) else 2 * n_frames + n_kf + n_reloc  # L2 (SIFT): no kernel
    check(m_launches == want_m, f"{label}: {m_launches} matcher launches, expected {want_m}")
    check(rmse <= ref + margin, f"{label}: ATE {rmse} m above the JAX reference {ref} + {margin}")
    if max_ate is not None:
        check(rmse < max_ate, f"{label}: ATE {rmse} m >= {max_ate} m")

    extract_s = []
    for _ in range(2 if timed_reps else 0):  # the frontend alone, timed with the replays
        t0 = time.perf_counter()
        extract_sequence(rig, luts, cfg.frontend, images)
        torch.cuda.synchronize()
        extract_s.append(time.perf_counter() - t0)
    med = timed_replays(replay, timed_reps)
    fe = cfg.frontend
    print(f"replay {label}: descriptor={fe.descriptor} images "
          f"{rig.image_height}x{rig.image_width} pano "
          f"{fe.pano_height}x{fe.pano_width} K={fe.max_features} H={cfg.ransac.n_hyps} "
          f"W={cfg.ba.window} L={cfg.ba.max_landmarks} frames={n_frames} draws=JAX PRNGKey(2) "
          f"ATE_m={rmse} (JAX seed 0 {IMAGE_REF_ATE_M[ref_name][0]}: "
          f"{rmse - IMAGE_REF_ATE_M[ref_name][0]:+.3e}; limit {ref + margin}: JAX CPU reference "
          f"worst {ref} + {margin}"
          f"{'' if max_ate is None else f'; and < {max_ate}'}) pose_ok={n_ok}/{n_frames - 1} "
          f"keyframes={n_kf} relocalisations={n_reloc} "
          f"map_slots={int(outs.n_landmarks[-1])}/{cfg.ba.max_landmarks} "
          f"matcher_launches={m_launches} schur_launches={s_launches} "
          f"frontend_ms_per_frame={1e3 * min(extract_s, default=float('nan')) / n_frames} "
          f"replay_s_median={med} frames_per_s={n_frames / med} (host clock, extraction "
          f"included, {timed_reps} runs after one checked run) render_and_extract_setup_s={setup_s}",
          flush=True)
    return m_launches, s_launches, rig, poses, obs, outs, draws



# configs/c3_adaptive.json in the JAX package on the CPU
# (scripts/ref_c3_adaptive_ate.py): seed 0's keyframes, the command line's
# own run. The card's render rounds apart from the CPU's, and on some frame
# of every JAX row the trigger's motion sits within 1.4e-4 to 3.1e-4 (m or
# rad) of a threshold, so the card's set may part from it on a few frames:
# phase 17 counts them and holds none.
C3_ADAPTIVE_REF_KF = (
    0, 2, 4, 6, 9, 11, 13, 15, 17, 19, 21, 23, 25, 27, 29, 31, 33, 35, 37, 39, 41, 43, 45, 47,
    49, 51, 53, 55, 57, 59, 61, 63, 65, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94,
    96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 118, 120, 122, 124, 126, 129, 131,
    133, 135, 137, 139, 141, 143, 145, 147, 149, 151, 153, 155, 157, 159, 161, 163, 165, 167,
    169, 171, 173, 175, 177, 179, 181, 183, 186, 188, 190, 192, 194, 196, 198)


def adaptive_phase(device, workload=None) -> dict:
    """17: configs/c3_adaptive.json as written, in this process: image mode,
    K=2048, 200 frames, W5/L1024 window BA with motion-adaptive keyframes
    (0.04 m, 0.08 rad, gaps 2 to 8), then the loop leg over the scan's own
    keyframes, `nonzero(is_keyframe)`, as sosvo/cli.py runs it. `workload`:
    phase 7c's (rig, poses, observations, the command line's replay draws);
    c3_adaptive renders, extracts and draws as c3_host_pgo does (checked), so
    the phase pays only for its replay and its leg. None renders them here.

    The replay runs under PyTorch's sync debug mode. Checks pose_ok on every
    frame, (n_kf - 1) x 5 Schur and 2 x 200 + n_kf + relocalisations matcher
    launches, 2 host syncs per frame (the lazy gate, then pose_ok and the
    adaptive trigger in one read; one more at the start and per
    relocalisation), each keyframe flag equal to the trigger's rule on the
    motion the replay saw, and the ATE under the JAX rows' worst plus twice
    the spread. Prints the card's keyframes beside the JAX package's seed 0
    (the frames where they differ counted) and each threshold crossing's
    distance to its threshold. The leg (`pgo_phase`, with the reference's
    per-pair draws): one matcher launch per keyframe and per pair, 4 Schur
    launches per pair, a loop, the ATE after under the JAX limit; the
    PoseGraph handed to `pgo_solve` has the scan's keyframes as its nodes
    (their replayed poses, bit for bit), and the correction is constant
    within each governing segment. Returns {path: (matcher launches, Schur
    launches)}."""
    import numpy as np
    import torch
    from sosvo_torch.eval.ate import ate_rmse
    from sosvo_torch.geom.lie import mat_inv
    from sosvo_torch.kernels import match_cuda, schur_cuda
    from sosvo_torch.tools.reference_draws import loop_draws, replay_draws
    from sosvo_torch.tools.sync_check import syncs_during
    from sosvo_torch.tools.workload import SEED, load_image_preset, make_image_workload
    from sosvo_torch.vo import ba_pipeline, loop_closure

    label = "c3_adaptive"
    cfg, run = load_image_preset("c3_adaptive")
    c3, c3_run = load_image_preset("c3_host_pgo")
    n = run["n_frames"]
    check((cfg.frontend, cfg.ransac, cfg.ba, n) == (c3.frontend, c3.ransac, c3.ba, c3_run["n_frames"]),
          f"{label}: its frontend, RANSAC, BA widths or length differ from c3_host_pgo's")
    t0 = time.perf_counter()
    if workload is None:
        rig, poses, _, _, obs = make_image_workload(cfg, n, device, keep_images=False)
        draws = replay_draws(n, cfg.ransac.n_hyps, cfg.frontend.max_features, device,
                             reloc_slots=cfg.ba.max_landmarks)
    else:
        rig, poses, obs, draws = workload
    state = ba_pipeline.init_ba_state(cfg, torch.Generator(device=device).manual_seed(SEED + 2),
                                      T0=poses[0], device=device)
    motion, real_motion = {}, ba_pipeline._adaptive_motion

    def spy_motion(m, track, frame):
        motion[frame] = real_motion(m, track, frame)  # a relocalised frame's last call decides
        return motion[frame]

    ba_pipeline._adaptive_motion = spy_motion
    try:
        torch.cuda.synchronize()
        match_cuda.reset_launches()
        schur_cuda.reset_launches()
        t1 = time.perf_counter()
        (_, outs), flagged = syncs_during(lambda: ba_pipeline.run_replay_ba(rig, cfg, state, obs,
                                                                           draws))
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t1
        m_launches, s_launches = match_cuda.launches, schur_cuda.launches
    finally:
        ba_pipeline._adaptive_motion = real_motion
    gt = poses[1:, :3, 3]
    rmse = float(ate_rmse(outs.vo.T_world[1:, :3, 3], gt)[0])
    n_ok = int(outs.vo.pose_ok[1:].sum())
    flags = outs.is_keyframe.cpu().numpy()
    kf = np.nonzero(flags)[0]
    n_kf, n_reloc = len(kf), int(outs.reloc_tried.sum())
    syncs = len(flagged)
    where = collections.Counter(f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in flagged)
    at_gate = sum(w.filename.endswith(os.path.join("vo", "pipeline.py")) for w in flagged)
    at_read = sum(w.filename.endswith("ba_pipeline.py") for w in flagged)
    ref, margin = image_ate_limit("c3_adaptive_ba")
    check(bool(torch.isfinite(outs.vo.T_world).all()), f"{label}: non-finite pose")
    check(n_ok == n - 1, f"{label}: pose_ok on {n_ok}/{n - 1} frames")
    check(s_launches == (n_kf - 1) * cfg.ba.iters,
          f"{label}: {s_launches} Schur launches, expected ({n_kf} - 1) x {cfg.ba.iters}")
    check(m_launches == 2 * n + n_kf + n_reloc,
          f"{label}: {m_launches} matcher launches, expected 2 x {n} + {n_kf} + {n_reloc}")
    check(rmse <= ref + margin, f"{label}: ATE {rmse} m above the JAX reference {ref} + {margin}")
    # the gate on every frame (vo/pipeline.py); one read at the start and
    # pose_ok with the trigger from frame 1 on (vo/ba_pipeline.py), and a
    # relocalised frame reads the trigger again. A first call in the process
    # may add a sync of its own elsewhere (printed, not held).
    check(at_gate == n and at_read == n + n_reloc,
          f"{label}: {at_gate} syncs at the gate and {at_read} in vo/ba_pipeline.py in {n} "
          f"frames, expected {n} and {n} + {n_reloc} relocalisations; all: {dict(where)}")

    frames = sorted(motion)
    trans, rot = (torch.stack([motion[f][i] for f in frames]).cpu().numpy() for i in (0, 1))
    gap = torch.stack([motion[f][2] for f in frames]).cpu().numpy()
    over = np.maximum(trans - cfg.kf_trans_thresh, rot - cfg.kf_rot_thresh)
    decided = (gap >= cfg.kf_min_gap) & (gap < cfg.kf_max_gap)
    rule = (gap >= cfg.kf_min_gap) & ((over > 0) | (gap >= cfg.kf_max_gap))
    check(np.array_equal(rule, flags[frames]),
          f"{label}: keyframe flags differ from the trigger's rule on frames "
          f"{[f for f, a, b in zip(frames, rule, flags[frames]) if a != b]}")
    crossings = [(f, float(d)) for f, d, k, dec in zip(frames, over, flags[frames], decided)
                 if k and dec]
    below = [(f, float(-d)) for f, d, k, dec in zip(frames, over, flags[frames], decided)
             if not k and dec]
    jax_flags = np.zeros(n, bool)
    jax_flags[list(C3_ADAPTIVE_REF_KF)] = True
    differ = np.nonzero(flags != jax_flags)[0].tolist()
    stride = np.arange(0, n, c3.keyframe_every)
    print(f"replay {label}: images {rig.image_height}x{rig.image_width} pano "
          f"{cfg.frontend.pano_height}x{cfg.frontend.pano_width} K={cfg.frontend.max_features} "
          f"H={cfg.ransac.n_hyps} W={cfg.ba.window} L={cfg.ba.max_landmarks} frames={n} "
          f"keyframe_mode=adaptive trans>{cfg.kf_trans_thresh} rot>{cfg.kf_rot_thresh} "
          f"gap {cfg.kf_min_gap}-{cfg.kf_max_gap} draws=JAX PRNGKey(2) ATE_m={rmse} "
          f"(JAX seed 0 {IMAGE_REF_ATE_M['c3_adaptive_ba'][0]}: "
          f"{rmse - IMAGE_REF_ATE_M['c3_adaptive_ba'][0]:+.3e}; limit {ref + margin}: JAX CPU "
          f"reference worst {ref} + {margin}) pose_ok={n_ok}/{n - 1} keyframes={n_kf} "
          f"(stride {c3.keyframe_every} would give {len(stride)}; the same set: "
          f"{np.array_equal(kf, stride)}) relocalisations={n_reloc} "
          f"matcher_launches={m_launches} schur_launches={s_launches} syncs={syncs} "
          f"syncs_per_frame={syncs / n} (at the gate {at_gate}, in vo/ba_pipeline.py {at_read}, "
          f"elsewhere {syncs - at_gate - at_read}; by line {dict(where)}) "
          f"replay_s={replay_s} (host clock, under the sync debug mode) "
          f"workload_from_7c={workload is not None}", flush=True)
    print(f"keyframes {label}: card {kf.tolist()}", flush=True)
    print(f"keyframes {label}: JAX seed 0 {list(C3_ADAPTIVE_REF_KF)} ({len(C3_ADAPTIVE_REF_KF)}); "
          f"frames where the card's flags differ: {len(differ)} {differ}", flush=True)
    print(f"keyframes {label}: threshold crossings, the larger overshoot of translation (m) and "
          f"rotation (rad) per motion-decided keyframe: {[(f, f'{d:.3e}') for f, d in crossings]}; "
          f"closest crossing {min(crossings, key=lambda x: x[1], default=None)}; closest frame "
          f"that stayed below {min(below, key=lambda x: x[1], default=None)}; keyframes at the max "
          f"gap {int(((gap >= cfg.kf_max_gap) & flags[frames]).sum())}", flush=True)

    captured, real_solve = {}, loop_closure.pgo_solve

    def spy_solve(g, **kw):
        captured["g"] = g
        return real_solve(g, **kw)

    loop_closure.pgo_solve = spy_solve
    try:
        leg, leg_m, leg_s, after = pgo_phase(
            "c3_adaptive_pgo_leg", cfg, rig, poses, obs, outs.vo.T_world, kf,
            *image_ate_limit("c3_adaptive_pgo"), device, must_drop=False,
            gumbels=loop_draws(cfg.loop_candidates, cfg.ransac.n_hyps, cfg.frontend.max_features,
                               device))
    finally:
        loop_closure.pgo_solve = real_solve
    g = captured["g"]
    kf_t = torch.as_tensor(kf, device=device)
    check(g.X.shape[0] == n_kf and torch.equal(g.X, mat_inv(outs.vo.T_world[kf_t])),
          f"{label}: the pose graph's {g.X.shape[0]} nodes are not the scan's {n_kf} keyframes")
    gov = torch.as_tensor(loop_closure.governing_map(n, kf), device=device).long()
    corr = leg.T_corrected @ mat_inv(outs.vo.T_world)
    seg_err = float((corr - corr[kf_t][gov]).abs().max())
    check(seg_err < 1e-5, f"{label}: the leg's correction varies by {seg_err} within a segment")
    print(f"pgo c3_adaptive_pgo_leg: nodes={g.X.shape[0]} = the scan's keyframes (poses bit-equal) "
          f"correction_within_segment_max_abs_diff={seg_err} ATE before {rmse} after {after} "
          f"(JAX seed 0 {IMAGE_REF_ATE_M['c3_adaptive_ba'][0]} -> "
          f"{IMAGE_REF_ATE_M['c3_adaptive_pgo'][0]}: after {after - IMAGE_REF_ATE_M['c3_adaptive_pgo'][0]:+.3e}) "
          f"phase_s={time.perf_counter() - t0} (host clock)", flush=True)
    return {"c3_adaptive_ba": (m_launches, s_launches), "c3_adaptive_pgo_leg": (leg_m, leg_s)}


# The JAX package's per-lane ATE (m) of configs/c4_batched_replay.json on the
# CPU (scripts/ref_c4_ate.py, seeds 0-2, 4 lanes each; PERF.md section 2):
# the worst lane of the three seeds plus twice the spread of those twelve
# lane ATEs (frame to frame 0.053-0.062 m, window BA 0.0052-0.0074 m). The
# port's lanes are scenes of its own, drawn on the card.
C4_REF_ATE_LIMIT_M = {"f2f": 0.0808916911482811, "ba": 0.011841376312077045}
C4_POSE_BOUND = {"f2f": 1e-5, "ba": 1e-4}  # tests/test_batched_replay.py:43, :100


def batched_phase(mode: str, cfg, run, device, timed_reps: int, card: str = ""):
    """10: c4 as written (configs/c4_batched_replay.json: S=4 lanes, 100
    frames, K=512, H=512, 8192 landmarks; W=5, L=512, a keyframe every 4
    frames in BA mode), the lanes in lockstep (`tools/workload.py:
    batched_replayer`). Checks pose_ok on every lane after frame 0, each
    lane's ATE against the JAX package's limit, the launch counts and the
    batch's syncs per frame (1 at the batch gate, and in BA mode 1 more at
    the relocalisation predicate, plus 1 at the start), then each lane
    against its sequential replay from the same generator: discrete outputs
    equal, poses within C4_POSE_BOUND. Returns (matcher launches, Schur
    launches, rig, observations, final state)."""
    import torch
    from sosvo_torch.eval.ate import ate_rmse
    from sosvo_torch.kernels import match_cuda, schur_cuda
    from sosvo_torch.tools.sync_check import syncs_during
    from sosvo_torch.tools.workload import SEED, batched_replayer, make_batched_workload
    from sosvo_torch.vo.ba_pipeline import init_ba_state, run_replay_ba
    from sosvo_torch.vo.batched import lane_generators
    from sosvo_torch.vo.pipeline import run_replay
    from sosvo_torch.vo.state import init_track_state, lane

    label = f"c4_batched_{mode}"
    S, F = run["n_sequences"], run["n_frames"]
    rig, gt, obs = make_batched_workload(cfg, S, F, run["n_landmarks"], device)
    replay = batched_replayer(cfg, rig, gt, obs, device, mode)
    torch.cuda.synchronize()

    match_cuda.reset_launches()
    schur_cuda.reset_launches()
    (final, outs), flagged = syncs_during(replay)
    syncs = len(flagged)
    torch.cuda.synchronize()
    m_launches, s_launches = match_cuda.launches, schur_cuda.launches
    vo = outs if mode == "f2f" else outs.vo
    ates = [float(ate_rmse(vo.T_world[s, 1:, :3, 3], gt[s, 1:, :3, 3])[0]) for s in range(S)]
    n_ok = int(vo.pose_ok[:, 1:].sum())
    limit = C4_REF_ATE_LIMIT_M[mode]
    check(bool(torch.isfinite(vo.T_world).all()), f"{label}: non-finite pose")
    check(n_ok == S * (F - 1), f"{label}: pose_ok on {n_ok}/{S * (F - 1)} lane frames")
    check(max(ates) < limit, f"{label}: lane ATEs {ates} m, limit {limit} m")
    if mode == "f2f":
        n_kf = n_reloc = 0
        want_syncs = F
    else:
        n_kf, n_reloc = int(outs.is_keyframe.sum()), int(outs.reloc_tried.sum())
        want_kf = (F + cfg.keyframe_every - 1) // cfg.keyframe_every
        check(n_kf == S * want_kf, f"{label}: {n_kf} keyframes, expected {S * want_kf}")
        check(int(outs.n_landmarks[:, -1].min()) == cfg.ba.max_landmarks,
              f"{label}: a lane's map holds fewer than {cfg.ba.max_landmarks} landmarks")
        want_syncs = 2 * F  # the gate on every frame, reloc from frame 1, one at the start
    want_schur = 0 if mode == "f2f" else S * (want_kf - 1) * cfg.ba.iters
    check(s_launches == want_schur, f"{label}: {s_launches} Schur launches, expected {want_schur}")
    check(m_launches == 2 * S * F + n_kf + n_reloc,
          f"{label}: {m_launches} matcher launches, expected {2 * S * F} + {n_kf} + {n_reloc}")
    check(syncs == want_syncs, f"{label}: {syncs} syncs in {F} frames, expected {want_syncs}")

    diff, gens = 0.0, lane_generators(SEED + 2, S, device)
    for s in range(S):
        if mode == "f2f":
            seq = run_replay(rig, cfg, init_track_state(cfg.frontend.max_features, gens[s],
                                                        T0=gt[s, 0], device=device), lane(obs, s))[1]
            got = lane(outs, s)
        else:
            seq = run_replay_ba(rig, cfg, init_ba_state(cfg, gens[s], T0=gt[s, 0], device=device),
                                lane(obs, s))[1]
            got = lane(outs, s)
            for name in ("is_keyframe", "n_landmarks", "reloc_tried"):
                check(torch.equal(getattr(got, name), getattr(seq, name)),
                      f"{label}: lane {s} {name} differs from its sequential replay")
            got, seq = got.vo, seq.vo
        for name in ("pose_ok", "n_stereo", "n_temporal", "n_inliers"):
            check(torch.equal(getattr(got, name), getattr(seq, name)),
                  f"{label}: lane {s} {name} differs from its sequential replay")
        diff = max(diff, float((got.T_world - seq.T_world).abs().max()))
    check(diff < C4_POSE_BOUND[mode],
          f"{label}: poses {diff} from the sequential replays, bound {C4_POSE_BOUND[mode]}")

    med = timed_replays(replay, timed_reps)
    print(f"replay {label}: S={S} K={cfg.frontend.max_features} H={cfg.ransac.n_hyps} "
          f"W={cfg.ba.window} L={cfg.ba.max_landmarks} frames={F} landmarks={run['n_landmarks']} "
          f"ATE_per_lane_m={ates} (limit {limit}: JAX CPU reference worst lane + twice the "
          f"spread) pose_ok={n_ok}/{S * (F - 1)} keyframes={n_kf} relocalisations={n_reloc} "
          f"matcher_launches={m_launches} schur_launches={s_launches} syncs={syncs} "
          f"syncs_per_frame={syncs / F} batched_vs_sequential_max_abs_pose_diff={diff} "
          f"(discrete outputs equal) replay_s_median={med} "
          f"frames_per_s_summed_over_lanes={S * F / med} (host clock, {timed_reps} runs after "
          f"one checked run; {card})", flush=True)
    return m_launches, s_launches, rig, obs, final


def cli_at_once(runs: dict, device_args=()) -> None:
    """`python -m sosvo_torch.cli` runs that do not wait on one another, as
    processes at once: {out dir: (config, extra args, expected exit code)};
    each must exit with its code."""
    t0 = time.perf_counter()
    done = run_children({str(d): [sys.executable, "-m", "sosvo_torch.cli", "--config", str(config),
                                  "--out", str(d), *device_args, *extra]
                         for d, (config, extra, _) in runs.items()}, timeout=600)
    wall = time.perf_counter() - t0
    for d, (config, extra, rc) in runs.items():
        r = done[str(d)]
        check(r.returncode == rc, f"cli {d.name}: exit code {r.returncode}, expected {rc}: "
                                  f"{r.stderr[-3000:]}")
        print(f"cli {d.name}: {config.name} {' '.join(extra)} exit={r.returncode}", flush=True)
    print(f"cli: {len(runs)} run(s) at once {wall:.1f} s (host clock)", flush=True)


def cli_phase(c4_limits, configs: Path = ROOT / "configs", device_args=()) -> None:
    """11: the command line on the card, one process per run, in
    build/chip_smoke_cli (gitignored): c4 as written in both modes (report
    mode, lanes, every lane's ATE under phase 10's limit); c2 and c3 as
    written (image mode, window BA; c3 with its loop leg): pose_ok after
    frame 0 in the log, c3 closes a loop; c1 frame to frame with
    --ckpt-every 4: a --fault-inject 5 run exits 42 and its --resume writes
    the uninterrupted run's frames.jsonl byte for byte; the same with
    --pgo, its report's loops and ATE equal too; c3_adaptive as written
    (every frame tracked, a loop closed, the report's ATE before and after
    the leg under the JAX limits) and again with --ckpt-every 32
    --fault-inject 96 (exit 42 after frame 128), then --resume: frames.jsonl
    byte for byte, the same loops and ATE, and the keyframe flags the resume
    read back (kf_00000128.npy) and handed PGO (kf_00000200.npy) equal the
    uninterrupted run's. Runs that do not wait on one another share the
    card: the five presets with the c3_adaptive run that is killed, then the
    four c1 runs before their resumes, then the three resumes. The presets
    are read from `configs`; `device_args` go to every run."""
    import shutil

    import numpy as np

    out = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(out, ignore_errors=True)

    def frames(preset):
        return json.loads((configs / f"{preset}.json").read_text())["run"]["n_frames"]

    def at_once(runs: dict) -> None:
        """{out dir name: (preset, extra args, expected exit code)}."""
        cli_at_once({out / name: (configs / f"{preset}.json", extra, rc)
                     for name, (preset, extra, rc) in runs.items()}, device_args)

    def report(d):
        return json.loads((d / "report.json").read_text())

    def all_tracked(d):
        rows = [json.loads(x) for x in (d / "frames.jsonl").read_text().splitlines()]
        return all(r["pose_ok"] for r in rows[1:]), len(rows)

    ca, ca_args = "c3_adaptive", ("--ckpt-every", "32")
    at_once({f"c4_{mode}": ("c4_batched_replay", ("--mode", mode), 0) for mode in ("f2f", "ba")}
            | {preset: (preset, (), 0) for preset in ("c2_chip_ba", "c3_host_pgo", ca)}
            | {f"{ca}_faulted": (ca, (*ca_args, "--fault-inject", "96"), 42)})
    for mode in ("f2f", "ba"):
        d = out / f"c4_{mode}"
        rep = report(d)
        check(rep["mode"] == f"batched-{mode}" and rep["n_sequences"] == 4,
              f"cli c4 {mode}: report {rep}")
        check(max(rep["ate_per_sequence"]) < c4_limits[mode],
              f"cli c4 {mode}: lane ATEs {rep['ate_per_sequence']}, limit {c4_limits[mode]}")
        check(all_tracked(d) == (True, frames("c4_batched_replay")),
              f"cli c4 {mode}: lane 0 lost a frame")
        print(f"cli c4_{mode}: report {json.dumps(rep)}", flush=True)
    for preset in ("c2_chip_ba", "c3_host_pgo"):
        d = out / preset
        rep, n = report(d), frames(preset)
        check(rep["mode"] == "ba" and rep["frames"] == n and all_tracked(d) == (True, n),
              f"cli {preset}: report {rep}, or a frame lost")
        check(preset != "c3_host_pgo" or rep["pgo_loops"] >= 1, f"cli {preset}: no loop closed")
        print(f"cli {preset}: report {json.dumps(rep)}", flush=True)
    rep, n = report(out / ca), frames(ca)
    limits = {k: sum(image_ate_limit(f"{ca}_{k}")) for k in ("ba", "pgo")}
    check(rep["mode"] == "ba" and rep["frames"] == n and all_tracked(out / ca) == (True, n),
          f"cli {ca}: report {rep}, or a frame lost")
    check(rep["pgo_loops"] >= 1, f"cli {ca}: no loop closed")
    check(rep["ate_rmse_vo_m"] <= limits["ba"] and rep["ate_rmse_m"] <= limits["pgo"],
          f"cli {ca}: ATE before / after the leg {rep['ate_rmse_vo_m']} / {rep['ate_rmse_m']} m, "
          f"limits {limits['ba']} / {limits['pgo']} (the JAX rows' worst + twice the spread)")
    print(f"cli {ca}: report {json.dumps(rep)}; limits before / after the leg {limits}", flush=True)
    c1 = "c1_cpu_smoke"
    variants = {tag: ("--mode", "f2f", "--ckpt-every", "4", *extra)
                for tag, extra in (("c1", ()), ("c1_pgo", ("--pgo",)))}
    first = {}
    for tag, args in variants.items():
        first[f"{tag}_full"] = (c1, args, 0)
        first[f"{tag}_faulted"] = (c1, (*args, "--fault-inject", "5"), 42)
    at_once(first)
    at_once({f"{tag}_faulted": (c1, (*args, "--resume"), 0) for tag, args in variants.items()}
            | {f"{ca}_faulted": (ca, (*ca_args, "--resume"), 0)})
    for tag in variants:
        full, resumed = out / f"{tag}_full", out / f"{tag}_faulted"
        a, b = (full / "frames.jsonl").read_bytes(), (resumed / "frames.jsonl").read_bytes()
        check(a == b, f"cli {tag}: the resumed frames.jsonl differs from the uninterrupted one")
        ra, rb = report(full), report(resumed)
        check((ra["pgo_loops"], ra["ate_rmse_m"]) == (rb["pgo_loops"], rb["ate_rmse_m"]),
              f"cli {tag}: resumed report {rb} differs from {ra}")
        print(f"cli {tag}: killed after frame 5 (exit 42), resumed at frame 8: frames.jsonl "
              f"identical ({len(a)} bytes), pgo_loops={rb['pgo_loops']} "
              f"ate_rmse_m={rb['ate_rmse_m']} in both", flush=True)
    # c3_adaptive killed and resumed: the resumed run hands PGO the scan's
    # whole adaptive keyframe set, the checkpoint's prefix and its own flags
    full, resumed = out / ca, out / f"{ca}_faulted"
    a, b = (full / "frames.jsonl").read_bytes(), (resumed / "frames.jsonl").read_bytes()
    check(a == b, f"cli {ca}: the resumed frames.jsonl differs from the uninterrupted one")
    ra, rb = report(full), report(resumed)
    check((ra["pgo_loops"], ra["ate_rmse_m"]) == (rb["pgo_loops"], rb["ate_rmse_m"]),
          f"cli {ca}: resumed report {rb} differs from {ra}")
    kf = {(d.name, step): np.load(d / "ckpt" / f"kf_{step:08d}.npy")
          for d in (full, resumed) for step in (128, n)}
    check(np.array_equal(kf[full.name, 128], kf[resumed.name, 128])
          and np.array_equal(kf[full.name, n], kf[resumed.name, n]) and len(kf[full.name, n]) == n,
          f"cli {ca}: the keyframe flags the resumed run read or handed PGO differ from the "
          f"uninterrupted run's")
    nodes = np.nonzero(kf[resumed.name, n])[0]
    print(f"cli {ca}: killed after frame 128 (--fault-inject 96, --ckpt-every 32; exit 42), "
          f"resumed at frame 128: frames.jsonl identical ({len(a)} bytes), "
          f"pgo_loops={rb['pgo_loops']} ate_rmse_m={rb['ate_rmse_m']} in both; the flags read "
          f"back (kf_00000128.npy, {int(kf[resumed.name, 128].sum())} keyframes) and handed PGO "
          f"(kf_{n:08d}.npy: {len(nodes)} nodes, {nodes.tolist()}) equal the uninterrupted "
          f"run's", flush=True)
    cli_dist_phase(configs, device_args)


def cli_dist_phase(configs: Path = ROOT / "configs", device_args=()) -> None:
    """11, over ranks: `torchrun --standalone --nproc-per-node DIST_RANKS -m
    sosvo_torch.cli`, one process group per preset, in build/chip_smoke_cli:
    c5 as written with --verify-sharded (the report's model axis and its
    largest pose difference from the one-device replay, under 1e-3), and
    c3_long_sharded as written (1024 rendered frames, K=1024; rank 0
    replays, the loop leg runs over the ranks: a loop closed)."""
    out = ROOT / "build" / "chip_smoke_cli"

    def torchrun(preset, name, *extra):
        t0 = time.perf_counter()
        r = run_children({name: [sys.executable, "-m", "torch.distributed.run", "--standalone",
                                 "--nproc-per-node", str(DIST_RANKS), "-m", "sosvo_torch.cli",
                                 "--config", str(configs / f"{preset}.json"),
                                 "--out", str(out / name), *device_args, *extra]},
                         timeout=900)[name]
        check(r.returncode == 0, f"torchrun cli {name}: exit code {r.returncode}: "
                                 f"{r.stderr[-3000:]}")
        rep = json.loads((out / name / "report.json").read_text())
        print(f"cli {name}: torchrun --nproc-per-node {DIST_RANKS} {preset} {' '.join(extra)} "
              f"process_s={time.perf_counter() - t0} (host clock); report {json.dumps(rep)}",
              flush=True)
        return rep

    rep = torchrun("c5_multihost", "c5_torchrun", "--verify-sharded")
    check(rep["mesh"] == {"model": DIST_RANKS} and rep["world"] == DIST_RANKS,
          f"cli c5: report {rep}")
    check(rep["sharded_vs_single_max_pose_diff"] < 1e-3, f"cli c5: report {rep}")
    rep = torchrun("c3_long_sharded", "c3_long_sharded_torchrun")
    check(rep["pgo_loops"] > 0 and rep.get("pgo_shards") == DIST_RANKS,
          f"cli c3_long_sharded: report {rep}")


# The JAX package's c5 ATE on seeds 0-2, worst plus twice the spread
# (scripts/ref_c5_ate.py on the CPU).
C5_REF_ATE_LIMIT_M = 0.010869319550693035
# The JAX package's ATE after the c3_long_mesh leg over its window-BA
# replay, worst seed plus twice the spread over seeds 0-2
# (scripts/ref_c3_long_ate.py on the CPU).
C3_LONG_BA_REF_LIMIT_M = 0.01846936345100403
DIST_RANKS = 8  # ranks on the one card (configs/c5_multihost.json's model axis, pgo_shards 8)


def _rel_err(got, ref) -> float:
    return float((got - ref).abs().max()) / (float(ref.abs().max()) + 1e-30)


def c5_rank(ranks):
    """Phase 12 in one rank: configs/c5_multihost.json's replay with every
    window solve landmark-sharded over all ranks (counts reset just before,
    read just after); then one more solve of the final window for its
    collectives and syncs, the kernel on this rank's W8/L512 shard of that
    window against its plain version, and the shards' all-reduced S_off and
    b_sub against one W8/L4096 launch."""
    import torch
    from sosvo_torch.dist import dryrun, mesh as dmesh
    from sosvo_torch.dist.replay_dist import make_sharded_ba_fn, run_replay_ba_sharded
    from sosvo_torch.kernels import match_cuda, schur_cuda
    from sosvo_torch.tools.sync_check import syncs_during
    from sosvo_torch.tools.workload import SEED, load_preset, make_workload
    from sosvo_torch.vo.ba_pipeline import init_ba_state

    cfg, run = load_preset("c5_multihost")
    dev = ranks.device
    m = dmesh.make_mesh(ranks, 1, ranks.world)
    axis = m.axis(dmesh.MODEL_AXIS)
    rig, scene, obs = make_workload(cfg, run["n_frames"], run["n_landmarks"], dev)
    state = init_ba_state(cfg, torch.Generator(device=dev).manual_seed(SEED + 2),
                          T0=scene.poses[0], device=dev)
    torch.cuda.synchronize(dev)
    match_cuda.reset_launches()
    schur_cuda.reset_launches()
    dmesh.reset_calls()
    t0 = time.perf_counter()
    final, outs = run_replay_ba_sharded(m, rig, cfg, state, obs)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {"match": match_cuda.launches, "schur": schur_cuda.launches}
    calls = dict(dmesh.calls)
    ba_fn = make_sharded_ba_fn(m, rig, cfg)
    dmesh.reset_calls()
    _, syncs = syncs_during(lambda: (ba_fn(final.map), torch.cuda.synchronize(dev)))
    solve_calls = dict(dmesh.calls)

    blocks = window_blocks(rig, cfg, final.map)
    H_cc, H_cl, H_ll, b_c, b_l = blocks
    n = H_ll.shape[0] // axis.size
    sl = slice(axis.index * n, (axis.index + 1) * n)
    lam = cfg.ba.damping_init
    shard = (H_cc, H_cl[:, sl], H_ll[sl], b_c, b_l[sl])
    got = schur_cuda.schur_reduce_cuda(*shard, lam)
    ref = schur_cuda.schur_reduce_plain(*shard, lam)
    torch.cuda.synchronize(dev)
    shard_err = {f: _rel_err(getattr(got, f), getattr(ref, f)) for f in SCHUR_TOL}
    S_sum, b_sum = axis.psum(got.S_off, got.b_sub)
    full = schur_cuda.schur_reduce_cuda(*blocks, lam)
    sum_err = {"S_off": _rel_err(S_sum, full.S_off), "b_sub": _rel_err(b_sum, full.b_sub)}
    t1 = time.perf_counter()
    dry = dryrun._rank(ranks, *dryrun.layout(ranks.world))  # 12b, in the same ranks
    return dict(outs=outs, wall=wall, launches=launches, calls=calls, solve_calls=solve_calls,
                solve_syncs=len(syncs), shard_err=shard_err, sum_err=sum_err, dryrun=dry,
                dryrun_s=time.perf_counter() - t1)


def c5_phase(device, results, schur) -> dict:
    """12: c5 as written (configs/c5_multihost.json: 100 frames, K=1024,
    H=512, W=8, L=4096, 32768 scene landmarks) over DIST_RANKS ranks on the
    one card, every window solve landmark-sharded: every rank's outputs
    bit-equal; against the port's one-device replay of the same inputs and
    draws, discrete outputs equal and poses within 1e-3; pose_ok after
    frame 0; ATE under scripts/ref_c5_ate.py's limit; Schur launches per
    rank = windows x iterations; each rank's W8/L512 shard kernel against
    its plain version and the 8 shards' all-reduced S_off and b_sub against
    one W8/L4096 launch within SCHUR_TOL; then the matcher at 1024x1024 and
    the Schur kernel on a W8/L512 shard against their plain versions, timed
    in this process. Returns the launch counts summed over the ranks."""
    import torch
    from sosvo_torch.dist import dryrun
    from sosvo_torch.dist.launch import launch
    from sosvo_torch.eval.ate import ate_rmse
    from sosvo_torch.tools.workload import ba_replayer, load_preset, make_workload

    cfg, run = load_preset("c5_multihost")
    F = run["n_frames"]
    t0 = time.perf_counter()
    ranks = launch("chip_smoke:c5_rank", DIST_RANKS, timeout_s=900)
    launch_s = time.perf_counter() - t0
    r0 = ranks[0]
    leaves = lambda o: [x for part in o for x in (part if isinstance(part, tuple) else (part,))]  # noqa: E731
    for r, o in enumerate(ranks[1:], 1):
        check(all(torch.equal(a, b) for a, b in zip(leaves(o["outs"]), leaves(r0["outs"]))),
              f"c5: rank {r}'s outputs differ from rank 0's")
        check(o["launches"] == r0["launches"], f"c5: rank {r} launched {o['launches']}")
    rig, scene, obs = make_workload(cfg, F, run["n_landmarks"], device)
    t1 = time.perf_counter()
    final1, one = ba_replayer(cfg, rig, scene, obs, device)()
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t1
    got = r0["outs"]
    for name in ("is_keyframe", "n_landmarks", "reloc_tried"):
        check(torch.equal(getattr(got, name), getattr(one, name).cpu()),
              f"c5: {name} differs from the one-device replay")
    for name in ("pose_ok", "n_stereo", "n_temporal", "n_inliers"):
        check(torch.equal(getattr(got.vo, name), getattr(one.vo, name).cpu()),
              f"c5: {name} differs from the one-device replay")
    diff = float((got.vo.T_world - one.vo.T_world.cpu()).abs().max())
    check(diff < 1e-3, f"c5: sharded vs one-device max pose difference {diff} >= 1e-3")
    n_ok = int(got.vo.pose_ok[1:].sum())
    check(n_ok == F - 1, f"c5: pose_ok on {n_ok}/{F - 1} frames")
    ate = float(ate_rmse(got.vo.T_world[1:, :3, 3], scene.poses[1:, :3, 3].cpu())[0])
    check(C5_REF_ATE_LIMIT_M is None or ate < C5_REF_ATE_LIMIT_M,
          f"c5: ATE {ate} m >= the JAX package's limit {C5_REF_ATE_LIMIT_M} m")
    n_kf, n_reloc = int(got.is_keyframe.sum()), int(got.reloc_tried.sum())
    windows = n_kf - 1
    # per window solve: the initial cost, per LM iteration one all-reduce of
    # the camera system with the Schur partials and one of the candidate's
    # cost (one more of the reweighted cost under Huber IRLS), and one
    # all-gather of the landmarks
    per_iter = 3 if cfg.ba.huber_delta else 2
    want_calls = {"model.psum": 1 + per_iter * cfg.ba.iters, "model.all_gather": 1}
    check(r0["solve_calls"] == want_calls,
          f"c5: collectives per window solve {r0['solve_calls']}, expected {want_calls}")
    # under gloo every collective on a CUDA tensor waits on the host for the
    # card (gloo's worker thread, which the sync debug mode does not see)
    host_syncs = sum(r0["solve_calls"].values()) + r0["solve_syncs"]
    check(r0["launches"]["schur"] == windows * cfg.ba.iters,
          f"c5: {r0['launches']['schur']} Schur launches per rank, expected {windows} windows "
          f"x {cfg.ba.iters}")
    check(r0["launches"]["match"] == 2 * F + n_kf + n_reloc,
          f"c5: {r0['launches']['match']} matcher launches per rank")
    for r, o in enumerate(ranks):
        for f, e in o["shard_err"].items():
            check(e < SCHUR_TOL[f], f"c5: rank {r}'s W8/L512 shard {f} relative error {e}")
        for f, e in o["sum_err"].items():
            check(e < SCHUR_TOL[f], f"c5: the shards' all-reduced {f} relative error {e} against "
                                    f"one W8/L4096 launch")
    # 12b: sosvo_torch/dist/dryrun.py's step, run by the same ranks after the
    # replay: every distributed path on a 2 data x 4 model layout, each
    # checked against one rank (summarize raises on a divergence).
    print(f"dist dryrun: {dryrun.summarize([o['dryrun'] for o in ranks], *dryrun.layout(DIST_RANKS))}"
          f" (rank 0 s={r0['dryrun_s']}, host clock)", flush=True)
    print(f"dist c5_sharded_replay: ranks={DIST_RANKS} on one card, backend gloo; "
          f"K={cfg.frontend.max_features} H={cfg.ransac.n_hyps} W={cfg.ba.window} "
          f"L={cfg.ba.max_landmarks} (local {cfg.ba.max_landmarks // DIST_RANKS}) frames={F} "
          f"ATE_m={ate} (limit {C5_REF_ATE_LIMIT_M}) ATE_one_device_m="
          f"{float(ate_rmse(one.vo.T_world[1:, :3, 3], scene.poses[1:, :3, 3])[0])} "
          f"pose_ok={n_ok}/{F - 1} keyframes={n_kf} windows={windows} relocalisations={n_reloc} "
          f"sharded_vs_single_max_pose_diff={diff} (discrete outputs equal, every rank bit-equal) "
          f"launches_per_rank={r0['launches']} collectives_per_rank={r0['calls']} "
          f"per_window_solve: collectives={r0['solve_calls']} sync_debug_syncs="
          f"{r0['solve_syncs']} host_syncs={host_syncs} (gloo: one per collective) "
          f"shard_vs_plain_max_rel_err={max(max(o['shard_err'].values()) for o in ranks):.3e} "
          f"shard_sum_vs_full_max_rel_err={max(max(o['sum_err'].values()) for o in ranks):.3e} "
          f"replay_s_rank0={r0['wall']} replay_s_slowest={max(o['wall'] for o in ranks)} "
          f"launch_s={launch_s} one_device_replay_s={single_s} (host clock)", flush=True)

    compare_frame_matches("c5_1024", cfg, run["n_landmarks"], device, results)
    blocks = window_blocks(rig, cfg, final1.map)
    n = cfg.ba.max_landmarks // DIST_RANKS
    H_cc, H_cl, H_ll, b_c, b_l = blocks
    schur["c5_shard_W8_L512"] = compare_schur(
        "c5_shard0_W8_L512", (H_cc, H_cl[:, :n], H_ll[:n].contiguous(), b_c, b_l[:n].contiguous()),
        cfg.ba.damping_init)
    return {"match": sum(o["launches"]["match"] for o in ranks),
            "schur": sum(o["launches"]["schur"] for o in ranks)}


def c3_long_rank(ranks, obs_kf, T_world, kf_idx):
    """Phase 13 in one rank: the loop-closing leg of configs/c3_long_mesh.json
    with its pairs split over the ranks and its nodes along time (counts
    reset just before, read just after; syncs counted by PyTorch's sync
    debug mode during it)."""
    import torch
    from sosvo_torch.dist import mesh as dmesh
    from sosvo_torch.dist.c3_dist import refine_keyframes_sharded
    from sosvo_torch.kernels import match_cuda, schur_cuda
    from sosvo_torch.sensor.rig import default_rig
    from sosvo_torch.synth.scene import FrameObservations
    from sosvo_torch.tools.sync_check import syncs_during
    from sosvo_torch.tools.workload import load_preset

    cfg, _ = load_preset("c3_long_mesh")
    dev = ranks.device
    m = dmesh.make_mesh(ranks, ranks.world, 1)
    obs_kf = FrameObservations(*(x.to(dev) for x in obs_kf))
    T_world = T_world.to(dev)
    rig = default_rig(device=dev)

    def leg():
        out = refine_keyframes_sharded(
            m, rig, cfg, obs_kf, T_world, kf_idx, min_gap=3, min_inliers=cfg.loop_min_inliers,
            iters=10, max_candidates=cfg.loop_candidates or None, robust=cfg.pgo_robust,
            robust_delta=cfg.pgo_robust_delta)
        torch.cuda.synchronize(dev)
        return out

    match_cuda.reset_launches()
    schur_cuda.reset_launches()
    dmesh.reset_calls()
    t0 = time.perf_counter()
    (T_c, n_loops), syncs = syncs_during(leg)  # the first leg in the process, syncs counted
    wall = time.perf_counter() - t0
    launches = {"match": match_cuda.launches, "schur": schur_cuda.launches}
    return dict(T=T_c, n_loops=int(n_loops), wall=wall, launches=launches,
                calls=dict(dmesh.calls), syncs=len(syncs))


def c3_long_phase(device) -> dict:
    """13: configs/c3_long_mesh.json in observation mode. First the
    frame-to-frame replay of 1024 frames on one device (its 128 stride
    keyframes are the graph's nodes), then its loop-closing leg (256
    candidates, 60 inliers) on one device and over DIST_RANKS ranks (pairs
    split, nodes split along time), each the first leg in its process: the
    same loop count, above 0; poses within 5e-3 of the one-device leg; ATE
    after the leg below the replay's; the sharded leg's ATE at most 1.05 x
    the one-device leg's + 1e-4. Then the preset as written (the command
    line's `--mode ba`): the window-BA replay and the one-device leg over
    its keyframes, ATE after the leg under C3_LONG_BA_REF_LIMIT_M. Over the
    BA replay the JAX package's leg raises ATE on seeds 1 and 2 and lowers
    it on seed 0 (scripts/ref_c3_long_ate.py), so the drift-removal checks
    take the frame-to-frame replay. Returns the launch counts of each
    path."""
    import numpy as np
    import torch
    from sosvo_torch.dist.launch import launch
    from sosvo_torch.eval.ate import ate_rmse
    from sosvo_torch.kernels import match_cuda, schur_cuda
    from sosvo_torch.synth.scene import FrameObservations
    from sosvo_torch.tools.workload import (ba_replayer, load_preset, make_workload, pgo_leg,
                                            replayer)
    from sosvo_torch.vo.loop_closure import keyframe_indices

    cfg, run = load_preset("c3_long_mesh")
    F = run["n_frames"]
    rig, scene, obs = make_workload(cfg, F, run["n_landmarks"], device)
    torch.cuda.synchronize()
    match_cuda.reset_launches()
    schur_cuda.reset_launches()
    t0 = time.perf_counter()
    _, outs = replayer(cfg, rig, scene, obs, device)()
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    replay_launches = {"match": match_cuda.launches, "schur": schur_cuda.launches}
    kf_idx = keyframe_indices(F, cfg.keyframe_every)
    n_ok = int(outs.pose_ok[1:].sum())
    check(n_ok == F - 1, f"c3_long: pose_ok on {n_ok}/{F - 1} frames")
    gt = scene.poses[1:, :3, 3]
    T_vo = outs.T_world
    ate_vo = float(ate_rmse(T_vo[1:, :3, 3], gt)[0])

    match_cuda.reset_launches()
    schur_cuda.reset_launches()
    t1 = time.perf_counter()
    one = pgo_leg(cfg, rig, obs, T_vo, kf_idx)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t1
    one_launches = {"match": match_cuda.launches, "schur": schur_cuda.launches}
    kf = torch.as_tensor(kf_idx, device=device)
    obs_kf = FrameObservations(*(x[kf].cpu() for x in obs))
    t2 = time.perf_counter()
    ranks = launch("chip_smoke:c3_long_rank", DIST_RANKS,
                   dict(obs_kf=obs_kf, T_world=T_vo.cpu(), kf_idx=kf_idx),
                   timeout_s=900)
    launch_s = time.perf_counter() - t2
    r0 = ranks[0]
    for r, o in enumerate(ranks[1:], 1):
        check(torch.equal(o["T"], r0["T"]) and o["n_loops"] == r0["n_loops"],
              f"c3_long: rank {r}'s leg differs from rank 0's")
    n1 = int(one.n_loops)
    check(r0["n_loops"] == n1 and n1 > 0, f"c3_long: {r0['n_loops']} loops sharded, {n1} one-device")
    pose_diff = float(torch.linalg.norm(r0["T"][:, :3, 3] - one.T_corrected[:, :3, 3].cpu(),
                                        dim=-1).max())
    check(pose_diff < 5e-3, f"c3_long: sharded vs one-device leg pose difference {pose_diff}")
    ate_1 = float(ate_rmse(one.T_corrected[1:, :3, 3], gt)[0])
    ate_8 = float(ate_rmse(r0["T"][1:, :3, 3], gt.cpu())[0])
    check(ate_8 < ate_vo, f"c3_long: ATE after the sharded leg {ate_8} not below {ate_vo}")
    check(ate_8 <= 1.05 * ate_1 + 1e-4, f"c3_long: sharded leg ATE {ate_8} > 1.05 x {ate_1} + 1e-4")
    leg_launches = {k: sum(o["launches"][k] for o in ranks) for k in ("match", "schur")}
    host_syncs = sum(r0["calls"].values()) + r0["syncs"]

    # the preset as written: window-BA replay, its keyframes, the leg
    match_cuda.reset_launches()
    schur_cuda.reset_launches()
    t3 = time.perf_counter()
    _, ba_outs = ba_replayer(cfg, rig, scene, obs, device)()
    torch.cuda.synchronize()
    ba_s = time.perf_counter() - t3
    ba_launches = {"match": match_cuda.launches, "schur": schur_cuda.launches}
    n_ok_ba = int(ba_outs.vo.pose_ok[1:].sum())
    check(n_ok_ba == F - 1, f"c3_long BA: pose_ok on {n_ok_ba}/{F - 1} frames")
    kf_ba = np.nonzero(ba_outs.is_keyframe.cpu().numpy())[0]
    match_cuda.reset_launches()
    schur_cuda.reset_launches()
    t4 = time.perf_counter()
    ba_leg = pgo_leg(cfg, rig, obs, ba_outs.vo.T_world, kf_ba)
    torch.cuda.synchronize()
    ba_leg_s = time.perf_counter() - t4
    ba_leg_launches = {"match": match_cuda.launches, "schur": schur_cuda.launches}
    ate_ba = float(ate_rmse(ba_outs.vo.T_world[1:, :3, 3], gt)[0])
    ate_ba_leg = float(ate_rmse(ba_leg.T_corrected[1:, :3, 3], gt)[0])
    check(int(ba_leg.n_loops) > 0, "c3_long BA: the leg closed no loop")
    check(ate_ba_leg < C3_LONG_BA_REF_LIMIT_M,
          f"c3_long BA: ATE after the leg {ate_ba_leg} m >= the JAX package's limit "
          f"{C3_LONG_BA_REF_LIMIT_M} m")
    print(f"dist c3_long_mesh as written (--mode ba): keyframes={len(kf_ba)} pose_ok={n_ok_ba}/"
          f"{F - 1} loops={int(ba_leg.n_loops)} ATE_ba_replay_m={ate_ba} ATE_after_leg_m="
          f"{ate_ba_leg} (limit {C3_LONG_BA_REF_LIMIT_M}) ba_replay_s={ba_s} "
          f"ba_replay_launches={ba_launches} leg_s={ba_leg_s} leg_launches={ba_leg_launches} "
          f"(host clock)", flush=True)
    print(f"dist c3_long_mesh: frames={F} keyframes={len(kf_idx)} K={cfg.frontend.max_features} "
          f"H={cfg.ransac.n_hyps} candidates={cfg.loop_candidates} min_inliers="
          f"{cfg.loop_min_inliers} shards={DIST_RANKS} loops={r0['n_loops']} (one-device {n1}) "
          f"ATE_vo_m={ate_vo} ATE_one_device_leg_m={ate_1} ATE_sharded_leg_m={ate_8} "
          f"sharded_vs_one_device_max_pos_diff_m={pose_diff} pose_ok={n_ok}/{F - 1} "
          f"f2f_replay_s={replay_s} replay_launches={replay_launches} one_device_leg_s={one_s} "
          f"one_device_leg_launches={one_launches} sharded_leg_s_rank0={r0['wall']} "
          f"sharded_leg_s_slowest={max(o['wall'] for o in ranks)} launch_s={launch_s} "
          f"sharded_leg_launches_per_rank={[o['launches'] for o in ranks]} "
          f"collectives_per_leg_rank0={r0['calls']} sync_debug_syncs_per_leg_rank0={r0['syncs']} "
          f"host_syncs_per_leg_rank0={host_syncs} (gloo: one per collective) "
          f"(host clock)", flush=True)
    return {"replay": replay_launches, "one_device_leg": one_launches, "sharded_leg": leg_launches,
            "ba_replay": ba_launches, "ba_leg": ba_leg_launches}




def device_events_per_call(label: str, fn, calls: int = 20) -> float:
    """Device events (kernels, copies, fills) per call of `fn`, from the
    profiler over `calls` calls after a warm-up; prints what the profiler
    recorded (event counts, device event names)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    every = prof.events()
    events = [e for e in every if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    print(f"device_events {label}: {len(every)} profiler events over {calls} calls, "
          f"{len(events)} on the device: {sorted({e.name[:60] for e in events})}", flush=True)
    return len(events) / calls


SIFT_DESC_TOL = 1e-6      # per descriptor, card against CPU (tests/test_torch_sift.py's)
SIFT_MAX_BIN_MOVES = 0.01  # share of descriptors allowed past it (a sample across a bin edge)
SIFT_BIN_MOVE_L2 = 0.05    # and how far such a descriptor may move
AKAZE_SLOT_TOL = 1e-5      # near-ties of the max-reduced Hessian (tests/test_torch_akaze.py's)


def descriptor_frontend_phase(cfg, n_frames: int, device, results) -> None:
    """14a and 14b: the AKAZE and SIFT extractors at `cfg`'s width (c2: K=512,
    128x1024 panoramas) on the card against the port on the CPU, on frames 0
    and 30 of the preset's rendered sequence and the same LUT values: slots
    equal but for near-ties (counted); on equal slots validity equal, uv
    within 1e-3 px, rays within 1e-6, AKAZE's words (rows with any word
    apart counted, at most 1 % of the slots) and SIFT's descriptors within
    SIFT_DESC_TOL but for at most SIFT_MAX_BIN_MOVES of them, none beyond
    SIFT_BIN_MOVE_L2 (card and CPU `atan2` differ in the last bit). Prints
    each extractor's host ms, device ms and device events per frame. 14b:
    the Hamming kernel against its plain version on frame 0's AKAZE
    descriptors, stereo in c2's band and temporal to frame 30, and its
    device us and device events per call (profiler)."""
    import torch
    from sosvo_torch.frontend.akaze import hessian_response, nonlinear_scale_space
    from sosvo_torch.frontend.detect import gaussian_smooth, harris_response
    from sosvo_torch.frontend.image_frontend import build_frontend_luts, extract_observations
    from sosvo_torch.frontend.panorama import warp_panorama
    from sosvo_torch.sensor.rig import default_rig
    from sosvo_torch.kernels.match_cuda import match_stats_cuda
    from sosvo_torch.tools.frontend_parity import slot_mismatches, view_keypoints
    from sosvo_torch.tools.profile_replay import _device_us_per_call, timed_and_profiled
    from sosvo_torch.tools.workload import render_frames
    from sosvo_torch.vo.pipeline import azimuth_of, stereo_triangulate

    cpu = torch.device("cpu")
    rig, rig_cpu = default_rig(device=device), default_rig(device=cpu)
    frames = (0, 30)
    images = render_frames(rig, n_frames, frames, device)
    torch.cuda.synchronize()
    for descriptor in ("akaze", "sift"):
        c = with_descriptor(cfg, descriptor)
        fe = c.frontend
        luts = build_frontend_luts(rig, fe)
        luts_cpu = _luts_on(luts, cpu)
        extracted = []
        for f, img in zip(frames, images):
            got = extract_observations(rig, luts, fe, img)
            ref = extract_observations(rig_cpu, luts_cpu, fe, img.cpu())
            kps_got = view_keypoints(luts, fe, img)
            kps_ref = view_keypoints(luts_cpu, fe, img.cpu())
            for i, view in enumerate(("top", "bottom")):
                pano = warp_panorama(img.cpu(), getattr(luts_cpu, view))
                if descriptor == "akaze":
                    resp = hessian_response(nonlinear_scale_space(pano)).max(dim=0).values
                    tol = AKAZE_SLOT_TOL * float(resp.abs().max())
                else:
                    tol = 1e-6 * float(harris_response(gaussian_smooth(pano)).abs().max())
                kr, kg = kps_ref[i], kps_got[i]
                differ, unexplained = slot_mismatches(kr.rows, kr.cols, kr.response,
                                                      kg.rows.cpu(), kg.cols.cpu(), fe.pano_width,
                                                      tol)
                same = torch.as_tensor(~differ)
                g_desc = getattr(got, f"desc_{view}").cpu()[same]
                r_desc = getattr(ref, f"desc_{view}")[same]
                valid_ok = torch.equal(getattr(got, f"valid_{view}").cpu()[same],
                                       getattr(ref, f"valid_{view}")[same])
                uv_err = float((getattr(got, f"uv_{view}").cpu()[same]
                                - getattr(ref, f"uv_{view}")[same]).abs().max())
                ray_err = float((getattr(got, f"ray_{view}").cpu()[same]
                                 - getattr(ref, f"ray_{view}")[same]).abs().max())
                check(not unexplained.any(),
                      f"frontend {descriptor} frame {f} {view}: {int(unexplained.sum())} slots "
                      f"differ between card and CPU with no near-tie")
                check(valid_ok and uv_err < 1e-3 and ray_err < 1e-6,
                      f"frontend {descriptor} frame {f} {view}: validity, uv ({uv_err} px) or rays "
                      f"({ray_err}) differ between card and CPU")
                if descriptor == "akaze":
                    rows_apart = int((g_desc != r_desc).any(dim=1).sum())
                    check(rows_apart <= 0.01 * fe.max_features,
                          f"frontend akaze frame {f} {view}: {rows_apart} descriptors differ")
                    desc_note = f"descriptors_with_a_word_apart={rows_apart}"
                else:
                    err = (g_desc - r_desc).abs().max(dim=1).values
                    moved = int((err > SIFT_DESC_TOL).sum())
                    l2 = float(torch.linalg.vector_norm(g_desc - r_desc, dim=1).max())
                    check(moved <= SIFT_MAX_BIN_MOVES * fe.max_features and l2 < SIFT_BIN_MOVE_L2,
                          f"frontend sift frame {f} {view}: {moved} descriptors beyond "
                          f"{SIFT_DESC_TOL}, largest L2 gap {l2}")
                    desc_note = (f"desc_max_abs_err={float(err.max()):.3e} "
                                 f"descriptors_beyond_{SIFT_DESC_TOL}={moved} "
                                 f"largest_l2_gap={l2:.3e}")
                print(f"frontend {descriptor} frame {f} {view}: K={fe.max_features} "
                      f"valid={int(getattr(got, f'valid_{view}').sum())} card vs CPU (same LUT "
                      f"values): slots_differ={int(differ.sum())} without_near_tie="
                      f"{int(unexplained.sum())} valid_equal={valid_ok} {desc_note} "
                      f"uv_max_abs_err={uv_err:.3e} ray_max_abs_err={ray_err:.3e}", flush=True)
            extracted.append(got)
        host_s, dev_s, events = timed_and_profiled(lambda: extract_observations(rig, luts, fe,
                                                                               images[0]))
        print(f"frontend {descriptor}: per frame (two views) host_ms={1e3 * host_s:.3f} "
              f"device_ms={1e3 * dev_s:.4f} device_events={events} (c2 width, card; one "
              f"frame after a warm-up, tools/profile_replay.py:timed_and_profiled)", flush=True)
        if descriptor == "akaze":  # 14b
            f0, f1 = extracted
            valid0 = stereo_triangulate(rig, f0, c)[4]
            valid1 = stereo_triangulate(rig, f1, c)[4]
            results["c2_akaze_stereo"] = compare_kernel(
                "c2_akaze_frame0_stereo", (f0.desc_top, f0.desc_bottom, f0.valid_top,
                                           f0.valid_bottom, azimuth_of(f0.ray_top),
                                           azimuth_of(f0.ray_bottom)),
                fe.stereo_band_rad, c)
            results["c2_akaze_temporal"] = compare_kernel(
                "c2_akaze_frame0_frame30_temporal", (f0.desc_top, f1.desc_top, valid0, valid1,
                                                     None, None), 0.0, c)
            check(results["c2_akaze_stereo"]["max_abs_err"] == 0.0
                  and results["c2_akaze_temporal"]["max_abs_err"] == 0.0,
                  "the matcher on AKAZE descriptors differs from its plain version")
            # device us and device events per call (profiler, 50 calls after a warm-up)
            for label, args, band in (
                    ("stereo", (f0.desc_top, f0.desc_bottom, f0.valid_top, f0.valid_bottom,
                                azimuth_of(f0.ray_top), azimuth_of(f0.ray_bottom)),
                     fe.stereo_band_rad),
                    ("temporal", (f0.desc_top, f1.desc_top, valid0, valid1, None, None), 0.0)):
                us, ev, _ = _device_us_per_call(lambda: match_stats_cuda(*args, band=band))
                results[f"c2_akaze_{label}"].update(device_us=us, device_events_per_call=ev)
                print(f"kernel_device c2_akaze_{label}: device_us_per_call={us} "
                      f"device_events_per_call={ev} (profiler, 50 calls)", flush=True)


def descriptor_cli_phase(cfg_path: Path, descriptor: str, device_args=()) -> None:
    """14d's command line: configs/c2_chip_ba.json with `descriptor`, written
    to build/chip_smoke_cli, run in processes of its own (BA mode, a
    checkpoint every 16 frames): uninterrupted and, at the same time, killed
    after frame 20 (exit 42), then resumed; the resumed run's frames.jsonl
    equals the uninterrupted one byte for byte and its report's ATE too.
    `device_args` go to every run."""
    import shutil

    out = ROOT / "build" / "chip_smoke_cli" / f"c2_{descriptor}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    d = json.loads(cfg_path.read_text())
    d["pipeline"]["frontend"]["descriptor"] = descriptor
    config = out / f"c2_{descriptor}.json"
    config.write_text(json.dumps(d))

    args = ("--mode", "ba", "--ckpt-every", "16")
    full, resumed = out / "full", out / "faulted"
    # the uninterrupted run and the one killed after frame 20 at once, then the resume
    cli_at_once({full: (config, args, 0), resumed: (config, (*args, "--fault-inject", "20"), 42)},
                device_args)
    cli_at_once({resumed: (config, (*args, "--resume"), 0)}, device_args)
    a, b = (full / "frames.jsonl").read_bytes(), (resumed / "frames.jsonl").read_bytes()
    ra = json.loads((full / "report.json").read_text())
    rb = json.loads((resumed / "report.json").read_text())
    rows = [json.loads(x) for x in a.decode().splitlines()]
    check(a == b, f"cli c2_{descriptor}: the resumed frames.jsonl differs from the "
                  f"uninterrupted one")
    check(ra["ate_rmse_m"] == rb["ate_rmse_m"] and all(r["pose_ok"] for r in rows[1:]),
          f"cli c2_{descriptor}: reports {ra} / {rb}, or a frame lost")
    print(f"cli c2_{descriptor}: killed after frame 20 (exit 42), resumed at frame 32: "
          f"frames.jsonl identical ({len(a)} bytes), ate_rmse_m={ra['ate_rmse_m']} in both; "
          f"report {json.dumps(ra)}", flush=True)


def descriptor_phase(device, results, configs: Path = ROOT / "configs", device_args=()) -> dict:
    """14: the SIFT and AKAZE options (module docstring). Returns each path's
    (matcher, Schur) launches. 14d's command line reads c2 from `configs`
    and passes `device_args` to every run."""
    import numpy as np
    from sosvo_torch.tools.reference_draws import loop_draws
    from sosvo_torch.tools.workload import load_image_preset

    c2i, c2i_run = load_image_preset("c2_chip_ba")
    c3i, c3i_run = load_image_preset("c3_host_pgo")
    descriptor_frontend_phase(c2i, c2i_run["n_frames"], device, results)           # 14a, 14b
    launches = {}
    c2a = with_descriptor(c2i, "akaze")                                            # 14c
    m, s_, *_ = image_ba_phase("c2_images_akaze_ba", c2a, c2i_run["n_frames"], "c2_akaze_ba", None,
                               device, timed_reps=1)
    launches["c2_images_akaze_ba"] = (m, s_)
    c2s = with_descriptor(c2i, "sift")                                             # 14d
    m, s_, *_ = image_ba_phase("c2_images_sift_ba", c2s, c2i_run["n_frames"], "c2_sift_ba", None,
                               device, timed_reps=1)
    launches["c2_images_sift_ba"] = (m, s_)
    descriptor_cli_phase(configs / "c2_chip_ba.json", "sift", device_args)
    c3s = with_descriptor(c3i, "sift")                                             # 14e
    m, s_, rig, poses, obs, outs, _ = image_ba_phase("c3_images_sift_ba", c3s, c3i_run["n_frames"],
                                                  "c3_sift_ba", None, device, timed_reps=0)
    launches["c3_images_sift_ba"] = (m, s_)
    kf = np.nonzero(outs.is_keyframe.cpu().numpy())[0]
    leg, m, s_, ate = pgo_phase(
        "c3_images_sift_pgo_leg", c3s, rig, poses, obs, outs.vo.T_world, kf,
        *image_ate_limit("c3_sift_pgo"), device, must_drop=False,
        gumbels=loop_draws(c3s.loop_candidates, c3s.ransac.n_hyps, c3s.frontend.max_features,
                           device))
    launches["c3_images_sift_pgo_leg"] = (m, s_)
    print(f"pgo c3_images_sift_pgo_leg: n_loops={int(leg.n_loops)} (the JAX package's "
          f"{C3_SIFT_REF_LOOPS[0]}-{C3_SIFT_REF_LOOPS[1]}); ATE after vs JAX seed 0 "
          f"{IMAGE_REF_ATE_M['c3_sift_pgo'][0]}: {ate - IMAGE_REF_ATE_M['c3_sift_pgo'][0]:+.3e}",
          flush=True)
    return launches


# The JAX package's ATE (m) of c2 as a staged 8-bit capture, on the CPU
# (scripts/ref_sequence_ate.py): seeds 0-2, then seed 0 on the sequence
# rendered with every pose shifted by +0.1, -0.1, +0.3 and -0.3 um along x
# (the render's rounding moves the ATE far more than the seed). Phase 15
# holds the port's staged c2 to the worst plus twice the spread.
SEQUENCE_REF_ATE_M = (0.014038382098078728, 0.013891639187932014, 0.013605513609945774,
                      0.014834532514214516, 0.009176318533718586, 0.014847947284579277,
                      0.008685383945703506)


def sequence_phase(device, configs: Path = ROOT / "configs", device_args=()) -> dict:
    """15: c2 as written (configs/c2_chip_ba.json: 60 frames, 768x768, K=512,
    W=5, L=512) arriving as a staged capture. The port renders the command
    line's room along its trajectory, the frames are written as 8-bit
    binary PGM files (`(clip(im, 0, 1) * 255).astype(uint8)`) with the
    trajectory as a TUM file, `tools/stage_sequence.py` stages them to
    `.npz` and `.sosq` (the staged frames must equal the quantised render
    exactly, through both), and `save_rig` writes the default rig's file.
    Then, in build/chip_smoke_sequence (gitignored):
      * `python -m sosvo_torch.cli --mode ba --sequence` with and without
        `--rig`, two processes at once: every frame tracked in both, the
        same report keys and frames. The two runs are not the same rig:
        a rig file stores elevations in degrees (the JAX package's
        schema), and read back three of default_rig's four bounds come out
        one f32 step apart, in either package; that moves panorama samples
        by rounding and keypoints and inliers across their thresholds, so
        the trajectories part by millimetres (their differences are
        printed). Each run is held bit for bit to this process's replay or
        live run on the rig it read, below;
      * in this process the command line's own path (`cli._load_sequence`,
        then `run_replay_ba` from its generator, SEED + 2) and `live_vo_ba`
        over `SosqReader` with that generator, and with the rig read from
        the file: each trajectory equal, bit for bit, to the command line
        run on the same rig; pose_ok 59/59, 15 keyframes, 70 Schur and 135
        (+ relocalisations) matcher launches in the replay and the live
        run; ATE under the JAX package's worst plus twice the spread
        (scripts/ref_sequence_ate.py);
      * `live_vo_ba` with the JAX command line's draws (`key`, PRNGKey(2))
        under `tools/sync_check.syncs_during`: host syncs per live frame,
        and its ATE against the JAX package's seed 0 (held under the limit);
      * live frames/s against the replay's (each from its file to the
        trajectory, host clock, synchronised) on the same 60 frames.
    Returns {path: (matcher launches, Schur launches)}."""
    import shutil

    import numpy as np
    import torch

    from sosvo_torch import cli as port_cli
    from sosvo_torch.data.native_loader import SosqReader
    from sosvo_torch.data.sequence import load_sequence, load_tum_trajectory, save_tum_trajectory
    from sosvo_torch.eval.ate import ate_rmse
    from sosvo_torch.kernels import match_cuda, schur_cuda
    from sosvo_torch.sensor.calib_io import load_rig, save_rig
    from sosvo_torch.sensor.rig import default_rig
    from sosvo_torch.synth.scene import make_trajectory
    from sosvo_torch.tools import stage_sequence
    from sosvo_torch.tools.reference_draws import CLI_REPLAY_SEED, prng_key
    from sosvo_torch.tools.sync_check import syncs_during
    from sosvo_torch.tools.workload import SEED, TRAJECTORY_RADIUS, render_frames
    from sosvo_torch.utils.config import load_pipeline_config
    from sosvo_torch.vo.ba_pipeline import init_ba_state, run_replay_ba
    from sosvo_torch.vo.live import live_vo_ba

    preset = configs / "c2_chip_ba.json"
    cfg = load_pipeline_config(preset)
    n = json.loads(preset.read_text())["run"]["n_frames"]
    limit = max(SEQUENCE_REF_ATE_M) + 2.0 * (max(SEQUENCE_REF_ATE_M) - min(SEQUENCE_REF_ATE_M))
    work = ROOT / "build" / "chip_smoke_sequence"
    shutil.rmtree(work, ignore_errors=True)
    capture = work / "capture"
    capture.mkdir(parents=True)

    # the capture: 8-bit PGM frames of the port's render, the trajectory as TUM
    t0 = time.perf_counter()
    rig = default_rig(device=device)
    size = rig.image_height
    images = render_frames(rig, n, range(n), device).cpu().numpy()
    quantised = (np.clip(images, 0, 1) * 255).astype(np.uint8)
    for i, im in enumerate(quantised):
        (capture / f"frame_{i:04d}.pgm").write_bytes(f"P5\n{size} {size}\n255\n".encode()
                                                     + im.tobytes())
    save_tum_trajectory(capture / "gt.txt",
                        make_trajectory(n, radius=TRAJECTORY_RADIUS, device=device).cpu().numpy())
    capture_s = time.perf_counter() - t0
    bundle, stream, rig_file = work / "c2.npz", work / "c2.sosq", work / "rig.json"
    t0 = time.perf_counter()
    check(stage_sequence.main([str(capture), str(bundle), "--gt", str(capture / "gt.txt"),
                               "--sosq", str(stream), "--size", str(size)]) == 0,
          "sequence: the stager failed")
    stage_s = time.perf_counter() - t0
    staged = quantised.astype(np.float32) / 255.0
    seq = load_sequence(bundle)
    check(seq.images.shape == (n, size, size) and np.array_equal(seq.images, staged),
          "sequence: the .npz frames differ from the quantised render")
    check(np.array_equal(seq.poses, load_tum_trajectory(capture / "gt.txt")[1]),
          "sequence: the .npz poses differ from the TUM file's")
    with SosqReader(stream) as reader:
        check(len(reader) == n and all(np.array_equal(reader.next(), staged[i]) for i in range(n)),
              "sequence: the .sosq frames differ from the quantised render")
    save_rig(rig_file, rig)
    print(f"sequence c2: {n} frames rendered on the card, written as 8-bit PGM "
          f"({capture_s:.2f} s) and staged to .npz and .sosq ({stage_s:.2f} s, host clock): "
          f"frames equal to the quantised render through both, poses to the TUM file's",
          flush=True)

    # the command line, with and without --rig, two processes at once
    runs = {"default_rig": (), "rig_file": ("--rig", str(rig_file))}
    t0 = time.perf_counter()
    done = run_children(
        {name: [sys.executable, "-m", "sosvo_torch.cli", "--config", str(preset), "--mode", "ba",
                "--sequence", str(bundle), "--out", str(work / name), *device_args, *extra]
         for name, extra in runs.items()}, timeout=600)
    for name, r in done.items():
        check(r.returncode == 0, f"sequence cli {name}: exit code {r.returncode}: "
                                 f"{r.stderr[-3000:]}")
    cli_s = time.perf_counter() - t0
    rep = {k: json.loads((work / k / "report.json").read_text()) for k in runs}
    rows = {k: [json.loads(x) for x in (work / k / "frames.jsonl").read_text().splitlines()]
            for k in runs}
    traj = {k: np.load(work / k / "ckpt" / f"traj_{n:08d}.npy") for k in runs}
    a, b = rep["default_rig"], rep["rig_file"]
    check(set(a) == set(b) and a["frames"] == b["frames"] == n and a["mode"] == "ba",
          f"sequence cli: reports {a} and {b}")
    pos_err = max(abs(x - y) for ra, rb in zip(rows["default_rig"], rows["rig_file"])
                  for x, y in zip(ra["pos"], rb["pos"]))
    counts = ("n_stereo", "n_temporal", "n_inliers")
    count_err = max(abs(ra[k] - rb[k]) for ra, rb in zip(rows["default_rig"], rows["rig_file"])
                    for k in counts)
    check(all([r["frame"] for r in rows[k]] == list(range(n)) for k in runs),
          "sequence cli: the logs' frames")
    check(all(r["pose_ok"] for k in runs for r in rows[k][1:]), "sequence cli: a frame lost")
    check(all(rep[k]["ate_rmse_m"] <= limit for k in runs),
          f"sequence cli: ATE {a['ate_rmse_m']} / {b['ate_rmse_m']} m above {limit}")
    bit_equal = (work / "default_rig" / "frames.jsonl").read_bytes() == \
        (work / "rig_file" / "frames.jsonl").read_bytes()
    print(f"sequence cli: both runs {cli_s:.1f} s (two processes at once, host clock); "
          f"--rig (the default rig's file) vs none: pose_ok on every frame in both, counts at "
          f"most {count_err} apart, frames.jsonl {'identical' if bit_equal else 'not byte-equal'}, "
          f"max position difference {pos_err:.3e} m (the file's degrees round trip), ATE "
          f"{a['ate_rmse_m']} / {b['ate_rmse_m']} m (limit {limit}); reports {json.dumps(a)} "
          f"{json.dumps(b)}", flush=True)

    # in this process: the command line's replay path, then live over the stream
    T0 = torch.from_numpy(seq.poses[0]).to(device)
    gt = torch.from_numpy(seq.poses).to(device)

    def staged_replay():
        r, _, obs = port_cli._load_sequence(str(bundle), None, cfg, device, 64)
        state = init_ba_state(cfg, torch.Generator(device=device).manual_seed(SEED + 2), T0=T0,
                              device=device)
        return run_replay_ba(r, cfg, state, obs)[1]

    def live(rig_, **kw):
        with SosqReader(stream) as reader:
            frames = (reader.next() for _ in range(len(reader)))
            outs = [o for _, o in live_vo_ba(rig_, cfg, frames, T0=T0, device=device, **kw)]
        return outs

    def counted(fn):
        match_cuda.reset_launches()
        schur_cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, (match_cuda.launches, schur_cuda.launches)

    def stacked(outs):
        return (torch.stack([o.vo.T_world for o in outs]), torch.stack([o.vo.pose_ok for o in outs]),
                torch.stack([o.is_keyframe for o in outs]), torch.stack([o.reloc_tried for o in outs]))

    replay_out, replay_m = counted(staged_replay)
    results = {"c2_staged_replay": (replay_out.vo.T_world, replay_out.vo.pose_ok,
                                    replay_out.is_keyframe, replay_out.reloc_tried)}
    launches = {"c2_staged_replay": replay_m}
    for name, rig_, key in (("c2_live_ba", rig, None),
                            ("c2_live_ba_rig_file", load_rig(rig_file, device=device), None)):
        outs, m = counted(lambda: live(rig_, generator=torch.Generator(device=device)
                                       .manual_seed(SEED + 2)))
        results[name], launches[name] = stacked(outs), m
    check(torch.equal(results["c2_staged_replay"][0], results["c2_live_ba"][0]),
          "sequence: live_vo_ba's trajectory differs from the staged replay's")
    for name, run in (("c2_staged_replay", "default_rig"), ("c2_live_ba", "default_rig"),
                      ("c2_live_ba_rig_file", "rig_file")):
        check(np.array_equal(results[name][0].cpu().numpy(), traj[run]),
              f"sequence: {name}'s trajectory differs from the command line's ({run})")
    want_kf = (n + cfg.keyframe_every - 1) // cfg.keyframe_every
    for name, (T, ok, kf, reloc) in results.items():
        n_ok, n_kf, n_reloc = int(ok[1:].sum()), int(kf.sum()), int(reloc.sum())
        m, s = launches[name]
        rmse = float(ate_rmse(T[1:, :3, 3], gt[1:, :3, 3])[0])
        check(n_ok == n - 1 and n_kf == want_kf, f"sequence {name}: pose_ok {n_ok}/{n - 1}, "
                                                 f"{n_kf} keyframes")
        check(s == (want_kf - 1) * cfg.ba.iters and m == 2 * n + n_kf + n_reloc,
              f"sequence {name}: {m} matcher and {s} Schur launches")
        check(rmse <= limit, f"sequence {name}: ATE {rmse} m above the JAX reference's {limit}")
        print(f"sequence {name}: pose_ok={n_ok}/{n - 1} keyframes={n_kf} relocalisations="
              f"{n_reloc} matcher_launches={m} schur_launches={s} ATE_m={rmse} (limit {limit}: "
              f"JAX staged c2 worst {max(SEQUENCE_REF_ATE_M)} + twice the spread)", flush=True)
    print("sequence: live_vo_ba over SosqReader = the staged replay = the command line, bit for "
          "bit, on the default rig; live on the rig file's rig = the command line with --rig",
          flush=True)

    # the JAX command line's draws, with the syncs counted
    outs, syncs = syncs_during(lambda: live(rig, key=prng_key(CLI_REPLAY_SEED)))
    T, ok, kf, _ = stacked(outs)
    rmse_jax = float(ate_rmse(T[1:, :3, 3], gt[1:, :3, 3])[0])
    check(int(ok[1:].sum()) == n - 1 and rmse_jax <= limit,
          f"sequence live with the JAX draws: pose_ok {int(ok[1:].sum())}, ATE {rmse_jax}")
    where = sorted({f"{Path(w.filename).name}:{w.lineno}" for w in syncs})
    print(f"sequence live_vo_ba, JAX draws PRNGKey(2): ATE_m={rmse_jax} (JAX seed 0 "
          f"{SEQUENCE_REF_ATE_M[0]}: {rmse_jax - SEQUENCE_REF_ATE_M[0]:+.3e}) "
          f"host_syncs={len(syncs)} per_frame={len(syncs) / n} at {where}", flush=True)

    # live frames/s against the replay's, each from its file, in turns
    times = {"replay": [], "live": []}
    for which in ("replay", "live", "live", "replay"):
        t0 = time.perf_counter()
        staged_replay() if which == "replay" else live(
            rig, generator=torch.Generator(device=device).manual_seed(SEED + 2))
        torch.cuda.synchronize()
        times[which].append(time.perf_counter() - t0)
    fps = {k: n / min(v) for k, v in times.items()}
    print(f"sequence frames_per_s (host clock, {n} frames, best of 2 in turns): live "
          f"{fps['live']} (SosqReader -> pinned upload -> image_step_ba) replay {fps['replay']} "
          f"(.npz load -> upload -> extract all -> run_replay_ba); live/replay "
          f"{fps['live'] / fps['replay']}", flush=True)
    return launches


# tests/test_calib_to_vo.py's protocol: board captures at the calibration
# resolution, VO at the runtime one, a 5 x 4 inner-corner board of 7 cm
# squares, the staged fit's iterations.
CAL_IMG, RUN_IMG = 1536, 768
CALIB_BOARD = (5, 4, 0.07)
CALIB_ITERS = 50
# The card's fit against the port's CPU fit of the same corners (absolute:
# pixels for the intrinsics, metres for the baseline, radians for
# misalignment). Each of the ~420 damped steps is decided in f32 on its
# device: on the CPU the port's fit and the JAX package's of the same 1536 px
# corners part by up to 0.070 px, 2.2e-6 m, 6.0e-5 (k1), 7.5e-6 (p2) and
# 2.7e-5 rad (scripts/ref_calib_fit.py).
CALIB_FIT_TOL = {"fx": 0.1, "fy": 0.1, "cx": 0.1, "cy": 0.1, "z_offset": 1e-5,
                 "k1": 1e-4, "k2": 1e-4, "p1": 1e-5, "p2": 1e-5, "mis_rx": 5e-5, "mis_ry": 5e-5}
# The JAX package's c2 BA ATE (m) on the sequence rendered with the truth,
# with the exact rig, its own fitted rig and the nominal prior, on the CPU
# (scripts/ref_calib_fit.py --vo): seeds 0-2, then seed 0 on renders shifted
# +0.1, -0.1, +0.3 and -0.3 um along x. Phase 16 holds each of the port's
# runs to the worst of its rows plus twice their spread. At c2's length the
# fitted rig tracks no better than the nominal prior in the JAX package, and
# 8x worse than the exact rig: tests/test_calib_to_vo.py's bound, the fitted
# ATE under max(3 x exact, 0.02 m), holds over its 6 frames, not over c2's 60.
CALIB_REF_ATE_M = {
    "exact_rig": (0.01078101247549057, 0.010783557780086994, 0.01077069528400898,
                  0.010388370603322983, 0.010587600991129875, 0.010635113343596458,
                  0.010293195955455303),
    "fitted_rig": (0.08748064935207367, 0.08789847791194916, 0.08810266852378845,
                   0.08689380437135696, 0.0874372124671936, 0.08599275350570679,
                   0.08637508749961853),
    "nominal_rig": (0.0845797061920166, 0.08450009673833847, 0.08451676368713379,
                    0.0840577781200409, 0.08404387533664703, 0.08435744792222977,
                    0.08483646810054779)}


def calib_truth_rig(device):
    """The ground-truth rig of tests/test_calib_to_vo.py at the runtime
    resolution: fx, cx, fy, cy, the baseline, distortion and misalignment of
    both views perturbed (xi stays at its design prior: the staged fit
    freezes it)."""
    import torch

    from sosvo_torch.sensor.rig import default_rig

    base = default_rig(image_size=RUN_IMG, device=device)

    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    top = base.top._replace(fx=base.top.fx * 1.02, cx=base.top.cx + 1.5, k1=t(-0.02), k2=t(1e-3),
                            p1=t(6e-4), p2=t(-4e-4), mis_rx=t(0.012), mis_ry=t(-0.009))
    bottom = base.bottom._replace(fy=base.bottom.fy * 0.98, cy=base.bottom.cy - 1.0,
                                  z_offset=base.bottom.z_offset * 1.05, k1=t(-0.01), p1=t(3e-4),
                                  mis_rx=t(-0.006), mis_ry=t(0.008))
    return base._replace(top=top, bottom=bottom)


def calib_board_poses():
    """tests/test_calib_to_vo.py's eight captures: five around the rig at
    0.55 m, alternately tilted, and three at other ranges and heights."""
    import numpy as np

    def pose(rr, zz, az, tilt=0.0):
        center = np.array([rr * np.cos(az), rr * np.sin(az), zz])
        nrm = -center / np.linalg.norm(center)
        bx = np.array([0.0, 0.0, 1.0])
        by = np.cross(nrm, bx)
        by /= np.linalg.norm(by)
        bx = np.cross(by, nrm)
        c, s = np.cos(tilt), np.sin(tilt)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.stack([-s * nrm + c * bx, by, c * nrm + s * bx], axis=1)
        T[:3, 3] = center
        return T

    return ([pose(0.55, -0.25, 2 * np.pi * i / 5, tilt=0.1 * (i % 2)) for i in range(5)]
            + [pose(0.50, -0.05, 0.7, tilt=-0.12), pose(0.60, -0.35, 1.7),
               pose(0.50, -0.15, 2.8, tilt=-0.1)])


def _fitted_terms(rig) -> dict:
    """{view.field: value} of the terms CALIB_FIT_TOL holds."""
    return {f"{v}.{f}": float(getattr(getattr(rig, v), f)) for v in ("top", "bottom")
            for f in CALIB_FIT_TOL if not (v == "top" and f == "z_offset")}


def calib_phase(device, configs: Path = ROOT / "configs", device_args=(), cal_size: int = CAL_IMG,
                breakdown_k: int = 512) -> dict:
    """16: calibrate, then run c2 with window BA on the fitted rig
    (tests/test_calib_to_vo.py's protocol at c2's widths), in
    build/chip_smoke_calib (gitignored):
      * eight chessboard captures rendered on the card at `cal_size` with
        the ground-truth rig (`calib_truth_rig`, scaled by `scale_rig`);
        corners detected from the nominal prior (`board_observations_from_
        images`: at least 6 boards kept); `fit_rig_full_gum` with
        CALIB_ITERS on the card: rms0 > 1 px (the perturbation is material)
        and rms < 3.5 px (the reference test's bound: adopted spurious
        corners set the weighted floor); the same corners fitted on the CPU
        by the port: every term within CALIB_FIT_TOL;
      * the fit rescaled to RUN_IMG by `scale_rig`, written by `save_rig`
        and read back (within an f32 step: the file's degrees), beside the
        ground-truth rig's file;
      * c2's sequence (configs/c2_chip_ba.json: 60 frames, K=512, 128x1024
        panoramas, W=5, L=512) rendered on the card with the ground-truth
        rig and written as an uncompressed `.npz` bundle in
        `data/sequence.py`'s layout; `python -m sosvo_torch.cli --mode ba
        --sequence` with `--rig` the ground-truth file, with `--rig` the
        fitted one and without `--rig` (the nominal prior), three processes
        at once: every frame tracked in each, each ATE under the JAX
        package's worst plus twice the spread for the same rig
        (CALIB_REF_ATE_M); tests/test_calib_to_vo.py's bound (the fitted
        ATE under max(3 x exact, 0.02 m)) is printed, not held: the JAX
        package itself misses it at c2's length;
      * in this process the command line's replay path on the fitted rig
        (`cli._load_sequence`, `run_replay_ba` from SEED + 2), launches
        counted: equal to the command line's trajectory bit for bit, 70
        Schur and 2 x 60 + 15 (+ relocalisations) matcher launches; its
        final map and trajectory through `export_html_viewer` and
        `save_ply` (viewer.html, map.ply);
      * `--viz` refused up front where matplotlib does not import (on a
        machine that has it, with it hidden), no output directory written;
        whether matplotlib was found is printed;
      * `phase_breakdown` at K=`breakdown_k` on the card: each stage's ms.
    Returns {"c2_ba_fitted_rig": (matcher launches, Schur launches)}."""
    import importlib.util
    import shutil
    from unittest import mock

    import numpy as np
    import torch

    from sosvo_torch import cli as port_cli
    from sosvo_torch.calib.boards import BoardObservations, fit_rig_full_gum
    from sosvo_torch.calib.corners import board_observations_from_images
    from sosvo_torch.eval.html_viewer import export_html_viewer
    from sosvo_torch.eval.viz import save_ply
    from sosvo_torch.kernels import match_cuda, schur_cuda
    from sosvo_torch.sensor.calib_io import load_rig, save_rig
    from sosvo_torch.sensor.rig import default_rig, scale_rig
    from sosvo_torch.synth.board import render_board_frame
    from sosvo_torch.synth.scene import make_trajectory
    from sosvo_torch.tools.workload import SEED, TRAJECTORY_RADIUS, render_frames
    from sosvo_torch.utils.config import load_pipeline_config
    from sosvo_torch.utils.phases import phase_breakdown
    from sosvo_torch.vo.ba_pipeline import init_ba_state, run_replay_ba

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    work = ROOT / "build" / "chip_smoke_calib"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    nx, ny, sq = CALIB_BOARD

    # calibration: captures rendered with the truth, corners, the staged fit
    t0 = time.perf_counter()
    truth = calib_truth_rig(device)
    truth_cal = scale_rig(truth, cal_size / RUN_IMG)
    captures = torch.stack([render_board_frame(truth_cal, torch.as_tensor(T, device=device),
                                               nx, ny, sq) for T in calib_board_poses()])
    sync()
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prior = default_rig(image_size=cal_size, device=device)
    obs = board_observations_from_images(prior, captures, nx, ny, sq)
    detect_s = time.perf_counter() - t0
    check(obs is not None and obs.uv_top.shape[0] >= 6,
          f"calib: the corner chain kept {0 if obs is None else obs.uv_top.shape[0]} of 8 boards")
    t0 = time.perf_counter()
    res = fit_rig_full_gum(prior, obs, iters=CALIB_ITERS)
    rms0, rms = float(res.rms0_px), float(res.rms_px)
    fit_s = time.perf_counter() - t0
    check(rms0 > 1.0 and rms < 3.5, f"calib: fit rms {rms0} -> {rms} px (need > 1, < 3.5)")
    t0 = time.perf_counter()
    res_cpu = fit_rig_full_gum(default_rig(image_size=cal_size, device="cpu"),
                               BoardObservations(*(x.cpu() for x in obs)), iters=CALIB_ITERS)
    cpu_fit_s = time.perf_counter() - t0
    card, cpu = _fitted_terms(res.rig), _fitted_terms(res_cpu.rig)
    gaps = {k: abs(card[k] - cpu[k]) for k in card}
    check(all(g <= CALIB_FIT_TOL[k.split(".")[1]] for k, g in gaps.items()),
          f"calib: the card's fit against the CPU's: {gaps}")
    truth_terms = _fitted_terms(scale_rig(truth, cal_size / RUN_IMG))
    print(f"calib: {len(captures)} captures at {cal_size} px rendered on the card "
          f"({render_s:.2f} s), corners from the nominal prior ({detect_s:.2f} s host): "
          f"{obs.uv_top.shape[0]} boards kept, {int(obs.w_top.sum())} top / "
          f"{int(obs.w_bottom.sum())} bottom corners; fit_rig_full_gum iters={CALIB_ITERS} on the "
          f"card {fit_s:.2f} s, rms {rms0} -> {rms} px (CPU fit {cpu_fit_s:.2f} s, rms "
          f"{float(res_cpu.rms_px)}); card - CPU per term {json.dumps(gaps)}; fitted - truth "
          f"{json.dumps({k: card[k] - truth_terms[k] for k in card})}", flush=True)

    # the rig files
    fitted = scale_rig(res.rig, RUN_IMG / cal_size)
    rig_files = {"exact_rig": work / "rig_truth.json", "fitted_rig": work / "rig_fitted.json"}
    save_rig(rig_files["exact_rig"], truth)
    save_rig(rig_files["fitted_rig"], fitted)
    back = load_rig(rig_files["fitted_rig"], device=device)
    for v in ("top", "bottom"):
        for f, a in getattr(fitted, v)._asdict().items():
            b = getattr(getattr(back, v), f)
            check(abs(float(a) - float(b)) <= 2e-7 * max(1.0, abs(float(a))),
                  f"calib: {v}.{f} {float(a)} read back as {float(b)}")
    check((back.image_height, back.image_width) == (RUN_IMG, RUN_IMG), "calib: the rig file's size")

    # c2 rendered with the truth, replayed by the command line on each rig
    preset = configs / "c2_chip_ba.json"
    cfg = load_pipeline_config(preset)
    n = json.loads(preset.read_text())["run"]["n_frames"]
    t0 = time.perf_counter()
    bundle = work / "c2_truth.npz"
    np.savez(bundle, images=render_frames(truth, n, range(n), device).cpu().numpy(),
             poses=make_trajectory(n, radius=TRAJECTORY_RADIUS, device=device).cpu().numpy(),
             timestamps=np.arange(n, dtype=np.float64))
    bundle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rig_args = {"exact_rig": ("--rig", str(rig_files["exact_rig"])),
                "fitted_rig": ("--rig", str(rig_files["fitted_rig"])), "nominal_rig": ()}
    done = run_children(
        {name: [sys.executable, "-m", "sosvo_torch.cli", "--config", str(preset), "--mode", "ba",
                "--sequence", str(bundle), "--out", str(work / name), *device_args, *extra]
         for name, extra in rig_args.items()}, timeout=600)
    cli_s = time.perf_counter() - t0
    for name, r in done.items():
        check(r.returncode == 0, f"calib cli {name}: exit code {r.returncode}: "
                                 f"{r.stderr[-3000:]}")
    rep = {k: json.loads((work / k / "report.json").read_text()) for k in rig_args}
    rows = {k: [json.loads(x) for x in (work / k / "frames.jsonl").read_text().splitlines()]
            for k in rig_args}
    check(all(rep[k]["frames"] == n and len(rows[k]) == n and all(r["pose_ok"] for r in rows[k][1:])
              for k in rig_args), f"calib cli: a frame lost: reports {rep}")
    ate = {k: rep[k]["ate_rmse_m"] for k in rig_args}
    limits = {k: max(v) + 2.0 * (max(v) - min(v)) for k, v in CALIB_REF_ATE_M.items()}
    check(all(ate[k] <= limits[k] for k in rig_args),
          f"calib cli: ATE {ate} m against the JAX package's limits {limits}")
    ate_exact, ate_fitted = ate["exact_rig"], ate["fitted_rig"]
    test_bound = max(3.0 * ate_exact, 0.02)
    print(f"calib c2 BA on the rendered truth: bundle {bundle_s:.2f} s; the command line on three "
          f"rigs {cli_s:.1f} s (three processes at once, host clock): pose_ok {n - 1}/{n - 1} in "
          f"each; ATE (m) {json.dumps(ate)}, limits (JAX worst + twice the spread) "
          f"{json.dumps(limits)}; tests/test_calib_to_vo.py's bound max(3 x exact, 0.02) = "
          f"{test_bound}: {'held' if ate_fitted < test_bound else 'missed'} "
          f"(fitted / exact {ate_fitted / ate_exact:.2f}; JAX package seed 0 "
          f"{CALIB_REF_ATE_M['fitted_rig'][0] / CALIB_REF_ATE_M['exact_rig'][0]:.2f}); "
          f"reports {json.dumps(rep)}", flush=True)

    # the command line's replay path on the fitted rig, launches counted
    match_cuda.reset_launches()
    schur_cuda.reset_launches()
    rig_f, gt, obs_seq = port_cli._load_sequence(str(bundle), str(rig_files["fitted_rig"]), cfg,
                                                 device, 64)
    state = init_ba_state(cfg, torch.Generator(device=device).manual_seed(SEED + 2), T0=gt[0],
                          device=device)
    final, outs = run_replay_ba(rig_f, cfg, state, obs_seq)
    sync()
    m, s_ = match_cuda.launches, schur_cuda.launches
    T = outs.vo.T_world.cpu().numpy()
    check(np.array_equal(T, np.load(work / "fitted_rig" / "ckpt" / f"traj_{n:08d}.npy")),
          "calib: the fitted-rig replay differs from the command line's")
    want_kf = (n + cfg.keyframe_every - 1) // cfg.keyframe_every
    n_ok, n_kf, n_reloc = (int(outs.vo.pose_ok[1:].sum()), int(outs.is_keyframe.sum()),
                           int(outs.reloc_tried.sum()))
    check(n_ok == n - 1 and n_kf == want_kf, f"calib replay: pose_ok {n_ok}, {n_kf} keyframes")
    check(s_ == (want_kf - 1) * cfg.ba.iters and m == 2 * n + n_kf + n_reloc,
          f"calib replay: {m} matcher and {s_} Schur launches")
    print(f"calib c2_ba_fitted_rig: the command line's replay path in this process = the command "
          f"line's trajectory bit for bit; pose_ok={n_ok}/{n - 1} keyframes={n_kf} "
          f"relocalisations={n_reloc} matcher_launches={m} schur_launches={s_}", flush=True)

    # the viewers, from the fitted-rig run
    lm, lv = final.map.lm_pos.cpu().numpy(), final.map.lm_valid.cpu().numpy()
    n_pts = save_ply(work / "map.ply", lm, valid=lv)
    html = export_html_viewer(work / "viewer.html", T, traj_gt=gt.cpu().numpy(), landmarks=lm,
                              lm_valid=lv, ate=ate_fitted, title="c2_ba_fitted_rig")
    head = (work / "map.ply").read_text().splitlines()[:3]
    check(n_pts == int(lv.sum()) > 0 and head == ["ply", "format ascii 1.0",
                                                 f"element vertex {n_pts}"],
          f"calib: map.ply holds {n_pts} of {int(lv.sum())} landmarks")
    check(f'"ate": {float(ate_fitted)}' in html.read_text(), "calib: viewer.html lacks its data")
    print(f"calib viewers: {html.relative_to(ROOT)} ({html.stat().st_size} bytes, {n} poses), "
          f"map.ply ({n_pts} landmarks)", flush=True)

    # --viz refuses up front where matplotlib does not import
    found = importlib.util.find_spec("matplotlib") is not None
    viz_out = work / "viz"
    hidden = {"matplotlib": None} if found else {}
    refused = ""
    with mock.patch.dict(sys.modules, hidden):
        try:
            port_cli.main(["--config", str(preset), "--mode", "ba", "--viz", "--out", str(viz_out),
                           *device_args])
        except ImportError as e:
            refused = str(e)
    check("matplotlib" in refused and not viz_out.exists(),
          f"calib: --viz did not refuse up front without matplotlib ({refused!r})")
    print(f"calib --viz: matplotlib {'found (hidden for the check)' if found else 'not found'} "
          f"on this machine; --viz refused before anything ran: {refused}", flush=True)

    # the c1 frame's stages on the card
    pb = phase_breakdown(k=breakdown_k, device=device)
    print(f"phase_breakdown K={breakdown_k} ({pb['device']}): "
          f"{json.dumps(pb['phases_ms'])} ms per call ({pb['note']})", flush=True)
    return {"c2_ba_fitted_rig": (m, s_)}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this test needs one card", file=sys.stderr)
        return 1
    try:
        from sosvo_torch.kernels import build, schur_cuda
        from sosvo_torch.kernels.match_cuda import match_stats_cuda
        from sosvo_torch.kernels.schur_cuda import schur_reduce_cuda
        from sosvo_torch.tools.reference_draws import loop_draws
        from sosvo_torch.tools.workload import card_info, load_image_preset, load_preset
        from sosvo_torch.vo.loop_closure import keyframe_indices
        from sosvo_torch.vo.pipeline import azimuth_of, stereo_triangulate
        from sosvo_torch.vo.state import lane
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the repository root",
              file=sys.stderr)
        return 1

    device = torch.device("cuda", 0)
    card = card_info()
    print(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    phase_s = {}
    t_phase = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        phase_s[name] = now - t_phase[0]
        t_phase[0] = now
        print(f"phase {name}: {phase_s[name]:.1f} s (host clock)", flush=True)

    # 1. build
    t0 = time.perf_counter()
    build.load()
    print(f"build: {build.library_path().relative_to(ROOT)} ready in "
          f"{time.perf_counter() - t0:.3f} s (nvcc, sm_90a)", flush=True)
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"build: ptxas {line.strip()}", flush=True)
    phase_done("1_build")
    if sys.argv[1:] == ["--descriptors-only"]:  # phase 14 alone
        descriptor_phase(device, {})
        phase_done("14_descriptors")
        if not no_descendants_left():
            return 1
        print("chip_smoke: --descriptors-only run ends here, with no result line", flush=True)
        return 0
    if sys.argv[1:] == ["--sequence-only"]:  # phase 15 alone
        sequence_phase(device)
        phase_done("15_sequence")
        if not no_descendants_left():
            return 1
        print("chip_smoke: --sequence-only run ends here, with no result line", flush=True)
        return 0
    if sys.argv[1:] == ["--calib-only"]:  # phase 16 alone
        calib_phase(device)
        phase_done("16_calib")
        if not no_descendants_left():
            return 1
        print("chip_smoke: --calib-only run ends here, with no result line", flush=True)
        return 0
    if sys.argv[1:] == ["--adaptive-only"]:  # phase 17 alone, on a workload of its own
        adaptive_phase(device)
        phase_done("17_adaptive")
        if not no_descendants_left():
            return 1
        print("chip_smoke: --adaptive-only run ends here, with no result line", flush=True)
        return 0
    if sys.argv[1:] == ["--dist-only"]:  # phases 12, 12b, 13 and 11's ranks alone
        c5_phase(device, {}, {})
        phase_done("12_c5")
        c3_long_phase(device)
        phase_done("13_c3_long")
        cli_dist_phase()
        phase_done("11_torchrun")
        if not no_descendants_left():
            return 1
        print("chip_smoke: --dist-only run ends here, with no result line", flush=True)
        return 0

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
        timed_reps=5)[0]}

    # 4. frame-to-frame replay at c3's sizes, observation mode
    print("replay c3_sizes: observation mode at c3's K, H, frames and landmarks "
          "(the preset's image pipeline runs in phase 7c)", flush=True)
    c3_f2f_m, c3_f2f_rig, c3_f2f_scene, c3_f2f_obs, c3_f2f_outs = replay_phase(
        "c3_sizes_observations", c3, c3_run["n_frames"], c3_run["n_landmarks"], 0.2, device,
        timed_reps=0)
    launches["c3_sizes_observations"] = c3_f2f_m

    # 5. the slice's main path: c2 with keyframed window BA, full width
    c2_m, c2_s, c2_rig, _, c2_obs, c2_final, _ = ba_replay_phase(
        "c2_ba_observations", c2, c2_run["n_frames"], c2_run["n_landmarks"], 0.02, device,
        timed_reps=2, vs_f2f=True)

    # 6. BA replay at c3's sizes
    c3_m, c3_s, c3_rig, c3_scene, c3_obs, c3_final, c3_outs = ba_replay_phase(
        "c3_sizes_ba_observations", c3, c3_run["n_frames"], c3_run["n_landmarks"], 0.02, device,
        timed_reps=0, vs_f2f=False)
    launches.update(c2_ba_observations=c2_m, c3_sizes_ba_observations=c3_m)

    # 6c. c3's loop-closure leg on the BA replay, over its own keyframes
    kf_ba = np.nonzero(c3_outs.is_keyframe.cpu().numpy())[0]
    leg_ba, leg_ba_m, leg_ba_s, _ = pgo_phase(
        "c3_pgo_leg_ba", c3, c3_rig, c3_scene.poses, c3_obs, c3_outs.vo.T_world, kf_ba,
        C3_PGO_REF_ATE_M["ba"], C3_PGO_MARGIN_M, device, must_drop=False)
    leg_repeats("c3_pgo_leg_ba", c3, c3_rig, c3_obs, c3_outs.vo.T_world, kf_ba, leg_ba)
    loop_match, loop_schur = loop_shape_kernels(c3, c3_rig, c3_obs, kf_ba, leg_ba, device)
    pgo_solvers(c3, leg_ba)

    # 6d. the same leg on the frame-to-frame replay of phase 4 (stride keyframes)
    kf_f2f = keyframe_indices(c3_run["n_frames"], c3.keyframe_every)
    _, leg_f2f_m, leg_f2f_s, _ = pgo_phase(
        "c3_pgo_leg_f2f", c3, c3_f2f_rig, c3_f2f_scene.poses, c3_f2f_obs, c3_f2f_outs.T_world,
        kf_f2f, C3_PGO_REF_ATE_M["f2f"], C3_PGO_MARGIN_M, device, must_drop=True)
    launches.update(c3_pgo_leg_ba=leg_ba_m, c3_pgo_leg_f2f=leg_f2f_m)

    # 6b. BA replay through a sensor dropout: relocalisation on the card
    drop_m, drop_s = ba_dropout_phase(c2, c2_run["n_landmarks"], device)
    launches["c2_ba_dropout"] = drop_m

    # 7a. the image frontend on the card against the port on the CPU
    c2i, c2i_run = load_image_preset("c2_chip_ba")
    c3i, c3i_run = load_image_preset("c3_host_pgo")
    frontend_phase(c2i, c2i_run["n_frames"], device, results)

    # 7b. c2 as written: image mode, window BA
    c2i_m, c2i_s, *_ = image_ba_phase("c2_ba_images", c2i, c2i_run["n_frames"], "c2_ba", 0.02,
                                      device, timed_reps=1)

    # 7c. c3 image-native: window BA, then the loop leg over its keyframes
    c3i_m, c3i_s, c3i_rig, c3i_poses, c3i_obs, c3i_outs, c3i_draws = image_ba_phase(
        "c3_images_ba", c3i, c3i_run["n_frames"], "c3_ba", None, device, timed_reps=0)
    kf_c3i = np.nonzero(c3i_outs.is_keyframe.cpu().numpy())[0]
    leg_c3i, leg_c3i_m, leg_c3i_s, leg_c3i_ate = pgo_phase(
        "c3_images_pgo_leg", c3i, c3i_rig, c3i_poses, c3i_obs, c3i_outs.vo.T_world, kf_c3i,
        *image_ate_limit("c3_pgo"), device, must_drop=False,
        gumbels=loop_draws(c3i.loop_candidates, c3i.ransac.n_hyps, c3i.frontend.max_features,
                           device))
    print(f"pgo c3_images_pgo_leg: pair draws=JAX split(PRNGKey(17)); ATE after vs JAX seed 0 "
          f"{IMAGE_REF_ATE_M['c3_pgo'][0]}: {leg_c3i_ate - IMAGE_REF_ATE_M['c3_pgo'][0]:+.3e}",
          flush=True)
    build_system_repeats("c3_images_pgo_leg", leg_c3i.graph)
    launches.update(c2_ba_images=c2i_m, c3_images_ba=c3i_m, c3_images_pgo_leg=leg_c3i_m)
    phase_done("2_7c")

    # 17. c3_adaptive as written on 7c's workload: adaptive keyframes govern
    # the BA window and the pose graph's nodes
    adaptive_launches = adaptive_phase(device, (c3i_rig, c3i_poses, c3i_obs, c3i_draws))
    launches.update({k: m for k, (m, _) in adaptive_launches.items()})
    phase_done("17_adaptive")

    # 8. Schur kernel against its plain version
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

    # 9. matcher at the map-association shapes (L x K)
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
    lib2048 = matcher_library_ms("2048x2048", 2048, 2048, device)

    # 10. c4 as written: S=4 lanes in lockstep, frame to frame and window BA
    c4, c4_run = load_preset("c4_batched_replay")
    c4_f2f_m, c4_f2f_s, *_ = batched_phase("f2f", c4, c4_run, device, 0, card)
    c4_ba_m, c4_ba_s, c4_rig, c4_obs, c4_final = batched_phase("ba", c4, c4_run, device, 0, card)
    launches.update(c4_batched_f2f=c4_f2f_m, c4_batched_ba=c4_ba_m)
    # both kernels at c4's shapes: lane 0's stereo match of its first frame,
    # its map against the last keyframe, and its last window
    c4_lane0, c4_obs = lane(c4_final, 0), lane(c4_obs, 0)
    f0 = c4_obs.frame(0)
    results["c4_lane0_stereo"] = compare_kernel(
        "c4_lane0_frame0_stereo_512x512", (f0.desc_top, f0.desc_bottom, f0.valid_top,
                                           f0.valid_bottom, azimuth_of(f0.ray_top),
                                           azimuth_of(f0.ray_bottom)),
        c4.frontend.stereo_band_rad, c4)
    association("c4_lane0_map_association_512x512", c4, c4_rig, c4_lane0, c4_obs,
                c4_run["n_frames"])
    schur["c4_lane0_W5_L512"] = compare_schur("c4_lane0_late_window_W5_L512",
                                              window_blocks(c4_rig, c4, c4_lane0.map), lam)

    phase_done("8_10")

    # Device events per kernel call, then phase 14, whose extractors are
    # profiled too: every profiler session of this process runs before the
    # phases that start processes of their own on the card (12, 13, 11).
    # After those, a profiler session here recorded no device events
    # (PERF.md §6).
    m_main = results["c1_512_stereo"]
    s_main = schur["c2_W5_L512"]
    m_args = main_matcher_args(c1, c1_run["n_landmarks"], device)
    m_events = device_events_per_call(
        "matcher", lambda: match_stats_cuda(*m_args, band=c1.frontend.stereo_band_rad))
    lam_t = torch.full((), lam, device=device)
    s_events = device_events_per_call("schur", lambda: schur_reduce_cuda(*c2_blocks, lam_t))
    check(m_events == 1.0 and s_events == 1.0,
          f"device events per call: matcher {m_events}, Schur {s_events}; expected 1 each")
    cluster, resident = schur_cuda.cluster_shape(device)
    clusters, _, _ = schur_cuda.schedule(5, c2.ba.max_landmarks, cluster, resident)
    print(f"device_events_per_call: matcher {m_events} Schur {s_events}; "
          f"Schur cluster size {cluster}, {resident} resident, clusters at W5/L512 {clusters}",
          flush=True)

    # 14. the SIFT and AKAZE descriptor options: extractors, the matcher on
    # AKAZE bits, c2 with each, the command line with SIFT, c3 with SIFT and its leg
    desc_launches = descriptor_phase(device, results)
    launches.update({k: m for k, (m, _) in desc_launches.items()})
    phase_done("14_descriptors")

    # 15. c2 as a staged capture: the stager, the command line's --sequence
    # and --rig, live_vo_ba over the .sosq stream
    seq_launches = sequence_phase(device)
    launches.update({k: m for k, (m, _) in seq_launches.items()})
    phase_done("15_sequence")

    # 16. calibrate from rendered board captures, then c2 window BA on the fitted rig
    calib_launches = calib_phase(device)
    seq_launches.update(calib_launches)
    launches.update({k: m for k, (m, _) in calib_launches.items()})
    phase_done("16_calib")

    # 12. c5 as written: 8 ranks on the card, every window solve landmark-sharded
    c5_m = c5_phase(device, results, schur)
    launches["c5_sharded_replay"] = c5_m["match"]
    phase_done("12_c5")

    # 13. c3_long_mesh: the loop leg over 8 ranks, then the preset as written
    c3l = c3_long_phase(device)
    launches.update(c3_long_mesh_f2f=c3l["replay"]["match"],
                    c3_long_mesh_leg_one_device=c3l["one_device_leg"]["match"],
                    c3_long_mesh_leg_sharded=c3l["sharded_leg"]["match"],
                    c3_long_mesh_ba=c3l["ba_replay"]["match"],
                    c3_long_mesh_ba_leg=c3l["ba_leg"]["match"])
    phase_done("13_c3_long")
    lib1024 = matcher_library_ms("1024x1024", 1024, 1024, device)

    # 11. the command line on the card, in processes of its own and under torchrun
    cli_phase(C4_REF_ATE_LIMIT_M)
    phase_done("11_cli")

    print(f"phase_wall_s: {json.dumps(phase_s)}", flush=True)
    if not no_descendants_left():
        return 1
    print(card, flush=True)  # name, power limit: nvidia-smi's own line
    print(json.dumps({"kernels": [
        {"name": "match_hamming", "route": "cuda",
         "source": "sosvo_torch/csrc/match_hamming.cu",
         "replaces": "sosvo/kernels/match_pallas.py:162",
         "launches": c3i_m + leg_c3i_m + c4_f2f_m + c4_ba_m + c5_m["match"]
         + c3l["sharded_leg"]["match"] + sum(m for m, _ in desc_launches.values())
         + sum(m for m, _ in seq_launches.values())
         + sum(m for m, _ in adaptive_launches.values()),
         "launches_by_path": launches,
         "max_abs_err": max(r["max_abs_err"] for r in (*results.values(), loop_match)),
         "ms": m_main["ms"], "plain_ms": m_main["plain_ms"], "bound_ms": m_main["bound_ms"],
         "bound_us": m_main["bound_ms"] * 1e3, "bound_by": m_main["bound_by"],
         "library_ms": lib512, "shape": "512x512 stereo (c1/c2 K=512, band 0.06)",
         "device_events_per_call": m_events,
         "tensor_core_route": "b1: mma.sync m16n8k256 .and.popc",
         "loop_shape": dict(loop_match, library_ms=lib2048, bound_us=loop_match["bound_ms"] * 1e3,
                            shape="2048x2048 loop pair (c3 leg, no band)"),
         "c5_shape": dict(results["c5_1024_stereo"], library_ms=lib1024,
                          bound_us=results["c5_1024_stereo"]["bound_ms"] * 1e3,
                          shape="1024x1024 stereo (c5 K=1024, band 0.06), every rank's frame"),
         "akaze_shape": dict(results["c2_akaze_stereo"], library_ms=lib512,
                             bound_us=results["c2_akaze_stereo"]["bound_ms"] * 1e3,
                             shape="512x512 stereo on AKAZE M-LDB words (c2, band 0.06)")},
        {"name": "schur_reduce", "route": "cuda",
         "source": "sosvo_torch/csrc/schur_reduce.cu",
         "replaces": "sosvo/kernels/schur_pallas.py:106",
         "launches": c3i_s + leg_c3i_s + c4_f2f_s + c4_ba_s + c5_m["schur"]
         + c3l["sharded_leg"]["schur"] + sum(s_ for _, s_ in desc_launches.values())
         + sum(s_ for _, s_ in seq_launches.values())
         + sum(s_ for _, s_ in adaptive_launches.values()),
         "launches_by_path": {"c2_ba_observations": c2_s, "c3_sizes_ba_observations": c3_s,
                              "c2_ba_dropout": drop_s, "c3_pgo_leg_ba": leg_ba_s,
                              "c3_pgo_leg_f2f": leg_f2f_s, "c2_ba_images": c2i_s,
                              "c3_images_ba": c3i_s, "c3_images_pgo_leg": leg_c3i_s,
                              "c4_batched_f2f": c4_f2f_s, "c4_batched_ba": c4_ba_s,
                              "c5_sharded_replay": c5_m["schur"],
                              "c3_long_mesh_f2f": c3l["replay"]["schur"],
                              "c3_long_mesh_leg_one_device": c3l["one_device_leg"]["schur"],
                              "c3_long_mesh_leg_sharded": c3l["sharded_leg"]["schur"],
                              "c3_long_mesh_ba": c3l["ba_replay"]["schur"],
                              "c3_long_mesh_ba_leg": c3l["ba_leg"]["schur"],
                              **{k: s_ for k, (_, s_) in desc_launches.items()},
                              **{k: s_ for k, (_, s_) in seq_launches.items()},
                              **{k: s_ for k, (_, s_) in adaptive_launches.items()}},
         "max_abs_err": max(r["max_abs_err"] for r in (*schur.values(), loop_schur)),
         "ms": s_main["ms"], "plain_ms": s_main["plain_ms"], "bound_ms": s_main["bound_ms"],
         "bound_us": s_main["bound_ms"] * 1e3, "bound_by": s_main["bound_by"],
         "library_ms": s_main["library_ms"], "shape": "W=5, L=512 (late c2 window)",
         "device_events_per_call": s_events, "cluster_size": cluster,
         "clusters_at_shape": clusters,
         "loop_shape": dict(loop_schur, bound_us=loop_schur["bound_ms"] * 1e3,
                            shape="W=2, L=2048 two-frame loop window (c3 leg)"),
         "c5_shard_shape": dict(schur["c5_shard_W8_L512"],
                                bound_us=schur["c5_shard_W8_L512"]["bound_ms"] * 1e3,
                                shape="W=8, L=512: one of 8 landmark shards of c5's W8/L4096, "
                                      "partials all-reduced")},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def no_descendants_left() -> bool:
    """True when no process this run started is still alive; else kills
    them, says so and returns False (the run then prints no result)."""
    left = kill_descendants()
    if left:
        print(f"chip_smoke: FAILED: processes left running at the end: {left} (killed)",
              file=sys.stderr, flush=True)
    return not left


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        kill_descendants()  # on every path, a failed phase's included
    sys.exit(rc)
