#!/usr/bin/env python
"""The JAX package's figures for configs/c3_adaptive.json, on the CPU.

    JAX_PLATFORMS=cpu python scripts/ref_c3_adaptive_ate.py [--seeds 0 1 2]
                                                           [--shifts 1e-7 -1e-7 3e-7 -3e-7]

The preset runs as `sosvo/cli.py` runs it in image mode with `--mode ba`:
the command line's room and trajectory rendered at 768x768 and extracted in
chunks of 64 (`scripts/ref_image_ate.py`'s helpers), the window-BA replay
with motion-adaptive keyframes (translation 0.04 m, rotation 0.08 rad, gaps
2 to 8), then the loop leg over the scan's own keyframes, `nonzero(
is_keyframe)`, with the preset's 160 candidates, 300 inliers and DCS 0.1,
min_gap 3, 10 iterations. Seed s seeds the replay's RANSAC draws with
PRNGKey(s + 2), so seed 0 is the command line's own run. Each `--shifts`
value re-renders the sequence with every pose translated that many metres
along x and replays it with the first seed: the render's rounding moves the
image presets' ATE far more than the seed does
(`scripts/ref_descriptor_ate.py`).

Beside the replay the command line runs, the script replays once more with
a scan body of its own that calls the same `step_full` and `step_ba_post`
and also records, per frame, whether relocalisation was needed (pose lost
once the map holds a keyframe) and the trigger's inputs: translation and
rotation since the last keyframe, and the gap. The two replays must agree
on every keyframe flag and pose_ok (checked; the largest pose difference is
printed). From those inputs each row gives the smallest distance of a
motion-decided frame (gap within [kf_min_gap, kf_max_gap)) to the
threshold that decided it.

Prints one JSON line per (shift, seed): the keyframe count and indices,
whether they differ from the stride-4 set of configs/c3_host_pgo.json, the
relocalisation count, pose_ok over frames 1..F-1, the loops closed, the ATE
before and after the leg, and the margins. The last line gives the limits
`chip_smoke.py` phases 17 and 11 hold the port to: the worst row plus twice
the rows' spread, for the ATE before and after the leg.
"""

import sys as _sys
from pathlib import Path as _Path
_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))
_sys.path.insert(0, str(_Path(__file__).resolve().parent))

import argparse
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from ref_image_ate import CONFIGS, extract_sequence

from sosvo.eval.ate import ate_rmse
from sosvo.geom.lie import geodesic_angle
from sosvo.sensor.rig import default_rig
from sosvo.synth.scene import make_trajectory
from sosvo.utils.config import load_pipeline_config
from sosvo.vo.ba_pipeline import init_ba_state, run_replay_ba, step_ba_post
from sosvo.vo.loop_closure import keyframe_indices, pgo_refine_trajectory
from sosvo.vo.pipeline import step_full

PRESET = "c3_adaptive.json"
STRIDE = 4  # configs/c3_host_pgo.json's keyframe_every


def instrumented_replay(rig, cfg, state, obs):
    """`run_replay_ba`'s scan with the relocalisation predicate and the
    trigger's inputs recorded per frame: (outputs, need_reloc, motion (F, 2)
    translation and rotation, gap (F,))."""
    def body(s, o):
        track, out, feats = step_full(rig, cfg, s.track, o)
        need = (~out.pose_ok) & (s.map.n_kf >= 1)
        rel = s.map.kf_X[s.map.head] @ track.T_world
        motion = jnp.stack([jnp.linalg.norm(rel[:3, 3]),
                            geodesic_angle(rel[:3, :3], jnp.eye(3, dtype=rel.dtype))])
        gap = track.frame_idx - 1 - s.map.kf_frame[s.map.head]
        s2, out2 = step_ba_post(rig, cfg, s, track, out, feats)
        return s2, (out2, need, motion, gap)

    return jax.lax.scan(body, state, obs)[1]


def margins(cfg, is_kf, motion, gap):
    """Smallest distance to a threshold among motion-decided frames: for a
    keyframe the larger of its two overshoots (the crossing that decided
    it), for a frame that stayed a non-keyframe the smaller of its two
    shortfalls. Returns (translation-or-rotation margin, frame, kind)."""
    best = (float("inf"), -1, "")
    thr = np.array([cfg.kf_trans_thresh, cfg.kf_rot_thresh])
    for f in range(1, len(is_kf)):
        if not cfg.kf_min_gap <= gap[f] < cfg.kf_max_gap:
            continue
        d = motion[f] - thr
        m = float(d.max()) if is_kf[f] else float(-d.max())
        if m < best[0]:
            best = (m, f, "crossed" if is_kf[f] else "stayed below")
    return best


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--shifts", type=float, nargs="*", default=[1e-7, -1e-7, 3e-7, -3e-7],
                    help="render shifts (m) replayed with the first seed")
    args = ap.parse_args()
    rig = default_rig()
    path = CONFIGS / PRESET
    cfg = load_pipeline_config(path)
    run = json.loads(path.read_text())["run"]
    n_frames = run["n_frames"]
    poses = make_trajectory(n_frames, radius=0.4)
    gt = poses[1:, :3, 3]
    stride = keyframe_indices(n_frames, STRIDE)
    replay = jax.jit(lambda s, o: run_replay_ba(rig, cfg, s, o))
    probe = jax.jit(lambda s, o: instrumented_replay(rig, cfg, s, o))
    rows = []
    for shift, seed in [(0.0, s) for s in args.seeds] + [(x, args.seeds[0]) for x in args.shifts]:
        if seed == args.seeds[0]:  # a new rendering
            t0 = time.perf_counter()
            obs = jax.block_until_ready(extract_sequence(
                rig, cfg, poses.at[:, 0, 3].add(shift), int(run.get("render_chunk", 64))))
            extract_s = time.perf_counter() - t0
        state0 = init_ba_state(cfg, jax.random.PRNGKey(seed + 2), T0=poses[0])
        t0 = time.perf_counter()
        _, outs = jax.block_until_ready(replay(state0, obs))
        replay_s = time.perf_counter() - t0
        T_vo = outs.vo.T_world
        is_kf = np.asarray(outs.is_keyframe)
        kf_idx = np.nonzero(is_kf)[0]
        p_outs, need, motion, gap = jax.block_until_ready(probe(state0, obs))
        same = (np.array_equal(np.asarray(p_outs.is_keyframe), is_kf)
                and np.array_equal(np.asarray(p_outs.vo.pose_ok), np.asarray(outs.vo.pose_ok)))
        if not same:
            raise SystemExit(f"seed {seed} shift {shift}: the instrumented replay's keyframes "
                             f"or pose_ok differ from run_replay_ba's")
        margin, margin_frame, margin_kind = margins(cfg, is_kf, np.asarray(motion),
                                                    np.asarray(gap))
        t0 = time.perf_counter()
        T_pgo, n_loops = pgo_refine_trajectory(
            rig, cfg, obs, T_vo, min_gap=3, min_inliers=cfg.loop_min_inliers,
            max_candidates=cfg.loop_candidates or None, robust=cfg.pgo_robust,
            robust_delta=cfg.pgo_robust_delta, kf_idx=kf_idx)
        T_pgo = jax.block_until_ready(T_pgo)
        row = {"preset": PRESET, "seed": seed, "render_shift_m": shift,
               "platform": jax.devices()[0].platform, "frames": n_frames,
               "K": cfg.frontend.max_features,
               "keyframes": len(kf_idx), "keyframe_indices": kf_idx.tolist(),
               "differs_from_stride4": not np.array_equal(kf_idx, stride),
               "relocalisations": int(np.asarray(need).sum()),
               "pose_ok": int(np.asarray(outs.vo.pose_ok)[1:].sum()),
               "n_loops": int(n_loops),
               "ate_ba_m": float(ate_rmse(T_vo[1:, :3, 3], gt)[0]),
               "ate_after_pgo_m": float(ate_rmse(T_pgo[1:, :3, 3], gt)[0]),
               "threshold_margin": margin, "threshold_margin_frame": margin_frame,
               "threshold_margin_kind": margin_kind,
               "instrumented_vs_replay_max_abs_pose_diff":
                   float(jnp.max(jnp.abs(p_outs.vo.T_world - T_vo))),
               "extract_s_with_compile": extract_s, "replay_s_with_compile": replay_s,
               "leg_s_with_compile": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    limits = {}
    for key in ("ate_ba_m", "ate_after_pgo_m"):
        v = [r[key] for r in rows]
        limits[key] = max(v) + 2.0 * (max(v) - min(v))
    print(json.dumps({"preset": PRESET, "rows": len(rows),
                      "limit_ate_ba_m": limits["ate_ba_m"],
                      "limit_ate_after_pgo_m": limits["ate_after_pgo_m"],
                      "rule": "worst row + 2 x (worst - best)"}), flush=True)


if __name__ == "__main__":
    main()
