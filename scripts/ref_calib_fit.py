#!/usr/bin/env python
"""The JAX package's calibration chain against the port's fit, and its c2 BA
on the fitted rig, on the CPU.

    JAX_PLATFORMS=cpu python scripts/ref_calib_fit.py [--vo] [--seeds 0 1 2]
                                                     [--shifts 1e-7 -1e-7 3e-7 -3e-7]

tests/test_calib_to_vo.py's protocol, as `chip_smoke.py` phase 16 runs it:
the ground-truth rig (`chip_smoke.calib_truth_rig`: fx, cx, fy, cy, the
baseline, distortion and misalignment of both views perturbed) scaled to
1536 px, its eight board captures (`chip_smoke.calib_board_poses`) rendered
and their corners detected from the nominal prior by the JAX package,
then `fit_rig_full_gum(iters=50)` by the JAX package and by the port (on
the CPU) on those same corners. Prints one JSON line: the corner count,
both fits' rms, the port's fit minus the JAX package's per term (the
yardstick for phase 16's CALIB_FIT_TOL, the card against the CPU) and the
JAX fit minus the truth.

With `--vo`, c2 as written (configs/c2_chip_ba.json: 60 frames, K=512,
128x1024 panoramas, W=5, L=512, window BA) is rendered with the truth at
768 px and replayed by the JAX package with the exact rig, with its fitted
rig rescaled by `scale_rig`, and with the nominal prior (`default_rig`, an
uncalibrated run), seed s drawing with PRNGKey(s + 2) (seed 0 is the
command line's own). Each `--shifts` value re-renders the sequence with
every pose translated that many metres along x and replays it with the
first seed (the render's rounding moves image-mode ATE more than the seed
does: scripts/ref_descriptor_ate.py). One JSON line per (shift, rig, seed)
with the ATE and the tracked frames. Phase 16 holds the port's fitted-rig
ATE to the worst of the fitted rows plus twice their spread.
"""

import sys as _sys
from pathlib import Path as _Path
_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))

import argparse
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import (CALIB_BOARD, CALIB_ITERS, CAL_IMG, RUN_IMG, _fitted_terms,
                        calib_board_poses, calib_truth_rig)
from sosvo.calib.boards import fit_rig_full_gum
from sosvo.calib.corners import board_observations_from_images
from sosvo.eval.ate import ate_rmse
from sosvo.frontend.image_frontend import build_frontend_luts, extract_observations
from sosvo.sensor.rig import default_rig, scale_rig
from sosvo.synth.board import render_board_frame
from sosvo.synth.render import RoomScene, render_sequence
from sosvo.synth.scene import make_trajectory
from sosvo.utils.config import load_pipeline_config
from sosvo.vo.ba_pipeline import init_ba_state, run_replay_ba
from sosvo_torch.calib.boards import BoardObservations
from sosvo_torch.calib.boards import fit_rig_full_gum as port_fit_rig_full_gum
from sosvo_torch.convert import rig_from_numpy

PRESET = _Path(__file__).resolve().parents[1] / "configs" / "c2_chip_ba.json"
ROOM = RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6, texture_scale=2.0)


def jax_truth_rig():
    """`chip_smoke.calib_truth_rig` as the JAX package's rig."""
    t = calib_truth_rig(torch.device("cpu"))
    base = default_rig(image_size=RUN_IMG)

    def view(v0, v):
        return v0._replace(**{f: jnp.asarray(getattr(v, f).numpy()) for f in v0._fields})

    return base._replace(top=view(base.top, t.top), bottom=view(base.bottom, t.bottom))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vo", action="store_true",
                    help="also replay c2 on the exact, fitted and nominal rigs")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--shifts", type=float, nargs="*", default=[1e-7, -1e-7, 3e-7, -3e-7],
                    help="render shifts (m) replayed with the first seed")
    args = ap.parse_args()
    nx, ny, sq = CALIB_BOARD
    truth = jax_truth_rig()
    truth_cal = scale_rig(truth, CAL_IMG / RUN_IMG)
    render = jax.jit(lambda t: render_board_frame(truth_cal, t, nx, ny, sq))
    captures = np.stack([np.asarray(render(jnp.asarray(T))) for T in calib_board_poses()])
    prior = default_rig(image_size=CAL_IMG)
    obs = board_observations_from_images(prior, captures, nx, ny, sq)
    t0 = time.perf_counter()
    res = jax.jit(lambda: fit_rig_full_gum(prior, obs, iters=CALIB_ITERS))()
    jax_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    port = port_fit_rig_full_gum(rig_from_numpy(prior, "cpu"),
                                 BoardObservations(*(torch.as_tensor(np.array(x)) for x in obs)),
                                 iters=CALIB_ITERS)
    port_s = time.perf_counter() - t0
    ref, got = _fitted_terms(res.rig), _fitted_terms(port.rig)
    true = _fitted_terms(truth_cal)
    print(json.dumps({
        "boards_kept": int(obs.uv_top.shape[0]), "corners_top": int(np.sum(obs.w_top)),
        "corners_bottom": int(np.sum(obs.w_bottom)),
        "jax_rms0_px": float(res.rms0_px), "jax_rms_px": float(res.rms_px),
        "port_rms_px": float(port.rms_px), "jax_fit_s_with_compile": jax_s, "port_fit_s": port_s,
        "port_minus_jax": {k: got[k] - ref[k] for k in ref},
        "jax_fit_minus_truth": {k: ref[k] - true[k] for k in ref}}), flush=True)
    if not args.vo:
        return
    cfg = load_pipeline_config(PRESET)
    n = json.loads(PRESET.read_text())["run"]["n_frames"]
    poses = make_trajectory(n, radius=0.4)
    rigs = {"exact_rig": truth, "fitted_rig": scale_rig(res.rig, RUN_IMG / CAL_IMG),
            "nominal_rig": default_rig(image_size=RUN_IMG)}
    runs = {}
    for name, rig in rigs.items():  # one compilation per rig
        luts = build_frontend_luts(rig, cfg.frontend)
        runs[name] = (
            jax.jit(lambda ims, rig=rig, luts=luts: jax.lax.map(
                lambda im: extract_observations(rig, luts, cfg.frontend, im), ims)),
            jax.jit(lambda st, o, rig=rig: run_replay_ba(rig, cfg, st, o)))
    render_seq = jax.jit(lambda P: render_sequence(truth, P, ROOM))
    for shift in [0.0] + args.shifts:
        images = render_seq(poses.at[:, 0, 3].add(shift))
        for name, (extract, replay) in runs.items():
            obs_seq = extract(images)
            for seed in args.seeds if shift == 0.0 else args.seeds[:1]:
                _, outs = jax.block_until_ready(
                    replay(init_ba_state(cfg, jax.random.PRNGKey(seed + 2), T0=poses[0]), obs_seq))
                print(json.dumps({
                    "preset": PRESET.name, "rig": name, "seed": seed, "render_shift_m": shift,
                    "frames": n,
                    "ate_ba_m": float(ate_rmse(outs.vo.T_world[1:, :3, 3], poses[1:, :3, 3])[0]),
                    "pose_ok": int(np.asarray(outs.vo.pose_ok)[1:].sum())}), flush=True)


if __name__ == "__main__":
    main()
