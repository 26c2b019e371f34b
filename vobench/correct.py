"""Whether what the timed path produced is correct: the reference's run and
the comparison.

Once the window has closed, the frozen plain reference (`reference/`)
replays the same frames with the same random streams from the same first
pose on the card: it builds its own lookup tables, extracts its own
observations, runs its own per-frame step and keyframed window BA with the
plain matcher and Schur reduction, and, where the cell has a loop leg,
closes loops over its own keyframes. It draws from generators seeded as
the program's were (`inputs.generators`), or, where the traffic's driver
makes its draws from the run's key, takes the same draws made from the key. Every pass or session the program
ran in the window is then held to it:

  pos_gap_m      the widest gap between a frame's position in the program's
                 trajectory and in the reference's (frames of every pass)
  pose_ok_diff   frames whose pose_ok differs from the reference's
  leg_pos_gap_m  the same gap after the loop leg (corrected trajectories)
  loops_diff     the most by which a pass's accepted loop count differs

A cell compares the numbers its limits file (`vobench/limits/<cell>.json`)
names, each against its own limit; `ate_m`, the reference's and the
program's ATE against the ground truth, is printed beside them.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple

import numpy as np
import torch

from vobench import inputs as inputs_mod
from vobench.reference.eval.ate import ate_rmse
from vobench.reference.frontend.image_frontend import build_frontend_luts, extract_sequence
from vobench.reference.sensor.rig import default_rig
from vobench.reference.utils.config import load_pipeline_config
from vobench.reference.vo.ba_pipeline import init_ba_state, run_replay_ba
from vobench.reference.vo.loop_closure import close_loops


class RefOut(NamedTuple):
    T_world: torch.Tensor
    pose_ok: torch.Tensor
    T_corrected: torch.Tensor | None
    n_loops: torch.Tensor | None


@contextmanager
def tf32(on: bool):
    """TF32 for float32 matrix products and convolutions while inside."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def reference_run(config_path, config: dict, inputs, device, draws=None, leg: bool = True,
                  control: bool = False) -> RefOut:
    """The reference over the run's inputs, drawing from the run's
    generators unless stacked `draws` are given, with the loop leg where
    `leg` and the configuration has a pose graph. `control` computes it one
    precision below the configuration's: TF32 products for float32."""
    if control and config["precision"] != "float32":
        raise ValueError(f"no control below {config['precision']!r}: only float32's, TF32")
    cfg = load_pipeline_config(config_path)
    rig = default_rig(image_size=config["assumed"]["rig"]["image_size"],
                      baseline=config["assumed"]["rig"]["baseline"], device=device)
    state_gen, loop_gen = inputs_mod.generators(inputs.seed, device)
    with tf32(control), torch.no_grad():
        luts = build_frontend_luts(rig, cfg.frontend)
        obs = extract_sequence(rig, luts, cfg.frontend, inputs.images.to(device))
        state = init_ba_state(cfg, state_gen, T0=inputs.poses[0].to(device), device=device)
        _, out = run_replay_ba(rig, cfg, state, obs, draws)
        T, ok = out.vo.T_world, out.vo.pose_ok
        if not (leg and config["pipeline"].get("pose_graph")):
            return RefOut(T, ok, None, None)
        leg = config["loop_leg"]
        kf_idx = torch.nonzero(out.is_keyframe).flatten().cpu().numpy()
        lc = close_loops(rig, cfg, obs, T, kf_idx, min_gap=leg["min_gap"],
                         min_inliers=cfg.loop_min_inliers, iters=leg["iters"],
                         max_candidates=cfg.loop_candidates, robust=cfg.pgo_robust,
                         robust_delta=cfg.pgo_robust_delta, generator=loop_gen)
        return RefOut(T, ok, lc.T_corrected, lc.n_loops)


def _pos_gap(T: torch.Tensor, T_ref: torch.Tensor) -> float:
    n = T.shape[0]
    d = T[:, :3, 3].double() - T_ref[:n, :3, 3].double().to(T.device)
    return float(torch.linalg.vector_norm(d, dim=-1).max()) if n else 0.0


def readings(outputs, ref: RefOut) -> dict[str, float]:
    """The compared numbers of every pass or session against the reference."""
    r = {"pos_gap_m": 0.0, "pose_ok_diff": 0}
    for o in outputs:
        n = o.T_world.shape[0]
        r["pos_gap_m"] = max(r["pos_gap_m"], _pos_gap(o.T_world, ref.T_world))
        r["pose_ok_diff"] += int((o.pose_ok.cpu() != ref.pose_ok[:n].cpu()).sum())
        if ref.T_corrected is not None and o.T_corrected is not None:
            r["leg_pos_gap_m"] = max(r.get("leg_pos_gap_m", 0.0),
                                     _pos_gap(o.T_corrected, ref.T_corrected))
            r["loops_diff"] = max(r.get("loops_diff", 0),
                                  abs(int(o.n_loops) - int(ref.n_loops)))
    return r


def ate_m(T: torch.Tensor, poses: torch.Tensor) -> float:
    """ATE RMSE (m) of frames 1.. against the ground truth."""
    n = T.shape[0]
    rmse, _ = ate_rmse(T[1:, :3, 3].double().cpu(), poses[1:n, :3, 3].double().cpu())
    return float(rmse)


def judge(values: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers the limits
    name; a number the run could not read fails."""
    checks, ok = {}, True
    for name, spec in limits.items():
        v = values.get(name)
        lim = spec["limit"]
        checks[name] = {"value": v, "limit": lim}
        if v is None or not np.isfinite(v) or v > lim:
            ok = False
    return ok, checks
