"""The observation-mode VO pipeline (config c1): one step per frame, replayed
over a sequence (counterpart of `sosvo/vo/pipeline.py`).

Per frame: stereo match inside the azimuth band -> midpoint
triangulation -> temporal match against the previous frame -> rigid 3D-3D
RANSAC -> Huber-IRLS bearing refinement -> the lazy essential gate.

Differences from the reference, all forced by eager PyTorch:
  * `lax.scan` becomes a Python loop over frames that stacks `StepOutput`.
  * The lazy gate's `lax.cond` becomes a host `if` on the gate predicate:
    one device->host sync per frame, the first known source of device idle
    time (CUDA graphs are later work).
  * RANSAC randomness is an explicit (H, K) Gumbel matrix per RANSAC,
    drawn from the state's generator unless the caller passes `StepDraws`
    (a test passes the reference's own draws).
  * `step_full(..., defer_gate=True)` leaves the gate out and returns its
    `GateCtx`; `apply_deferred_gate` then runs it for a batch of lanes
    with one host read of every lane's predicate (the batched replay,
    `vo/batched.py`). The essential draw is made only for a lane whose
    gate runs, from that lane's generator, so each lane's random stream is
    the one its sequential replay draws.
Every match goes through `_match`, which takes the metric of the
configured descriptor family (`frontend.match.metric_params`): binary words
(BRIEF, AKAZE's M-LDB) through `sosvo_torch.kernels.match_cuda.
match_hamming`, the CUDA kernel for CUDA tensors and its plain twin on CPU;
float SIFT descriptors through the plain L2 matcher `match_l2`.

Spans (`utils/spans.py`): `step` per `step_full`, and inside it
`step.stereo`, `step.temporal`, `step.rigid` (the draw and the RANSAC),
`step.refine` and `step.gate` (the predicate's read, counted as
`sync.gate`, and the essential RANSAC when it runs, counted as
`gate.fired`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sosvo_torch.backend.refine import refine_pose_bearings
from sosvo_torch.geom.lie import geodesic_angle, mat_inv
from sosvo_torch.geometry.ransac import gumbel, ransac_essential, ransac_rigid
from sosvo_torch.geometry.triangulate import midpoint_triangulate
from sosvo_torch.frontend.match import metric_params
from sosvo_torch.kernels.match_cuda import match_metric
from sosvo_torch.sensor.model import viewpoint
from sosvo_torch.sensor.rig import OmnistereoRig
from sosvo_torch.synth.scene import FrameObservations
from sosvo_torch.utils import spans
from sosvo_torch.utils.config import PipelineConfig
from sosvo_torch.vo.state import KeyframeFeatures, StepOutput, TrackState

GATE_MAX_ANGLE = 0.15  # rad: rigid and essential rotations must agree this well


class StepDraws(NamedTuple):
    """A step's random inputs: the (H, K) Gumbel matrices of its two RANSACs
    and, for the BA replay, the (H, L) one of relocalisation's RANSAC (with a
    leading frame dim when handed to a replay)."""

    gumbel_rigid: torch.Tensor
    gumbel_ess: torch.Tensor
    gumbel_reloc: torch.Tensor | None = None

    def frame(self, f: int) -> "StepDraws":
        """The draws of frame `f` of a stacked sequence."""
        return StepDraws(*(None if x is None else x[f] for x in self))


def azimuth_of(rays: torch.Tensor) -> torch.Tensor:
    return torch.atan2(rays[..., 1], rays[..., 0])


def _match(cfg: PipelineConfig, desc_a, desc_b, valid_a, valid_b, az_a=None, az_b=None,
           band: float = 0.0):
    """A match with the configured descriptor family's metric and threshold."""
    metric, max_distance = metric_params(cfg.frontend)
    return match_metric(metric, desc_a, desc_b, valid_a, valid_b, max_distance,
                        cfg.frontend.match_ratio, az_a, az_b, band)


def stereo_triangulate(rig: OmnistereoRig, obs: FrameObservations, cfg: PipelineConfig):
    """Stereo match top vs bottom features inside the azimuth band and
    triangulate the pairs. Returns (K,) arrays indexed by top slot: point,
    descriptor, ray, azimuth, validity, matched bottom ray."""
    az_t = azimuth_of(obs.ray_top)
    az_b = azimuth_of(obs.ray_bottom)
    m = _match(cfg, obs.desc_top, obs.desc_bottom, obs.valid_top, obs.valid_bottom,
               az_a=az_t, az_b=az_b, band=cfg.frontend.stereo_band_rad)
    ray_b = obs.ray_bottom[m.idx_b]
    tri = midpoint_triangulate(obs.ray_top, ray_b, viewpoint(rig.top), viewpoint(rig.bottom),
                               min_angle=cfg.min_triangulation_angle,
                               max_range=cfg.max_range, max_gap=cfg.max_ray_gap)
    valid = m.valid & tri.valid
    return tri.points, obs.desc_top, obs.ray_top, az_t, valid, ray_b


class GateCtx(NamedTuple):
    """What the essential gate needs, detached from the step (no key: the
    essential draw is made when the gate runs)."""

    need: torch.Tensor        # () bool: this frame wants the cross-check
    prev_rays: torch.Tensor   # (K, 3)
    rays_curr: torch.Tensor   # (K, 3) temporally matched current rays
    pair_valid: torch.Tensor  # (K,)
    R_rigid: torch.Tensor     # (3, 3) refined rigid rotation to check against


def _gate_check(cfg: PipelineConfig, gumbel_ess: torch.Tensor, prev_rays, rays_curr,
                pair_valid, R_rigid):
    """(consistent, angle): the essential cross-check of the rigid rotation."""
    re, R_e, _ = ransac_essential(gumbel_ess, prev_rays, rays_curr, pair_valid,
                                  threshold=cfg.ransac.essential_threshold,
                                  min_inliers=cfg.ransac.min_inliers)
    angle = geodesic_angle(R_rigid, R_e)
    return torch.where(re.ok, angle < GATE_MAX_ANGLE, True), angle


def step_full(rig: OmnistereoRig, cfg: PipelineConfig, state: TrackState,
              obs: FrameObservations, draws: StepDraws | None = None,
              defer_gate: bool = False):
    """One VO frame -> (new_state, StepOutput, KeyframeFeatures).

    `defer_gate=True` skips the essential gate as if the frame were
    consistent and appends its `GateCtx` to the return; the caller must run
    `apply_deferred_gate` before the next step consumes the state."""
    with spans.span("step"):
        return _step_full(rig, cfg, state, obs, draws, defer_gate)


def _step_full(rig: OmnistereoRig, cfg: PipelineConfig, state: TrackState,
               obs: FrameObservations, draws: StepDraws | None, defer_gate: bool):
    k = obs.desc_top.shape[0]
    h = cfg.ransac.n_hyps
    device = obs.ray_top.device

    with spans.span("step.stereo"):
        pts, desc, rays, az, valid, ray_b = stereo_triangulate(rig, obs, cfg)
    n_stereo = torch.sum(valid, dtype=torch.int32)

    with spans.span("step.temporal"):
        tm = _match(cfg, state.prev_desc, desc, state.prev_valid, valid)
        pts_curr_m = pts[tm.idx_b]
        rays_curr_m = rays[tm.idx_b]
        pair_valid = tm.valid & state.prev_valid & valid[tm.idx_b]
    n_temporal = torch.sum(pair_valid, dtype=torch.int32)

    with spans.span("step.rigid"):
        g_rigid = gumbel(state.generator, (h, k), device) if draws is None else draws.gumbel_rigid
        rr = ransac_rigid(g_rigid, state.prev_points, pts_curr_m, pair_valid, rays_curr_m,
                          angle_threshold=cfg.ransac.rigid_angle_threshold,
                          min_inliers=cfg.ransac.min_inliers)
    with spans.span("step.refine"):
        T_cp = refine_pose_bearings(rr.model, state.prev_points, rays_curr_m,
                                    rr.inliers.to(torch.float32), iters=cfg.refine_iters)

    ess_consistent = torch.ones((), dtype=torch.bool, device=device)
    ess_angle = torch.zeros((), dtype=torch.float32, device=device)
    frac = rr.num_inliers.to(torch.float32) / torch.clamp_min(n_temporal.to(torch.float32), 1.0)
    need = (frac < cfg.lazy_gate_ratio) | ~rr.ok
    if defer_gate:
        ctx = GateCtx(need=need, prev_rays=state.prev_rays, rays_curr=rays_curr_m,
                      pair_valid=pair_valid, R_rigid=T_cp[:3, :3])
    elif cfg.use_essential_gate:
        with spans.span("step.gate"):
            # The host reads the predicate: one device->host sync per frame.
            fire = True
            if cfg.lazy_essential_gate:
                spans.count("sync.gate")
                fire = bool(need)
            if fire:
                spans.count("gate.fired")
                g_ess = gumbel(state.generator, (h, k), device) if draws is None else \
                    draws.gumbel_ess
                ess_consistent, ess_angle = _gate_check(cfg, g_ess, state.prev_rays, rays_curr_m,
                                                        pair_valid, T_cp[:3, :3])

    pose_ok = rr.ok & ess_consistent
    # On failure hold the pose (identity relative motion).
    T_cp = torch.where(pose_ok, T_cp, torch.eye(4, dtype=T_cp.dtype, device=device))
    T_world = state.T_world @ mat_inv(T_cp)

    new_state = TrackState(T_world=T_world, prev_points=pts, prev_desc=desc, prev_rays=rays,
                           prev_azimuth=az, prev_valid=valid,
                           frame_idx=state.frame_idx + 1, generator=state.generator)
    out = StepOutput(T_world=T_world, n_stereo=n_stereo, n_temporal=n_temporal,
                     n_inliers=rr.num_inliers.to(torch.int32), pose_ok=pose_ok,
                     ess_angle_err=ess_angle)
    feats = KeyframeFeatures(pts_rig=pts, desc=desc, ray_top=rays, ray_bottom=ray_b,
                             valid=valid)
    if defer_gate:
        return new_state, out, feats, ctx
    return new_state, out, feats


def apply_deferred_gate(cfg: PipelineConfig, T_world_old: torch.Tensor, new_state: TrackState,
                        out: StepOutput, ctx: GateCtx, gumbel_ess: torch.Tensor | None = None
                        ) -> tuple[TrackState, StepOutput]:
    """Run the held-back essential gate over a batch of deferred steps.

    Every input carries a leading lane axis (`T_world_old`: each lane's pose
    before the step; `new_state.generator`: a tuple of the lanes'
    generators). With the lazy gate the host reads every lane's predicate
    at once, the batch's one sync; only lanes that need the gate run it,
    and the others keep verdict True and angle 0, as the per-frame gate
    gives them. Lane s's essential draw is `gumbel_ess[s]` when given, else
    drawn from its generator, and only when its gate runs. A lane the gate
    rejects falls back to its pre-step pose, the inline path's identity
    hold."""
    n_lanes, k = ctx.rays_curr.shape[:2]
    device = ctx.need.device
    ess_ok = torch.ones((n_lanes,), dtype=torch.bool, device=device)
    ess_angle = torch.zeros((n_lanes,), dtype=torch.float32, device=device)
    run = [False] * n_lanes
    if cfg.use_essential_gate:
        run = ctx.need.tolist() if cfg.lazy_essential_gate else [True] * n_lanes
    if any(run):
        oks, angles = [], []
        for s in range(n_lanes):
            if run[s]:
                g = (gumbel(new_state.generator[s], (cfg.ransac.n_hyps, k), device)
                     if gumbel_ess is None else gumbel_ess[s])
                c, a = _gate_check(cfg, g, ctx.prev_rays[s], ctx.rays_curr[s],
                                   ctx.pair_valid[s], ctx.R_rigid[s])
            else:
                c, a = ess_ok[s], ess_angle[s]
            oks.append(c)
            angles.append(a)
        ess_ok, ess_angle = torch.stack(oks), torch.stack(angles)
    pose_ok = out.pose_ok & ess_ok
    T_world = torch.where(pose_ok[:, None, None], out.T_world, T_world_old)
    return (new_state._replace(T_world=T_world),
            out._replace(T_world=T_world, pose_ok=pose_ok, ess_angle_err=ess_angle))


def step(rig: OmnistereoRig, cfg: PipelineConfig, state: TrackState, obs: FrameObservations,
         draws: StepDraws | None = None) -> tuple[TrackState, StepOutput]:
    """One VO frame: (new_state, output)."""
    new_state, out, _ = step_full(rig, cfg, state, obs, draws)
    return new_state, out


def run_replay(rig: OmnistereoRig, cfg: PipelineConfig, state: TrackState,
               obs_seq: FrameObservations, draws: StepDraws | None = None
               ) -> tuple[TrackState, StepOutput]:
    """Replay a sequence frame by frame; outputs are stacked per frame."""
    outs = []
    for f in range(obs_seq.desc_top.shape[0]):
        d = None if draws is None else draws.frame(f)
        state, out = step(rig, cfg, state, obs_seq.frame(f), d)
        outs.append(out)
    return state, StepOutput(*(torch.stack(x) for x in zip(*outs)))
