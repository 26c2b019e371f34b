"""The per-frame VO step (counterpart of `sosvo/vo/pipeline.py`), which the
keyframed replay (`vo/ba_pipeline.py`) runs on every frame.

Per frame: stereo match inside the azimuth band -> midpoint
triangulation -> temporal match against the previous frame -> rigid 3D-3D
RANSAC -> Huber-IRLS bearing refinement -> the lazy essential gate.

Differences from the reference, all forced by eager PyTorch:
  * The lazy gate's `lax.cond` becomes a host `if` on the gate predicate:
    one device->host sync per frame, the first known source of device idle
    time (CUDA graphs are later work).
  * RANSAC randomness is an explicit (H, K) Gumbel matrix per RANSAC,
    drawn from the state's generator when the step needs it, unless the
    caller passes `StepDraws`.
Every match goes through `_match`, which takes the metric of the
configured descriptor family (`frontend.match.metric_params`): BRIEF's
Hamming words through the plain matcher of `reference/kernels.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.backend.refine import refine_pose_bearings
from vobench.reference.geom.lie import geodesic_angle, mat_inv
from vobench.reference.geometry.ransac import gumbel, ransac_essential, ransac_rigid
from vobench.reference.geometry.triangulate import midpoint_triangulate
from vobench.reference.frontend.match import metric_params
from vobench.reference.kernels import match_metric
from vobench.reference.sensor.model import viewpoint
from vobench.reference.sensor.rig import OmnistereoRig
from vobench.reference.synth.scene import FrameObservations
from vobench.reference.utils.config import PipelineConfig
from vobench.reference.vo.state import KeyframeFeatures, StepOutput, TrackState

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


def _gate_check(cfg: PipelineConfig, gumbel_ess: torch.Tensor, prev_rays, rays_curr,
                pair_valid, R_rigid):
    """(consistent, angle): the essential cross-check of the rigid rotation."""
    re, R_e, _ = ransac_essential(gumbel_ess, prev_rays, rays_curr, pair_valid,
                                  threshold=cfg.ransac.essential_threshold,
                                  min_inliers=cfg.ransac.min_inliers)
    angle = geodesic_angle(R_rigid, R_e)
    return torch.where(re.ok, angle < GATE_MAX_ANGLE, True), angle


def step_full(rig: OmnistereoRig, cfg: PipelineConfig, state: TrackState,
              obs: FrameObservations, draws: StepDraws | None = None):
    """One VO frame -> (new_state, StepOutput, KeyframeFeatures)."""
    k = obs.desc_top.shape[0]
    h = cfg.ransac.n_hyps
    device = obs.ray_top.device

    pts, desc, rays, az, valid, ray_b = stereo_triangulate(rig, obs, cfg)
    n_stereo = torch.sum(valid, dtype=torch.int32)

    tm = _match(cfg, state.prev_desc, desc, state.prev_valid, valid)
    pts_curr_m = pts[tm.idx_b]
    rays_curr_m = rays[tm.idx_b]
    pair_valid = tm.valid & state.prev_valid & valid[tm.idx_b]
    n_temporal = torch.sum(pair_valid, dtype=torch.int32)

    g_rigid = gumbel(state.generator, (h, k), device) if draws is None else draws.gumbel_rigid
    rr = ransac_rigid(g_rigid, state.prev_points, pts_curr_m, pair_valid, rays_curr_m,
                      angle_threshold=cfg.ransac.rigid_angle_threshold,
                      min_inliers=cfg.ransac.min_inliers)
    T_cp = refine_pose_bearings(rr.model, state.prev_points, rays_curr_m,
                                rr.inliers.to(torch.float32), iters=cfg.refine_iters)

    ess_consistent = torch.ones((), dtype=torch.bool, device=device)
    ess_angle = torch.zeros((), dtype=torch.float32, device=device)
    frac = rr.num_inliers.to(torch.float32) / torch.clamp_min(n_temporal.to(torch.float32), 1.0)
    need = (frac < cfg.lazy_gate_ratio) | ~rr.ok
    if cfg.use_essential_gate:
        # The host reads the predicate: one device->host sync per frame.
        if not cfg.lazy_essential_gate or bool(need):
            g_ess = gumbel(state.generator, (h, k), device) if draws is None else draws.gumbel_ess
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
    return new_state, out, feats

