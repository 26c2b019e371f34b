"""VO with sliding-window bundle adjustment (counterpart of
`sosvo/vo/ba_pipeline.py`, the core of configs c2 and c3), over the image
frontend's observations.

Wraps the frame-to-frame step (`sosvo_torch/vo/pipeline.py`) with the
keyframe map manager (`sosvo_torch/vo/keyframes.py`): every keyframe
associates and inserts landmarks and refines the W-keyframe window by
Schur-complement LM BA; the current pose is re-read from the refined
window. A lost frame is relocalised against the landmark map first.

The reference's three `lax.cond`s become host `if`s:
  * keyframe or not, and BA or not (>= 2 keyframes): with stride keyframes,
    the only schedule here, both follow from the frame and keyframe
    counts, which the replay loop keeps on the host;
  * relocalisation: once the map has a keyframe the host reads `pose_ok`.
Nothing inside `insert_keyframe` or `ba_solve` reads back from the device.
The relocalisation RANSAC draws its (H, L) Gumbel matrix from the track's
generator when it runs, unless the caller passes `StepDraws.gumbel_reloc`.
Map association and relocalisation match with the descriptor family's
metric and threshold (`frontend.match.metric_params`): Hamming for BRIEF.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.frontend.match import metric_params
from vobench.reference.geom.lie import mat_inv
from vobench.reference.geometry.ransac import gumbel, ransac_rigid
from vobench.reference.sensor.rig import OmnistereoRig
from vobench.reference.synth.scene import FrameObservations
from vobench.reference.utils.config import PipelineConfig
from vobench.reference.utils.device import resolve
from vobench.reference.vo.keyframes import MapState, init_map_state, insert_keyframe, run_window_ba
from vobench.reference.vo.pipeline import StepDraws, _match, step_full
from vobench.reference.vo.state import KeyframeFeatures, StepOutput, TrackState, init_track_state


class BAState(NamedTuple):
    track: TrackState
    map: MapState


class BAStepOutput(NamedTuple):
    vo: StepOutput
    is_keyframe: torch.Tensor  # () bool
    ba_cost: torch.Tensor      # () f32 (0 when no BA ran)
    n_landmarks: torch.Tensor  # () int32 active landmark count
    reloc_tried: torch.Tensor  # () bool: relocalisation ran (the port's own field)


def init_ba_state(cfg: PipelineConfig, generator: torch.Generator,
                  T0: torch.Tensor | None = None,
                  device: torch.device | str | None = None) -> BAState:
    device = resolve(device)
    return BAState(track=init_track_state(cfg.frontend.max_features, generator, T0=T0,
                                          device=device),
                   map=init_map_state(cfg.ba.window, cfg.ba.max_landmarks, device=device))


def try_relocalize(cfg: PipelineConfig, m: MapState, track: TrackState, out: StepOutput,
                   feats: KeyframeFeatures, gumbel_hl: torch.Tensor):
    """Map-based pose re-acquisition on a lost frame (the caller decides
    that it is lost).

    Matches the frame's stereo-triangulated features against the map (one
    L x K Hamming match) and solves world->rig
    by 3D-3D RANSAC on the (world landmark, rig-frame triangulation) pairs
    with the (H, L) Gumbel matrix `gumbel_hl`; on success the track pose
    and the frame's pose_ok and inlier count are overwritten.
    """
    mm = _match(cfg, m.lm_desc, feats.desc, m.lm_valid, feats.valid)
    pv = mm.valid & m.lm_valid & feats.valid[mm.idx_b]
    rr = ransac_rigid(gumbel_hl, m.lm_pos, feats.pts_rig[mm.idx_b], pv,
                      feats.ray_top[mm.idx_b],
                      angle_threshold=cfg.ransac.rigid_angle_threshold,
                      min_inliers=cfg.reloc_min_inliers)
    T_new = torch.where(rr.ok, mat_inv(rr.model), track.T_world)   # model: rig-from-world
    track = track._replace(T_world=T_new)
    out = out._replace(T_world=T_new, pose_ok=out.pose_ok | rr.ok,
                       n_inliers=torch.where(rr.ok, rr.num_inliers.to(torch.int32),
                                             out.n_inliers))
    return track, out


def keyframe_stage(rig: OmnistereoRig, cfg: PipelineConfig, m: MapState, track: TrackState,
                   feats: KeyframeFeatures, is_kf: bool, n_kf: int
                   ) -> tuple[MapState, torch.Tensor, torch.Tensor]:
    """The keyframe stage of a frame: on a keyframe, insert it and, once the
    window holds two keyframes (`n_kf`, those inserted before it), solve the
    window; the pose is re-read from the window head. Returns (map, T_world,
    BA cost, 0 when no BA ran)."""
    cost = torch.zeros((), dtype=torch.float32, device=track.T_world.device)
    if not is_kf:
        return m, track.T_world, cost
    metric, max_distance = metric_params(cfg.frontend)
    m = insert_keyframe(m, track.T_world, feats, track.frame_idx - 1,
                        max_new=cfg.ba.max_new, match_max_distance=max_distance,
                        match_ratio=cfg.frontend.match_ratio, metric=metric)
    if n_kf + 1 >= 2:  # BA once the window holds two keyframes
        m, cost = run_window_ba(rig, m, iters=cfg.ba.iters, huber_delta=cfg.ba.huber_delta)
    return m, mat_inv(m.kf_X.index_select(0, m.head.reshape(1).long())[0]), cost


def step_ba_post(rig: OmnistereoRig, cfg: PipelineConfig, state: BAState, track: TrackState,
                 out: StepOutput, feats: KeyframeFeatures, frame: int, n_kf: int,
                 draws: StepDraws | None = None) -> tuple[BAState, BAStepOutput, int]:
    """Relocalisation, keyframe and window-BA stage of a frame whose
    frame-to-frame step is done. `frame` (the index of that frame) and
    `n_kf` (keyframes inserted before it) are the host's counters. Returns
    the new state, the frame's output, and the new keyframe count."""
    if cfg.keyframe_mode != "stride":
        raise ValueError(f"the reference keys frames by stride only, not {cfg.keyframe_mode!r}")
    device = track.T_world.device
    # Once the map holds a keyframe the host reads pose_ok (relocalisation).
    ok = True
    if n_kf >= 1 and cfg.relocalize:
        ok = bool(out.pose_ok)
    tried = not ok
    if tried:
        g = draws.gumbel_reloc if draws is not None and draws.gumbel_reloc is not None else \
            gumbel(track.generator, (cfg.ransac.n_hyps, cfg.ba.max_landmarks), device)
        track, out = try_relocalize(cfg, state.map, track, out, feats, g)

    is_kf = frame % cfg.keyframe_every == 0

    m, T_w, cost = keyframe_stage(rig, cfg, state.map, track, feats, is_kf, n_kf)
    track = track._replace(T_world=T_w)
    out2 = BAStepOutput(
        vo=out._replace(T_world=T_w),
        is_keyframe=torch.full((), is_kf, dtype=torch.bool, device=device),
        ba_cost=cost,
        n_landmarks=torch.sum(m.lm_valid, dtype=torch.int32),
        reloc_tried=torch.full((), tried, dtype=torch.bool, device=device),
    )
    return BAState(track=track, map=m), out2, n_kf + int(is_kf)


def step_ba(rig: OmnistereoRig, cfg: PipelineConfig, state: BAState, obs: FrameObservations,
            frame: int, n_kf: int, draws: StepDraws | None = None
            ) -> tuple[BAState, BAStepOutput, int]:
    """One frame with keyframe/BA logic: (new state, output, keyframe count)."""
    track, out, feats = step_full(rig, cfg, state.track, obs, draws)
    return step_ba_post(rig, cfg, state, track, out, feats, frame, n_kf, draws)


def run_replay_ba(rig: OmnistereoRig, cfg: PipelineConfig, state: BAState,
                  obs_seq: FrameObservations, draws: StepDraws | None = None
                  ) -> tuple[BAState, BAStepOutput]:
    """Replay with windowed BA; outputs are stacked per frame, each frame's
    draws `draws.frame(f)` where given."""
    frame0, n_kf = torch.stack([state.track.frame_idx, state.map.n_kf]).tolist()  # one read
    outs = []
    for f in range(obs_seq.desc_top.shape[0]):
        d = None if draws is None else draws.frame(f)
        state, out, n_kf = step_ba(rig, cfg, state, obs_seq.frame(f), frame0 + f, n_kf, d)
        outs.append(out)
    vo = StepOutput(*(torch.stack(x) for x in zip(*(o.vo for o in outs))))
    rest = (torch.stack(x) for x in list(zip(*outs))[1:])
    return state, BAStepOutput(vo, *rest)
