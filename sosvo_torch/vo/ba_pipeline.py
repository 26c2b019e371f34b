"""VO with sliding-window bundle adjustment in observation mode (counterpart
of `sosvo/vo/ba_pipeline.py`, the core of config c2).

Wraps the frame-to-frame step (`sosvo_torch/vo/pipeline.py`) with the
keyframe map manager (`sosvo_torch/vo/keyframes.py`): every keyframe
associates and inserts landmarks and refines the W-keyframe window by
Schur-complement LM BA; the current pose is re-read from the refined
window. A lost frame is relocalised against the landmark map first.

The reference's three `lax.cond`s become host `if`s:
  * keyframe or not, and BA or not (>= 2 keyframes): in stride mode both
    follow from the frame and keyframe counts, which the replay loop keeps
    on the host, so they cost no device read. The adaptive trigger is a
    device predicate the host must read once a keyframe exists;
  * relocalisation: once the map has a keyframe the host reads `pose_ok`.
  Both reads are one: the trigger is computed on the frame's tracked pose
  and read with `pose_ok` in one `.tolist()`, one sync per frame beside the
  lazy gate's one in `step_full`; only a frame that relocalises reads the
  trigger again, on its new pose.
Nothing inside `insert_keyframe` or `ba_solve` reads back from the device.
The relocalisation RANSAC draws its (H, L) Gumbel matrix from the track's
generator when it runs, unless the caller passes `StepDraws.gumbel_reloc`.
The batched replay relocalises with `relocalize_lanes`: one host read of
every lane's `pose_ok`, then `try_relocalize` for the lost lanes only.
Map association and relocalisation match with the descriptor family's
metric and threshold (`frontend.match.metric_params`): Hamming for BRIEF
and AKAZE, L2 for SIFT, whose map holds float descriptors.

Spans (`utils/spans.py`): `replay` per `run_replay_ba` (its first read
counted as `sync.replay_start`) and `frame` (`frame=`) per frame in it;
`keyframe` (`frame=`) per `step_ba_post`, and inside it `keyframe.read`
(`sync.keyframe_read`), `keyframe.reloc` (`reloc.tried`, and
`sync.reloc_trigger` where a relocalised frame reads its trigger again),
`keyframe.insert` (`keyframes`) and `keyframe.window_ba`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sosvo_torch.frontend.match import metric_params
from sosvo_torch.geom.lie import geodesic_angle, mat_inv, norm
from sosvo_torch.geometry.ransac import gumbel, ransac_rigid
from sosvo_torch.sensor.rig import OmnistereoRig
from sosvo_torch.synth.scene import FrameObservations
from sosvo_torch.utils import spans
from sosvo_torch.utils.config import PipelineConfig
from sosvo_torch.utils.device import resolve
from sosvo_torch.vo.keyframes import MapState, init_map_state, insert_keyframe, run_window_ba
from sosvo_torch.vo.pipeline import StepDraws, _match, step_full
from sosvo_torch.vo.state import (KeyframeFeatures, StepOutput, TrackState, init_track_state,
                                  lane, stack_lanes)


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
    descriptor = cfg.frontend.descriptor
    return BAState(track=init_track_state(cfg.frontend.max_features, generator, T0=T0,
                                          device=device, descriptor=descriptor),
                   map=init_map_state(cfg.ba.window, cfg.ba.max_landmarks, device=device,
                                      descriptor=descriptor))


def try_relocalize(cfg: PipelineConfig, m: MapState, track: TrackState, out: StepOutput,
                   feats: KeyframeFeatures, gumbel_hl: torch.Tensor):
    """Map-based pose re-acquisition on a lost frame (the caller decides
    that it is lost).

    Matches the frame's stereo-triangulated features against the map (one
    L x K match, Hamming or L2 by descriptor family) and solves world->rig
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


def relocalize_lanes(cfg: PipelineConfig, maps: MapState, track: TrackState, out: StepOutput,
                     feats: list[KeyframeFeatures], gumbel_reloc: torch.Tensor | None = None
                     ) -> tuple[TrackState, StepOutput]:
    """Relocalise the lost lanes of a batch (leading lane axis on `maps`,
    `track`, `out`; `feats` per lane) once the maps hold a keyframe (the
    caller's decision, lane-uniform). The host reads every lane's `pose_ok`
    at once, the batch's one sync; each lost lane runs `try_relocalize`
    with `gumbel_reloc[s]` when given, else an (H, L) matrix drawn from its
    own generator then, as its sequential replay draws it."""
    lost = (~out.pose_ok).tolist()
    if not any(lost):
        return track, out
    tracks = [lane(track, s) for s in range(len(lost))]
    outs = [lane(out, s) for s in range(len(lost))]
    for s in (s for s, x in enumerate(lost) if x):
        g = gumbel(tracks[s].generator, (cfg.ransac.n_hyps, cfg.ba.max_landmarks),
                   out.pose_ok.device) if gumbel_reloc is None else gumbel_reloc[s]
        tracks[s], outs[s] = try_relocalize(cfg, lane(maps, s), tracks[s], outs[s], feats[s], g)
    return stack_lanes(tracks), stack_lanes(outs)


def _adaptive_motion(m: MapState, track: TrackState, frame: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rig's translation (m) and rotation (rad) since the last keyframe,
    and the frame gap to it: the adaptive trigger's inputs."""
    h1 = m.head.reshape(1).long()
    rel = m.kf_X.index_select(0, h1)[0] @ track.T_world      # last-rig <- now-rig
    trans = norm(rel[:3, 3])
    rot = geodesic_angle(rel[:3, :3], torch.eye(3, dtype=rel.dtype, device=rel.device))
    return trans, rot, frame - m.kf_frame.index_select(0, h1)[0]


def _adaptive_trigger(cfg: PipelineConfig, m: MapState, track: TrackState,
                      frame: int) -> torch.Tensor:
    """Motion-adaptive keyframe predicate (once the map has a keyframe):
    accumulated motion since the last keyframe crosses a translation or
    rotation threshold, or the gap reaches kf_max_gap."""
    trans, rot, gap = _adaptive_motion(m, track, frame)
    moved = (trans > cfg.kf_trans_thresh) | (rot > cfg.kf_rot_thresh)
    return (gap >= cfg.kf_min_gap) & (moved | (gap >= cfg.kf_max_gap))


def keyframe_stage(rig: OmnistereoRig, cfg: PipelineConfig, m: MapState, track: TrackState,
                   feats: KeyframeFeatures, is_kf: bool, n_kf: int, insert_fn=None, ba_fn=None
                   ) -> tuple[MapState, torch.Tensor, torch.Tensor]:
    """The keyframe stage of one lane's frame: on a keyframe, insert it and,
    once the window holds two keyframes (`n_kf`, those inserted before it),
    solve the window; the pose is re-read from the window head. Returns
    (map, T_world, BA cost, 0 when no BA ran). `insert_fn` (`insert_keyframe`'s
    signature) and `ba_fn` (MapState -> (MapState, cost)) replace the
    insertion and the window solve."""
    cost = torch.zeros((), dtype=torch.float32, device=track.T_world.device)
    if not is_kf:
        return m, track.T_world, cost
    metric, max_distance = metric_params(cfg.frontend)
    with spans.span("keyframe.insert"):
        spans.count("keyframes")
        m = (insert_fn or insert_keyframe)(m, track.T_world, feats, track.frame_idx - 1,
                                           max_new=cfg.ba.max_new,
                                           match_max_distance=max_distance,
                                           match_ratio=cfg.frontend.match_ratio, metric=metric)
    if n_kf + 1 >= 2:  # BA once the window holds two keyframes
        with spans.span("keyframe.window_ba"):
            m, cost = ba_fn(m) if ba_fn is not None else \
                run_window_ba(rig, m, iters=cfg.ba.iters, huber_delta=cfg.ba.huber_delta)
    return m, mat_inv(m.kf_X.index_select(0, m.head.reshape(1).long())[0]), cost


def step_ba_post(rig: OmnistereoRig, cfg: PipelineConfig, state: BAState, track: TrackState,
                 out: StepOutput, feats: KeyframeFeatures, frame: int, n_kf: int,
                 draws: StepDraws | None = None, ba_fn=None) -> tuple[BAState, BAStepOutput, int]:
    """Relocalisation, keyframe and window-BA stage of a frame whose
    frame-to-frame step is done. `frame` (the index of that frame) and
    `n_kf` (keyframes inserted before it) are the host's counters; `ba_fn`
    (MapState -> (MapState, cost)) replaces the window solve. Returns the
    new state, the frame's output, and the new keyframe count."""
    with spans.span("keyframe", frame=frame):
        return _step_ba_post(rig, cfg, state, track, out, feats, frame, n_kf, draws, ba_fn)


def _step_ba_post(rig: OmnistereoRig, cfg: PipelineConfig, state: BAState, track: TrackState,
                  out: StepOutput, feats: KeyframeFeatures, frame: int, n_kf: int,
                  draws: StepDraws | None, ba_fn) -> tuple[BAState, BAStepOutput, int]:
    device = track.T_world.device
    adaptive = cfg.keyframe_mode == "adaptive"
    # Once the map holds a keyframe the host reads pose_ok (relocalisation)
    # and the adaptive trigger on the tracked pose, in one read.
    ok, trigger = True, n_kf == 0
    if n_kf >= 1:
        with spans.span("keyframe.read"):
            reads = ([out.pose_ok] if cfg.relocalize else []) + \
                ([_adaptive_trigger(cfg, state.map, track, frame)] if adaptive else [])
            if reads:
                spans.count("sync.keyframe_read")
            got = torch.stack(reads).tolist() if reads else []
        ok = got[0] if cfg.relocalize else True
        trigger = adaptive and got[-1]
    tried = not ok
    if tried:
        with spans.span("keyframe.reloc"):
            spans.count("reloc.tried")
            g = draws.gumbel_reloc if draws is not None and draws.gumbel_reloc is not None else \
                gumbel(track.generator, (cfg.ransac.n_hyps, cfg.ba.max_landmarks), device)
            track, out = try_relocalize(cfg, state.map, track, out, feats, g)
            if adaptive:  # a relocalised frame decides on its new pose
                spans.count("sync.reloc_trigger")
                trigger = bool(_adaptive_trigger(cfg, state.map, track, frame))

    is_kf = trigger if adaptive else frame % cfg.keyframe_every == 0

    m, T_w, cost = keyframe_stage(rig, cfg, state.map, track, feats, is_kf, n_kf, ba_fn=ba_fn)
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
            frame: int, n_kf: int, draws: StepDraws | None = None, ba_fn=None
            ) -> tuple[BAState, BAStepOutput, int]:
    """One frame with keyframe/BA logic: (new state, output, keyframe count)."""
    track, out, feats = step_full(rig, cfg, state.track, obs, draws)
    return step_ba_post(rig, cfg, state, track, out, feats, frame, n_kf, draws, ba_fn)


def run_replay_ba(rig: OmnistereoRig, cfg: PipelineConfig, state: BAState,
                  obs_seq: FrameObservations, draws: StepDraws | None = None, ba_fn=None
                  ) -> tuple[BAState, BAStepOutput]:
    """Replay with windowed BA; outputs are stacked per frame. `ba_fn`
    (MapState -> (MapState, cost)) replaces every window solve, as the JAX
    package's `ba_fn` does (the landmark-sharded solve of
    `sosvo_torch/dist/replay_dist.py` is one)."""
    n_frames = obs_seq.desc_top.shape[0]
    with spans.span("replay"):
        spans.count("sync.replay_start")
        frame0, n_kf = torch.stack([state.track.frame_idx, state.map.n_kf]).tolist()  # one read
        outs = []
        for f in range(n_frames):
            d = None if draws is None else draws.frame(f)
            with spans.span("frame", frame=frame0 + f):
                state, out, n_kf = step_ba(rig, cfg, state, obs_seq.frame(f), frame0 + f, n_kf,
                                           d, ba_fn)
            outs.append(out)
        vo = StepOutput(*(torch.stack(x) for x in zip(*(o.vo for o in outs))))
        rest = (torch.stack(x) for x in list(zip(*outs))[1:])
        return state, BAStepOutput(vo, *rest)
