"""Sliding keyframe window + landmark map, fixed shapes, ring-buffered
(counterpart of `sosvo/vo/keyframes.py`).

W keyframe slots in a ring buffer (ring index `head`), L landmark slots
(world position, descriptor, staleness) evicted oldest-first when full, and
a dense (W, L, 2) observation grid that IS the `BAWindow` layout.

Every update is a fixed-shape scatter on the device. `head` and `n_kf` stay
0-dim device tensors, and slots they name are written with `index_copy` /
`index_fill` on a one-element index, never by indexing with a 0-dim tensor
(which reads the index back to the host). Two places where the reference's
semantics are kept on purpose:
  * `lax.top_k` returns the lower index first among equal scores (many
    -inf candidate scores, STALE_BIG for every empty slot): a stable
    descending sort does the same, `torch.topk` promises no order;
  * the "claimed" scatter has duplicate indices: `scatter_reduce("amax")`,
    as `.at[].max()`, not an indexed assignment.
The map association is an L x K match with the caller's metric
(`frontend.match.metric_params`), through the plain matcher of
`reference/kernels.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.backend.ba import BAWindow, ba_solve
from vobench.reference.geom.lie import mat_inv, transform_points
from vobench.reference.kernels import match_metric
from vobench.reference.sensor.model import viewpoint
from vobench.reference.sensor.rig import OmnistereoRig
from vobench.reference.utils.device import resolve
from vobench.reference.vo.state import KeyframeFeatures, desc_zeros

STALE_BIG = 1e6


class MapState(NamedTuple):
    """Keyframe window + landmark map (fixed-shape tensors on one device)."""

    kf_X: torch.Tensor          # (W, 4, 4) rig-from-world per keyframe slot
    kf_valid: torch.Tensor      # (W,) bool
    kf_frame: torch.Tensor      # (W,) int32 frame index of the keyframe
    head: torch.Tensor          # () int32 most recent keyframe slot
    n_kf: torch.Tensor          # () int32 number of keyframes inserted so far
    lm_pos: torch.Tensor        # (L, 3) world-frame landmark positions
    lm_desc: torch.Tensor       # (L, DESC_WORDS) int32 bit patterns
    lm_valid: torch.Tensor      # (L,) bool
    lm_last_seen: torch.Tensor  # (L,) int32 keyframe counter of last observation
    obs_rays: torch.Tensor      # (W, L, 2, 3) observed unit bearings per view
    obs_w: torch.Tensor         # (W, L, 2) observation weights (0 = none)


def init_map_state(window: int, max_landmarks: int,
                   device: torch.device | str | None = None) -> MapState:
    device = resolve(device)
    W, L = window, max_landmarks
    f32, i32 = torch.float32, torch.int32
    return MapState(
        kf_X=torch.eye(4, dtype=f32, device=device).repeat(W, 1, 1),
        kf_valid=torch.zeros((W,), dtype=torch.bool, device=device),
        kf_frame=torch.full((W,), -1, dtype=i32, device=device),
        head=torch.full((), -1, dtype=i32, device=device),
        n_kf=torch.zeros((), dtype=i32, device=device),
        lm_pos=torch.zeros((L, 3), dtype=f32, device=device),
        lm_desc=desc_zeros(L, device),
        lm_valid=torch.zeros((L,), dtype=torch.bool, device=device),
        lm_last_seen=torch.full((L,), -(10**6), dtype=i32, device=device),
        obs_rays=torch.zeros((W, L, 2, 3), dtype=f32, device=device),
        obs_w=torch.zeros((W, L, 2), dtype=f32, device=device),
    )


def _top(scores: torch.Tensor, k: int):
    """`lax.top_k`: the k largest, the lower index first among equals."""
    s = torch.sort(scores, descending=True, stable=True)
    return s.values[:k], s.indices[:k]


def insert_keyframe(m: MapState, T_world: torch.Tensor, feats: KeyframeFeatures,
                    frame_idx: torch.Tensor, max_new: int, match_max_distance: float = 80.0,
                    match_ratio: float = 0.9, metric: str = "hamming") -> MapState:
    """Add a keyframe: associate map landmarks, insert new ones, record obs.
    `metric` and `match_max_distance` are the descriptor family's
    (`frontend.match.metric_params`)."""
    W = m.kf_X.shape[0]
    L = m.lm_pos.shape[0]
    new_head = torch.remainder(m.head + 1, W)
    h1 = new_head.reshape(1).long()         # the slot, as a one-element index
    kf_counter = m.n_kf                     # monotone per-keyframe counter

    # --- clear the reused keyframe slot ---
    obs_w = m.obs_w.index_fill(0, h1, 0.0)
    obs_rays = m.obs_rays.index_fill(0, h1, 0.0)
    kf_X = m.kf_X.index_copy(0, h1, mat_inv(T_world)[None])
    kf_valid = m.kf_valid.index_fill(0, h1, True)
    kf_frame = m.kf_frame.index_copy(0, h1, frame_idx.reshape(1).to(torch.int32))

    # --- data association: map landmarks -> current features (L x K) ---
    mm = match_metric(metric, m.lm_desc, feats.desc, m.lm_valid, feats.valid,
                      max_distance=match_max_distance, ratio=match_ratio)
    assoc = mm.valid                        # (L,) landmark l matched feature idx_b[l]
    f_of_l = mm.idx_b

    zero = torch.zeros((), dtype=torch.float32, device=assoc.device)
    rays_l = torch.stack([feats.ray_top[f_of_l], feats.ray_bottom[f_of_l]], dim=1)  # (L, 2, 3)
    obs_rays = obs_rays.index_copy(0, h1, torch.where(assoc[:, None, None], rays_l, zero)[None])
    obs_w = obs_w.index_copy(0, h1, torch.where(assoc[:, None], 1.0, zero).expand(L, 2)[None])
    lm_last_seen = torch.where(assoc, kf_counter, m.lm_last_seen)

    # --- insert new landmarks into free/stale slots ---
    # Features not claimed by any landmark (duplicate indices: a max-scatter).
    k = feats.valid.shape[0]
    claimed = torch.zeros((k,), dtype=torch.int32, device=assoc.device).scatter_reduce(
        0, f_of_l, assoc.to(torch.int32), "amax") > 0
    depth2 = torch.sum(feats.pts_rig * feats.pts_rig, dim=-1)
    cand_score = torch.where(feats.valid & ~claimed, 1.0 / (1.0 + depth2), -torch.inf)
    cand_val, f_sel = _top(cand_score, max_new)           # best new features
    # Slot priority: invalid slots first, then stalest.
    staleness = kf_counter - m.lm_last_seen
    slot_score = torch.where(m.lm_valid, staleness.to(torch.float32), STALE_BIG)
    _, s_sel = _top(slot_score, max_new)
    # Only overwrite ACTIVE slots if they are stale beyond the window.
    evictable = ~m.lm_valid[s_sel] | (staleness[s_sel] >= W)
    write = (cand_val > 0.0) & evictable                  # (max_new,)

    pts_world = transform_points(T_world, feats.pts_rig[f_sel])   # (max_new, 3)
    w3 = write[:, None]
    lm_pos = m.lm_pos.index_copy(0, s_sel, torch.where(w3, pts_world, m.lm_pos[s_sel]))
    lm_desc = m.lm_desc.index_copy(0, s_sel, torch.where(w3, feats.desc[f_sel], m.lm_desc[s_sel]))
    lm_valid = m.lm_valid.index_copy(0, s_sel, write | m.lm_valid[s_sel])
    lm_last_seen = lm_last_seen.index_copy(
        0, s_sel, torch.where(write, kf_counter, lm_last_seen[s_sel]))
    # Evicted slots' old observations are dead: zero them across the window.
    keep = torch.where(write, zero, 1.0)
    obs_w = obs_w.index_copy(1, s_sel, obs_w[:, s_sel] * keep[None, :, None])
    obs_rays = obs_rays.index_copy(1, s_sel, obs_rays[:, s_sel] * keep[None, :, None, None])
    # ...then record the new landmarks' own first observation.
    new_rays = torch.stack([feats.ray_top[f_sel], feats.ray_bottom[f_sel]], dim=1)
    row_rays = obs_rays.index_select(0, h1)[0]
    row_rays = row_rays.index_copy(0, s_sel, torch.where(write[:, None, None], new_rays,
                                                         row_rays[s_sel]))
    obs_rays = obs_rays.index_copy(0, h1, row_rays[None])
    row_w = obs_w.index_select(0, h1)[0]
    row_w = row_w.index_copy(0, s_sel, torch.where(write[:, None], 1.0, row_w[s_sel]))
    obs_w = obs_w.index_copy(0, h1, row_w[None])

    return MapState(kf_X=kf_X, kf_valid=kf_valid, kf_frame=kf_frame, head=new_head,
                    n_kf=m.n_kf + 1, lm_pos=lm_pos, lm_desc=lm_desc, lm_valid=lm_valid,
                    lm_last_seen=lm_last_seen, obs_rays=obs_rays, obs_w=obs_w)


def window_anchor(m: MapState) -> torch.Tensor:
    """Gauge keyframe slot: the OLDEST valid keyframe in the ring."""
    W = m.kf_X.shape[0]
    return torch.where(m.n_kf < W, 0, torch.remainder(m.head + 1, W))


def run_window_ba(rig: OmnistereoRig, m: MapState, iters: int = 5,
                  huber_delta: float | None = 0.01) -> tuple[MapState, torch.Tensor]:
    """Refine the window with robust BA; returns (updated map, BA cost)."""
    vps = torch.stack([viewpoint(rig.top), viewpoint(rig.bottom)])
    win = BAWindow(X=m.kf_X, landmarks=m.lm_pos, rays=m.obs_rays, weights=m.obs_w,
                   viewpoints=vps)
    res = ba_solve(win, iters=iters, anchor=window_anchor(m), huber_delta=huber_delta)
    return m._replace(kf_X=res.X, lm_pos=res.landmarks), res.cost

