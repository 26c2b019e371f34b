"""Loop-closure detection and pose-graph trajectory refinement (config c3;
counterpart of `sosvo/vo/loop_closure.py`).

  1. keyframes: the replay's own keyframe set, or a fixed stride;
  2. loop candidates: all keyframe pairs at least `min_gap` keyframes apart,
     or the top-M of them by pooled-descriptor similarity;
  3. per pair: a match of the two keyframes' stereo features (Hamming, or
     L2 for SIFT's float descriptors),
     bearing-scored 3D-3D RANSAC, and a two-frame BA over the inliers;
     pairs with enough inliers become SE(3) edges weighted by inlier count;
  4. pose graph: odometry edges between consecutive keyframes plus the
     accepted loop edges, relaxed by damped GN (`backend/pose_graph.py`);
  5. every frame is corrected rigidly with its governing keyframe.

Differences from the reference:
  * The reference's `lax.map(batch_size=8)` over pairs, which bounds XLA's
    memory, is a Python loop: one matcher launch, one RANSAC and one
    two-frame BA (4 Schur launches) per pair. Pair indices stay on the
    device: each pair's features are gathered for all pairs at once, so the
    loop never reads an index back to the host.
  * `jax.random.split(PRNGKey(17), M)` gives each pair a key for its
    (H, K) Gumbel matrix. Here an explicit `torch.Generator` (by default one
    seeded 17 on the tensors' device) draws one pair's matrix at a time,
    unless the caller passes the matrices (a test passes the reference's).
  * No `jax.jit(leg)` closure per call: the leg runs eagerly.

Spans (`utils/spans.py`): `loop_leg` per `close_loops`, and inside it
`loop_leg.features` (the keyframes' stereo features),
`loop_leg.candidates` (signatures and the prescreen), `loop_leg.pairs`
(`loop.pairs_tried`), `loop_leg.pgo` and `loop_leg.correct`; the leg's host
reads are counted as `sync.leg_keyframes`, `sync.leg_pairs` and
`sync.leg_correct`.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from sosvo_torch.backend.ba import BAWindow, ba_solve
from sosvo_torch.backend.pose_graph import PGOResult, PoseGraph, odometry_edges, pgo_solve
from sosvo_torch.frontend.match import unpack_bits_pm1
from sosvo_torch.geom.lie import mat_inv, norm
from sosvo_torch.geometry.ransac import gumbel, ransac_rigid
from sosvo_torch.sensor.model import viewpoint
from sosvo_torch.sensor.rig import OmnistereoRig
from sosvo_torch.synth.scene import FrameObservations
from sosvo_torch.utils import spans
from sosvo_torch.utils.config import PipelineConfig
from sosvo_torch.vo.pipeline import _match, stereo_triangulate
from sosvo_torch.vo.state import KeyframeFeatures

LOOP_SEED = 17  # the reference's PRNGKey(17)


def keyframe_indices(n_frames: int, keyframe_every: int) -> np.ndarray:
    return np.arange(0, n_frames, keyframe_every)


def governing_map(n_frames: int, kf_idx: np.ndarray) -> np.ndarray:
    """(F,) index of the keyframe governing each frame (its preceding one),
    for any keyframe index set."""
    kf = np.asarray(kf_idx)
    gov = np.searchsorted(kf, np.arange(n_frames), side="right") - 1
    return np.clip(gov, 0, len(kf) - 1).astype(np.int32)


def loop_pairs(n_kf: int, min_gap: int) -> tuple[np.ndarray, np.ndarray]:
    """Static (i, j) candidate pairs with j - i >= min_gap."""
    ii, jj = np.meshgrid(np.arange(n_kf), np.arange(n_kf), indexing="ij")
    m = (jj - ii) >= min_gap
    return ii[m].astype(np.int32), jj[m].astype(np.int32)


def keyframe_signatures(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(n_kf, D) unit-norm appearance signatures over each keyframe's valid
    features: binary words (int32 here, the reference's uint32) pool to the
    mean +/-1 bit vector (D = 256), float descriptors (SIFT) to the mean
    vector (D = 128)."""
    if desc.is_floating_point():
        feat = desc.to(torch.float32)                            # (n_kf, K, D)
    else:
        feat = unpack_bits_pm1(desc, dtype=torch.float32)        # (n_kf, K, 256)
    w = valid.to(torch.float32)[..., None]
    sig = torch.sum(feat * w, dim=1) / torch.clamp_min(torch.sum(w, dim=1), 1.0)
    return sig / torch.clamp_min(norm(sig, keepdim=True), 1e-9)


def select_loop_candidates(sig: torch.Tensor, min_gap: int, max_candidates: int):
    """Top-M candidate pairs by signature similarity -> (pi, pj, ok): (M,)
    indices with pj - pi >= min_gap, and a mask that is False on slots
    beyond the number of admissible pairs. The top-M is a stable descending
    sort, so equal scores (the -inf of inadmissible pairs among them) keep
    the lower index first, as `lax.top_k`."""
    n_kf = sig.shape[0]
    sim = sig @ sig.T
    idx = torch.arange(n_kf, device=sig.device)
    admissible = (idx[None, :] - idx[:, None]) >= min_gap
    scores = torch.where(admissible, sim, -torch.inf).reshape(-1)
    s = torch.sort(scores, descending=True, stable=True)
    top, flat = s.values[:max_candidates], s.indices[:max_candidates]
    return flat // n_kf, flat % n_kf, torch.isfinite(top)


def _kf_features(rig: OmnistereoRig, cfg: PipelineConfig,
                 obs_kf: FrameObservations) -> KeyframeFeatures:
    """Stereo features of each keyframe, stacked (n_kf, K, ...): one banded
    matcher launch each."""
    per_kf = []
    for k in range(obs_kf.desc_top.shape[0]):
        pts, desc, rays, _, valid, ray_b = stereo_triangulate(rig, obs_kf.frame(k), cfg)
        per_kf.append((pts, desc, rays, ray_b, valid))
    return KeyframeFeatures(*(torch.stack(x) for x in zip(*per_kf)))


def pair_window(rig: OmnistereoRig, cfg: PipelineConfig, a: KeyframeFeatures,
                b: KeyframeFeatures, gumbel_hk: torch.Tensor, min_inliers: int):
    """One candidate pair (keyframe features `a` and `b`, (K, ...) each) ->
    (RANSAC result, the two-frame BA window over its inliers).

    The window holds frame i at the identity and frame j at the RANSAC
    pose; the matched points float, constrained by all four bearings, which
    removes the bias of frame i's triangulation depth noise."""
    m = _match(cfg, a.desc, b.desc, a.valid, b.valid)
    pair_valid = m.valid & a.valid & b.valid[m.idx_b]
    rays_j = b.ray_top[m.idx_b]
    rr = ransac_rigid(gumbel_hk, a.pts_rig, b.pts_rig[m.idx_b], pair_valid, rays_j,
                      angle_threshold=cfg.ransac.rigid_angle_threshold,
                      min_inliers=min_inliers)
    w_obs = (rr.inliers & pair_valid).to(torch.float32)
    k = w_obs.shape[0]
    rays4 = torch.stack([torch.stack([a.ray_top, a.ray_bottom], dim=1),
                         torch.stack([rays_j, b.ray_bottom[m.idx_b]], dim=1)])   # (2, K, 2, 3)
    eye4 = torch.eye(4, dtype=torch.float32, device=w_obs.device)
    vps = torch.stack([viewpoint(rig.top), viewpoint(rig.bottom)])
    win = BAWindow(X=torch.stack([eye4, rr.model]), landmarks=a.pts_rig, rays=rays4,
                   weights=w_obs[None, :, None].expand(2, k, 2), viewpoints=vps)
    return rr, win


def loop_edges_for_pairs(rig: OmnistereoRig, cfg: PipelineConfig, feats: KeyframeFeatures,
                         pi: torch.Tensor, pj: torch.Tensor, min_inliers: int,
                         generator: torch.Generator | None = None,
                         gumbels: Sequence[torch.Tensor] | None = None):
    """Evaluate candidate pairs -> (T_meas (M, 4, 4), w (M,)).

    Pair p draws its (H, K) Gumbel matrix from `generator` (H =
    cfg.ransac.n_hyps), or takes `gumbels[p]`."""
    device = feats.pts_rig.device
    spans.count("loop.pairs_tried", pi.shape[0])
    if generator is None and gumbels is None:
        generator = torch.Generator(device=device).manual_seed(LOOP_SEED)
    a_all = KeyframeFeatures(*(x[pi] for x in feats))
    b_all = KeyframeFeatures(*(x[pj] for x in feats))
    shape = (cfg.ransac.n_hyps, feats.pts_rig.shape[1])
    T_meas, w = [], []
    for p in range(pi.shape[0]):
        a = KeyframeFeatures(*(x[p] for x in a_all))
        b = KeyframeFeatures(*(x[p] for x in b_all))
        g = gumbel(generator, shape, device) if gumbels is None else gumbels[p]
        rr, win = pair_window(rig, cfg, a, b, g, min_inliers)
        res = ba_solve(win, iters=4, anchor=0)
        T_meas.append(torch.where(rr.ok, res.X[1], rr.model))
        w.append(torch.where(rr.ok, torch.clamp_max(rr.num_inliers.to(torch.float32) / min_inliers,
                                                    4.0), 0.0))
    if not T_meas:  # too few keyframes for a pair min_gap apart
        return (torch.zeros((0, 4, 4), dtype=torch.float32, device=device),
                torch.zeros((0,), dtype=torch.float32, device=device))
    return torch.stack(T_meas), torch.stack(w)


def detect_loops(rig: OmnistereoRig, cfg: PipelineConfig, obs_kf: FrameObservations,
                 min_gap: int = 3, min_inliers: int = 30, max_candidates: int | None = None,
                 generator: torch.Generator | None = None,
                 gumbels: Sequence[torch.Tensor] | None = None):
    """Loop edges between keyframes: (ei, ej, T_meas, w) with w = 0 for misses.

    An accepted pair (i, j) yields an edge with endpoints (ei=j, ej=i)
    measuring X_j @ X_i^-1 (the RANSAC pose mapping i-frame points to j),
    the pose graph's edge convention. `max_candidates=M` switches from all
    pairs to the signature prescreen (`select_loop_candidates`); the
    prescreen's padding slots are evaluated and get w = 0."""
    with spans.span("loop_leg.features"):
        feats = _kf_features(rig, cfg, obs_kf)
    device = feats.pts_rig.device
    with spans.span("loop_leg.candidates"):
        if max_candidates is None:
            pi_np, pj_np = loop_pairs(obs_kf.desc_top.shape[0], min_gap)
            spans.count("sync.leg_pairs", 2)
            pi = torch.as_tensor(pi_np, dtype=torch.int64).to(device)
            pj = torch.as_tensor(pj_np, dtype=torch.int64).to(device)
            pair_ok = None
        else:
            sig = keyframe_signatures(feats.desc, feats.valid)
            pi, pj, pair_ok = select_loop_candidates(sig, min_gap, max_candidates)
    with spans.span("loop_leg.pairs"):
        T_meas, w = loop_edges_for_pairs(rig, cfg, feats, pi, pj, min_inliers, generator,
                                         gumbels)
    if pair_ok is not None:
        w = w * pair_ok.to(w.dtype)
    return pj, pi, T_meas, w


def loop_closure_graph(rig: OmnistereoRig, cfg: PipelineConfig, obs_seq: FrameObservations,
                       T_world_seq: torch.Tensor, kf_idx: np.ndarray, min_gap: int = 3,
                       min_inliers: int = 30, odom_weight: float = 1.0,
                       max_candidates: int | None = None,
                       generator: torch.Generator | None = None,
                       gumbels: Sequence[torch.Tensor] | None = None):
    """The keyframe pose graph of a replayed trajectory -> (PoseGraph, n_loops):
    odometry edges between consecutive keyframes from the VO estimates and
    the detected loop edges; n_loops, the accepted loop count, stays on the
    device."""
    spans.count("sync.leg_keyframes")
    kf = torch.as_tensor(np.asarray(kf_idx), dtype=torch.int64).to(T_world_seq.device)
    X_kf = mat_inv(T_world_seq[kf])
    valid = torch.ones((kf.shape[0],), dtype=torch.bool, device=kf.device)
    oi, oj, T_odom, w_odom = odometry_edges(X_kf, valid, odom_weight)
    li, lj, T_loop, w_loop = detect_loops(rig, cfg, FrameObservations(*(x[kf] for x in obs_seq)),
                                          min_gap, min_inliers, max_candidates, generator, gumbels)
    g = PoseGraph(X=X_kf, node_valid=valid, ei=torch.cat([oi, li]), ej=torch.cat([oj, lj]),
                  T_meas=torch.cat([T_odom, T_loop]), w=torch.cat([w_odom, w_loop]))
    return g, torch.sum(w_loop > 0, dtype=torch.int32)


def correct_trajectory(T_world_seq: torch.Tensor, kf_idx: np.ndarray,
                       X_kf: torch.Tensor) -> torch.Tensor:
    """Move every frame rigidly with its governing keyframe, from the
    keyframes' old world-from-rig poses to the optimised rig-from-world X_kf."""
    n_frames = T_world_seq.shape[0]
    device = T_world_seq.device
    spans.count("sync.leg_correct", 2)
    kf = torch.as_tensor(np.asarray(kf_idx), dtype=torch.int64).to(device)
    gov = torch.as_tensor(governing_map(n_frames, kf_idx), dtype=torch.int64).to(device)
    corr = mat_inv(X_kf) @ mat_inv(T_world_seq[kf])
    return corr[gov] @ T_world_seq


class LoopClosure(NamedTuple):
    T_corrected: torch.Tensor  # (F, 4, 4) world-from-rig after loop closure
    n_loops: torch.Tensor      # () int32 accepted loop edges
    graph: PoseGraph           # the keyframe pose graph before optimisation
    result: PGOResult          # its solve


def close_loops(rig: OmnistereoRig, cfg: PipelineConfig, obs_seq: FrameObservations,
                T_world_seq: torch.Tensor, min_gap: int = 3, min_inliers: int = 30,
                iters: int = 10, odom_weight: float = 1.0, max_candidates: int | None = None,
                robust: str = "none", robust_delta: float = 0.1,
                kf_idx: np.ndarray | None = None, generator: torch.Generator | None = None,
                gumbels: Sequence[torch.Tensor] | None = None) -> LoopClosure:
    """`pgo_refine_trajectory` with the pose graph and its solve kept beside
    the corrected poses and the loop count."""
    with spans.span("loop_leg"):
        if kf_idx is None:
            kf_idx = keyframe_indices(T_world_seq.shape[0], cfg.keyframe_every)
        g, n_loops = loop_closure_graph(rig, cfg, obs_seq, T_world_seq, kf_idx, min_gap,
                                        min_inliers, odom_weight, max_candidates, generator,
                                        gumbels)
        with spans.span("loop_leg.pgo"):
            res = pgo_solve(g, iters=iters, robust=robust, robust_delta=robust_delta)
        with spans.span("loop_leg.correct"):
            T_corrected = correct_trajectory(T_world_seq, kf_idx, res.X)
        return LoopClosure(T_corrected, n_loops, g, res)


def pgo_refine_trajectory(rig: OmnistereoRig, cfg: PipelineConfig, obs_seq: FrameObservations,
                          T_world_seq: torch.Tensor, min_gap: int = 3, min_inliers: int = 30,
                          iters: int = 10, odom_weight: float = 1.0,
                          max_candidates: int | None = None, robust: str = "none",
                          robust_delta: float = 0.1, kf_idx: np.ndarray | None = None,
                          generator: torch.Generator | None = None,
                          gumbels: Sequence[torch.Tensor] | None = None):
    """Close loops over a replayed trajectory -> (corrected poses, n_loops),
    both device tensors.

    `T_world_seq`: (F, 4, 4) world-from-rig VO estimates. `kf_idx`: the
    replay's actual keyframe frame indices (host numpy, e.g. the BA
    replay's `is_keyframe`), so the pose graph optimises the node set the BA
    window used; None falls back to the stride schedule."""
    out = close_loops(rig, cfg, obs_seq, T_world_seq, min_gap, min_inliers, iters, odom_weight,
                      max_candidates, robust, robust_delta, kf_idx, generator, gumbels)
    return out.T_corrected, out.n_loops
