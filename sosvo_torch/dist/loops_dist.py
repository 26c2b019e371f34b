"""Loop detection with the candidate pairs split over ranks (counterpart of
`sosvo/dist/loops_dist.py`).

Each candidate pair is an independent match, RANSAC and two-frame BA, so
the pairs are padded to a multiple of the axis size D and split in
contiguous blocks, while the keyframe features and the candidate selection
are computed alike on every rank. Padding slots evaluate pair (0, 0) and
get w = 0. Pair p's (H, K) Gumbel matrix is the one the single-device
`detect_loops` gives it, whichever rank evaluates it: from the same
generator a rank draws (and drops) the matrices of the pairs before its
block, or takes `gumbels[p]`. The blocks' edges are gathered back, so
every rank returns the single-device outputs.
"""

from __future__ import annotations

from typing import Sequence

import torch

from sosvo_torch.dist.mesh import DATA_AXIS, Mesh
from sosvo_torch.geometry.ransac import gumbel
from sosvo_torch.sensor.rig import OmnistereoRig
from sosvo_torch.synth.scene import FrameObservations
from sosvo_torch.utils.config import PipelineConfig
from sosvo_torch.vo.loop_closure import (LOOP_SEED, _kf_features, keyframe_signatures,
                                         loop_edges_for_pairs, loop_pairs, select_loop_candidates)


def detect_loops_sharded(mesh: Mesh, rig: OmnistereoRig, cfg: PipelineConfig,
                         obs_kf: FrameObservations, min_gap: int = 3, min_inliers: int = 30,
                         max_candidates: int | None = None,
                         generator: torch.Generator | None = None,
                         gumbels: Sequence[torch.Tensor] | None = None):
    """`detect_loops` with the pairs split over `mesh`'s data axis: the same
    (ei, ej, T_meas, w) on every rank."""
    axis = mesh.axis(DATA_AXIS)
    feats = _kf_features(rig, cfg, obs_kf)
    device = feats.pts_rig.device
    if max_candidates is None:
        pi_np, pj_np = loop_pairs(obs_kf.desc_top.shape[0], min_gap)
        pi = torch.as_tensor(pi_np, dtype=torch.int64).to(device)
        pj = torch.as_tensor(pj_np, dtype=torch.int64).to(device)
        pair_ok = torch.ones(pi.shape, dtype=torch.bool, device=device)
    else:
        pi, pj, pair_ok = select_loop_candidates(keyframe_signatures(feats.desc, feats.valid),
                                                 min_gap, max_candidates)
    m = pi.shape[0]
    n = -(-m // axis.size)  # pairs per rank
    lo = axis.index * n
    pad = n * axis.size - m
    zeros = torch.zeros((pad,), dtype=pi.dtype, device=device)
    block = slice(lo, lo + n)
    bi, bj = torch.cat([pi, zeros])[block], torch.cat([pj, zeros])[block]

    shape = (cfg.ransac.n_hyps, feats.pts_rig.shape[1])
    block_gumbels = None
    if gumbels is None:
        generator = generator or torch.Generator(device=device).manual_seed(LOOP_SEED)
        for _ in range(min(lo, m)):  # the earlier pairs' draws, dropped
            gumbel(generator, shape, device)
    else:
        block_gumbels = [gumbels[p] if p < m else gumbels[0] for p in range(lo, lo + n)]
    T_meas, w = loop_edges_for_pairs(rig, cfg, feats, bi, bj, min_inliers, generator,
                                     block_gumbels)
    T_meas = axis.all_gather(T_meas)[:m]
    w = axis.all_gather(w)[:m] * pair_ok.to(torch.float32)
    return pj, pi, T_meas, w

