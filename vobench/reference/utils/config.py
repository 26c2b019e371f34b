"""Frozen-dataclass pipeline configuration, JSON-loadable.

Counterpart of `sosvo/utils/config.py`: the same dataclasses, field names
and defaults, so the presets in `configs/*.json` load unchanged. (Importing
the JAX module would run `sosvo/__init__.py`, which imports jax.) The port
runs the observation- and image-mode replays, window BA, loop closure,
PGO, the batched replay (`dist.data_parallel`), model- and PGO-sharding and
the three descriptor families from these fields. The Pallas switches are
kept so every preset loads; the port ignores them.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any


@dataclass(frozen=True)
class FrontendConfig:
    """Feature detection / description / matching knobs."""

    max_features: int = 512          # K: fixed feature-slot count per view
    stereo_band_rad: float = 0.06    # +/- azimuth band for stereo matching
    match_max_distance: float = 80.0  # Hamming acceptance threshold (of 256)
    match_ratio: float = 0.9         # Lowe ratio (best/second-best)
    detect_threshold: float = 4.0
    nms_grid: int = 3
    pano_height: int = 128
    pano_width: int = 1024
    descriptor_patch: int = 24
    use_pallas_match: bool = False   # JAX-only switch; the port has one
                                     # matcher path (the CUDA kernel and its
                                     # plain twin) and ignores it
    detector: str = "harris"
    fast_threshold: float = 0.04
    oriented: bool = False
    n_scales: int = 1
    descriptor: str = "brief"        # "brief" and "akaze" (256-bit words,
                                     # Hamming matcher) or "sift" (128-d
                                     # float, L2 matcher); image mode
    match_max_distance_l2: float = 0.7  # L2 acceptance threshold (SIFT)


@dataclass(frozen=True)
class RansacConfig:
    """Robust-estimation knobs."""

    n_hyps: int = 512                # fixed hypothesis batch H
    rigid_threshold: float = 0.05    # 3D inlier radius (m), when scoring in 3D
    rigid_angle_threshold: float = 0.02  # bearing inlier threshold (rad)
    essential_threshold: float = 0.01  # angular epipolar threshold (rad)
    min_inliers: int = 10


@dataclass(frozen=True)
class BAConfig:
    """Windowed bundle adjustment knobs."""

    window: int = 5
    max_landmarks: int = 512
    max_new: int = 96
    iters: int = 5
    huber_delta: float = 0.005
    damping_init: float = 1e-3
    use_pallas_schur: bool = True    # JAX-only switch; the port always runs
                                     # the CUDA Schur kernel (plain twin on CPU)


@dataclass(frozen=True)
class DistConfig:
    """Mesh / sharding knobs. `data_parallel` > 1 selects the batched replay
    of that many sequences (`vo/batched.py`, config c4); `model_parallel`
    (config c5) shards the window solves' landmarks and `pgo_shards` (the
    c3_long presets) the loop leg over ranks (`sosvo_torch/dist/`)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = 1
    model_parallel: int = 1
    pgo_shards: int = 1


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level VO pipeline configuration."""

    frontend: FrontendConfig = FrontendConfig()
    ransac: RansacConfig = RansacConfig()
    ba: BAConfig = BAConfig()
    dist: DistConfig = DistConfig()
    min_triangulation_angle: float = 0.004
    max_range: float = 30.0
    max_ray_gap: float = 0.08
    refine_iters: int = 4            # Gauss-Newton iterations in the bearing refine
    use_essential_gate: bool = True
    lazy_essential_gate: bool = True  # run the essential gate only when the
                                      # rigid solve is questionable (inlier
                                      # fraction below lazy_gate_ratio)
    lazy_gate_ratio: float = 0.9
    keyframe_every: int = 4
    keyframe_mode: str = "stride"
    kf_min_gap: int = 1
    kf_max_gap: int = 12
    kf_trans_thresh: float = 0.06
    kf_rot_thresh: float = 0.10
    mode: str = "observations"       # "observations" (c1) or "images" (c2+)
    relocalize: bool = True
    reloc_min_inliers: int = 20
    pose_graph: bool = False
    loop_candidates: int = 0
    loop_min_inliers: int = 30
    pgo_robust: str = "dcs"
    pgo_robust_delta: float = 0.1


_SUBCONFIGS = {"frontend": FrontendConfig, "ransac": RansacConfig,
               "ba": BAConfig, "dist": DistConfig}


def _from_dict(cls, d: dict[str, Any]):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        kwargs[f.name] = _from_dict(_SUBCONFIGS[f.name], v) if f.name in _SUBCONFIGS else v
    return cls(**kwargs)


def load_pipeline_config(path: str | Path) -> PipelineConfig:
    """Load a PipelineConfig from a JSON preset (configs/c*.json)."""
    with open(path) as f:
        d = json.load(f)
    return _from_dict(PipelineConfig, d.get("pipeline", d))
