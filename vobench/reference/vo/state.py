"""VO state: the per-frame tracking carry and per-frame outputs (counterpart
of `sosvo/vo/state.py`, plus `KeyframeFeatures`, which the reference keeps
in `vo/keyframes.py` beside BA).

The reference's PRNG key becomes an explicit `torch.Generator` on the
state's device: the step draws its RANSAC Gumbel matrices from it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.synth.scene import DESC_WORDS
from vobench.reference.utils.device import resolve


def desc_zeros(k: int, device: torch.device | str | None = None) -> torch.Tensor:
    """An empty (k, DESC_WORDS) buffer of BRIEF's int32 words."""
    return torch.zeros((k, DESC_WORDS), dtype=torch.int32, device=resolve(device))


class TrackState(NamedTuple):
    """Carry of the frame-to-frame VO loop (fixed shapes, K feature slots)."""

    T_world: torch.Tensor       # (4, 4) world-from-rig pose of the current frame
    prev_points: torch.Tensor   # (K, 3) triangulated points in the previous rig frame
    prev_desc: torch.Tensor     # (K, DESC_WORDS) int32 descriptors of those points
    prev_rays: torch.Tensor     # (K, 3) top-view unit rays of those points
    prev_azimuth: torch.Tensor  # (K,) azimuth (rad) of those rays
    prev_valid: torch.Tensor    # (K,) bool
    frame_idx: torch.Tensor     # () int32
    generator: torch.Generator  # the step's random stream


class StepOutput(NamedTuple):
    """Per-frame diagnostics + pose."""

    T_world: torch.Tensor        # (4, 4)
    n_stereo: torch.Tensor       # () int32 stereo matches surviving triangulation
    n_temporal: torch.Tensor     # () int32 temporal matches
    n_inliers: torch.Tensor      # () int32 RANSAC inliers
    pose_ok: torch.Tensor        # () bool: pose accepted (else identity-motion hold)
    ess_angle_err: torch.Tensor  # () f32 rotation angle between rigid & essential estimates


class KeyframeFeatures(NamedTuple):
    """A frame's triangulated features, indexed by top-view slot."""

    pts_rig: torch.Tensor     # (K, 3)
    desc: torch.Tensor        # (K, DESC_WORDS) int32
    ray_top: torch.Tensor     # (K, 3)
    ray_bottom: torch.Tensor  # (K, 3) matched bottom ray of each slot
    valid: torch.Tensor       # (K,) bool


def init_track_state(max_features: int, generator: torch.Generator,
                     T0: torch.Tensor | None = None,
                     device: torch.device | str | None = None) -> TrackState:
    device = resolve(device)
    k = max_features
    return TrackState(
        T_world=(torch.eye(4, dtype=torch.float32, device=device) if T0 is None
                 else T0.to(device=device, dtype=torch.float32)),
        prev_points=torch.zeros((k, 3), dtype=torch.float32, device=device),
        prev_desc=desc_zeros(k, device),
        prev_rays=torch.zeros((k, 3), dtype=torch.float32, device=device),
        prev_azimuth=torch.zeros((k,), dtype=torch.float32, device=device),
        prev_valid=torch.zeros((k,), dtype=torch.bool, device=device),
        frame_idx=torch.zeros((), dtype=torch.int32, device=device),
        generator=generator,
    )

