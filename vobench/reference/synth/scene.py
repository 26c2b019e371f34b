"""The observation layout every stage shares, and the deterministic
trajectory (counterpart of `sosvo/synth/scene.py`).

Descriptors are 8 x 32-bit words carried as int32 bit patterns (torch's
uint32 supports few ops).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.geom.lie import rt_to_mat, so3_exp
from vobench.reference.utils.device import resolve

DESC_WORDS = 8  # 256-bit descriptors packed as 8 x 32-bit words


class FrameObservations(NamedTuple):
    """Fixed-size per-frame feature observations (possibly with a leading
    frame dim). Field meanings as in `sosvo.synth.scene.FrameObservations`;
    descriptors are int32 bit patterns."""

    uv_top: torch.Tensor      # (..., K, 2)
    uv_bottom: torch.Tensor   # (..., K, 2)
    ray_top: torch.Tensor     # (..., K, 3) unit rays (rig frame) from the top viewpoint
    ray_bottom: torch.Tensor  # (..., K, 3)
    desc_top: torch.Tensor    # (..., K, DESC_WORDS) int32
    desc_bottom: torch.Tensor
    valid_top: torch.Tensor   # (..., K) bool
    valid_bottom: torch.Tensor
    lm_id: torch.Tensor       # (..., K) int32 ground-truth landmark index (-1 = empty)

    @property
    def valid(self) -> torch.Tensor:
        return self.valid_top & self.valid_bottom

    def frame(self, i: int) -> "FrameObservations":
        """The observations of frame `i` of a stacked sequence."""
        return FrameObservations(*(x[i] for x in self))


def as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def make_trajectory(n_frames: int, radius: float = 0.8, height_amp: float = 0.15,
                    yaw_per_frame: float = 0.03,
                    device: torch.device | str | None = None) -> torch.Tensor:
    """Deterministic circular arc + bobbing + yaw: (F, 4, 4) world-from-rig."""
    device = resolve(device)
    t = torch.arange(n_frames, dtype=torch.float32, device=device)
    ang = t * yaw_per_frame * 2.0
    pos = torch.stack([radius * torch.cos(ang) - radius, radius * torch.sin(ang),
                       height_amp * torch.sin(t * 0.11)], dim=-1)
    yaw = t * yaw_per_frame
    pitch = 0.05 * torch.sin(t * 0.07)
    w = torch.stack([torch.zeros_like(yaw), pitch, yaw], dim=-1)
    return rt_to_mat(so3_exp(w), pos)
