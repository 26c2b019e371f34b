"""Omnistereo rig: the top+bottom view pair on a common vertical axis.

Counterpart of `sosvo/sensor/rig.py`. Rig frame: origin at the top view's
effective viewpoint, z up the shared mirror axis; the bottom viewpoint sits
at z = -baseline.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vobench.reference.sensor.model import ViewParams
from vobench.reference.utils.device import resolve


class OmnistereoRig(NamedTuple):
    """Calibrated omnistereo sensor: two coaxial catadioptric views."""

    top: ViewParams
    bottom: ViewParams
    baseline: torch.Tensor   # () f32
    image_height: int
    image_width: int


def _deg2rad_f32(deg: float) -> np.float32:
    # `jnp.deg2rad` of a Python float multiplies in f32: round both factors
    # to f32 first, so the elevation bounds carry the reference's bits.
    return np.float32(deg) * np.float32(np.pi / 180.0)


def default_rig(image_size: int = 768, baseline: float = 0.12,
                device: torch.device | str | None = None) -> OmnistereoRig:
    """The reference's MAV-scale rig (~12 cm baseline), see `sosvo.sensor.rig`."""
    device = resolve(device)
    c = image_size / 2.0 - 0.5
    s = image_size / 768.0
    top = ViewParams.create(
        xi=0.96, fx=150.0 * s, fy=150.0 * s, cx=c, cy=c,
        min_elevation=_deg2rad_f32(-38.0), max_elevation=_deg2rad_f32(14.0),
        z_offset=0.0, device=device)
    bottom = ViewParams.create(
        xi=0.92, fx=48.0 * s, fy=48.0 * s, cx=c, cy=c,
        min_elevation=_deg2rad_f32(-35.0), max_elevation=_deg2rad_f32(12.0),
        z_offset=-baseline, device=device)
    return OmnistereoRig(
        top=top, bottom=bottom,
        baseline=torch.as_tensor(baseline, dtype=torch.float32, device=device),
        image_height=image_size, image_width=image_size)
