"""Rig calibration files: JSON <-> `OmnistereoRig` (counterpart of
`sosvo/sensor/calib_io.py`, with its schema and its text).

A calibrated sensor is ported by writing one small JSON file; the files of
either package load in the other, and `save_rig` writes the JAX package's
text for the same rig. Elevations are stored in degrees (converted in f32,
read back in float64 and rounded to f32 once, as the JAX package does, so a
saved and reloaded rig may differ from the original by an f32 step there).

Schema:
{
  "image_height": 768, "image_width": 768, "baseline": 0.12,
  "top":    {"xi": ..., "fx": ..., "fy": ..., "cx": ..., "cy": ...,
             "min_elevation_deg": ..., "max_elevation_deg": ..., "z_offset": 0.0,
             "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "mis_rx": 0.0, "mis_ry": 0.0},
  "bottom": {...}
}
The full-GUM terms (k1 k2 p1 p2 mis_rx mis_ry) and z_offset default to 0
where a file leaves them out.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from sosvo_torch.sensor.model import ViewParams
from sosvo_torch.sensor.rig import OmnistereoRig

_GUM = ("k1", "k2", "p1", "p2", "mis_rx", "mis_ry")


def _f32(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()  # a 0-d float32 array


def _view_to_dict(v: ViewParams) -> dict:
    return {
        "xi": float(v.xi), "fx": float(v.fx), "fy": float(v.fy),
        "cx": float(v.cx), "cy": float(v.cy),
        "min_elevation_deg": float(np.rad2deg(_f32(v.min_elevation))),
        "max_elevation_deg": float(np.rad2deg(_f32(v.max_elevation))),
        "z_offset": float(v.z_offset),
        **{k: float(getattr(v, k)) for k in _GUM},
    }


def _view_from_dict(d: dict, device) -> ViewParams:
    return ViewParams.create(
        xi=d["xi"], fx=d["fx"], fy=d["fy"], cx=d["cx"], cy=d["cy"],
        min_elevation=np.deg2rad(d["min_elevation_deg"]),
        max_elevation=np.deg2rad(d["max_elevation_deg"]),
        z_offset=d.get("z_offset", 0.0), **{k: d.get(k, 0.0) for k in _GUM}, device=device)


def save_rig(path: str | Path, rig: OmnistereoRig) -> None:
    d = {
        "image_height": int(rig.image_height),
        "image_width": int(rig.image_width),
        "baseline": float(rig.baseline),
        "top": _view_to_dict(rig.top),
        "bottom": _view_to_dict(rig.bottom),
    }
    Path(path).write_text(json.dumps(d, indent=2))


def load_rig(path: str | Path, device: torch.device | str | None = None) -> OmnistereoRig:
    """The rig of a calibration file, on `device` (the card where None)."""
    d = json.loads(Path(path).read_text())
    top = _view_from_dict(d["top"], device)
    return OmnistereoRig(
        top=top,
        bottom=_view_from_dict(d["bottom"], device),
        baseline=torch.as_tensor(np.float32(d["baseline"]), device=top.xi.device),
        image_height=int(d["image_height"]),
        image_width=int(d["image_width"]),
    )
