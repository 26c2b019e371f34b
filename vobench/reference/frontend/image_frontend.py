"""Image frontend: raw omni image -> panoramas -> keypoints -> observations
(counterpart of `sosvo/frontend/image_frontend.py`).

Per view: the panorama warp, then the configured descriptor family's
detection and description (`frontend/families/<cfg.descriptor>.py`), and
the keypoints lifted to rays and re-projected to raw pixels (`_lift`), into
the same fixed-size `FrameObservations` the observation mode uses, so image
mode shares every downstream stage.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.frontend.families import family
from vobench.reference.frontend.panorama import (PanoGeometry, build_pano_geometry, pano_ray,
                                           warp_panorama)
from vobench.reference.sensor.model import ViewParams, project
from vobench.reference.sensor.rig import OmnistereoRig
from vobench.reference.synth.scene import FrameObservations
from vobench.reference.utils.config import FrontendConfig


class FrontendLUTs(NamedTuple):
    """Per-view panorama geometries, built once per calibration."""

    top: PanoGeometry
    bottom: PanoGeometry


def build_frontend_luts(rig: OmnistereoRig, cfg: FrontendConfig) -> FrontendLUTs:
    """Both views' LUTs over the stereo-overlap elevation band, so the two
    panoramas see the same scene band; on the rig's device."""
    lo = float(torch.maximum(rig.top.min_elevation, rig.bottom.min_elevation))
    hi = float(torch.minimum(rig.top.max_elevation, rig.bottom.max_elevation))

    def geom(view):
        return build_pano_geometry(view, cfg.pano_height, cfg.pano_width, lo, hi,
                                   image_height=rig.image_height, image_width=rig.image_width)

    return FrontendLUTs(top=geom(rig.top), bottom=geom(rig.bottom))


def detect_args(cfg: FrontendConfig) -> dict:
    """`detect`'s keyword arguments for a frontend configuration."""
    return dict(threshold=cfg.detect_threshold * 1e-7, nms_radius=cfg.nms_grid,
                border_rows=cfg.descriptor_patch // 2 + 2)


def _halve(img: torch.Tensor) -> torch.Tensor:
    """Factor-2 average-pool downsample (a pyramid octave)."""
    h, w = img.shape
    return img.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))


def _lift(view: ViewParams, geom: PanoGeometry, rows, cols, desc, valid):
    """Keypoints at panorama (rows, cols) -> (uv, rays, desc, valid)."""
    rays = pano_ray(geom.height, geom.width, geom.min_elevation, geom.max_elevation, rows, cols)
    uv, _ = project(view, rays)
    # Keypoints whose pano cell has no raw-image support are invalid; the
    # cell index truncates toward zero, as the reference's int cast does.
    lut_ok = geom.valid[rows.to(torch.int64), cols.to(torch.int64)]
    return uv, rays, desc, valid & lut_ok


def extract_observations(rig: OmnistereoRig, luts: FrontendLUTs, cfg: FrontendConfig,
                         image: torch.Tensor) -> FrameObservations:
    """The full frontend for one raw omni image (on its device); fixed K
    slots per view, `lm_id` all -1."""
    view_features = family(cfg.descriptor).view_features
    uv_t, ray_t, desc_t, ok_t = view_features(cfg, warp_panorama(image, luts.top), rig.top,
                                              luts.top)
    uv_b, ray_b, desc_b, ok_b = view_features(cfg, warp_panorama(image, luts.bottom),
                                              rig.bottom, luts.bottom)
    return FrameObservations(
        uv_top=uv_t, uv_bottom=uv_b, ray_top=ray_t, ray_bottom=ray_b,
        desc_top=desc_t, desc_bottom=desc_b, valid_top=ok_t, valid_bottom=ok_b,
        lm_id=torch.full((cfg.max_features,), -1, dtype=torch.int32, device=image.device))


def extract_sequence(rig: OmnistereoRig, luts: FrontendLUTs, cfg: FrontendConfig,
                     images: torch.Tensor) -> FrameObservations:
    """`extract_observations` of each of (F, H, W) images, stacked per frame."""
    frames = [extract_observations(rig, luts, cfg, im) for im in images]
    return FrameObservations(*(torch.stack(x) for x in zip(*frames)))
