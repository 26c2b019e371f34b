"""Image frontend: raw omni image -> panoramas -> keypoints -> observations
(counterpart of `sosvo/frontend/image_frontend.py`).

Per view: the panorama warp, Harris detection with a fixed top-K per
pyramid octave and upright (or steered) BRIEF words (`cfg.descriptor`
"brief", the only family here), and the keypoints lifted to rays and
re-projected to raw pixels, into the same fixed-size `FrameObservations`
the observation mode uses, so image mode shares every downstream stage.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.frontend.descriptor import describe, orientation
from vobench.reference.frontend.detect import detect, gaussian_smooth
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


DESCRIPTORS = ("brief",)


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


def _view_features(cfg: FrontendConfig, pano: torch.Tensor, view: ViewParams,
                   geom: PanoGeometry):
    """(uv, rays, desc, valid) of one warped panorama: the K slots split over
    `n_scales` octaves, each detected and described on its own level, its
    coordinates mapped back to full resolution (centre of the pooled cell)."""
    k, n = cfg.max_features, cfg.n_scales
    ks = [k - (n - 1) * (k // n)] + [k // n] * (n - 1)
    rows_l, cols_l, ok_l, desc_l = [], [], [], []
    lvl_img = pano
    for lvl in range(n):
        if lvl > 0:
            lvl_img = _halve(lvl_img)
        smoothed = gaussian_smooth(lvl_img)
        kps = detect(lvl_img, ks[lvl], **detect_args(cfg))
        angles = orientation(smoothed, kps) if cfg.oriented else None
        desc_l.append(describe(lvl_img, kps, smoothed=smoothed, angles=angles))
        s = float(2 ** lvl)
        # Pooled cell i covers full-res [s*i, s*i + s), centred at s*i + (s-1)/2.
        rows_l.append(kps.rows * s + (s - 1.0) / 2.0)
        cols_l.append(kps.cols * s + (s - 1.0) / 2.0)
        ok_l.append(kps.valid)
    return _lift(view, geom, torch.cat(rows_l), torch.cat(cols_l), torch.cat(desc_l),
                 torch.cat(ok_l))


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
    if cfg.descriptor not in DESCRIPTORS:
        raise ValueError(f"unknown descriptor {cfg.descriptor!r}; one of {DESCRIPTORS}")
    if cfg.detector != "harris":
        raise ValueError(f"the reference detects Harris corners only, not {cfg.detector!r}")
    uv_t, ray_t, desc_t, ok_t = _view_features(cfg, warp_panorama(image, luts.top), rig.top,
                                               luts.top)
    uv_b, ray_b, desc_b, ok_b = _view_features(cfg, warp_panorama(image, luts.bottom),
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
