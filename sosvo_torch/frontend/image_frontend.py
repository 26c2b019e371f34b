"""Image frontend: raw omni image -> panoramas -> keypoints -> observations
(counterpart of `sosvo/frontend/image_frontend.py`).

Per view: the panorama warp, then by `cfg.descriptor`
  * "brief": Harris detection with a fixed top-K per pyramid octave and
    upright (or steered) BRIEF words;
  * "sift": the same detection, and SIFT-style float descriptors
    (`descriptor.describe_sift`) per octave;
  * "akaze": the nonlinear scale space, Hessian detection and M-LDB words
    (`frontend/akaze.py`); its diffusion levels take the place of the
    linear pyramid, so `n_scales` is ignored, as in the reference;
and the keypoints lifted to rays and re-projected to raw pixels, into the
same fixed-size `FrameObservations` the observation mode uses, so image
mode shares every downstream stage (descriptors: int32 words, or (K, 128)
f32 for SIFT).

Spans (`utils/spans.py`): `frontend` per call of `extract_observations` or
`extract_sequence`, and inside it `frontend.warp`, `frontend.detect`
(smoothing, Harris, NMS, top-K), `frontend.describe` and `frontend.lift` per
view (and octave).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sosvo_torch.frontend.akaze import extract_akaze
from sosvo_torch.frontend.descriptor import describe, describe_sift, orientation
from sosvo_torch.frontend.detect import detect, gaussian_smooth
from sosvo_torch.frontend.panorama import (PanoGeometry, build_pano_geometry, pano_ray,
                                           warp_panorama)
from sosvo_torch.sensor.model import ViewParams, project
from sosvo_torch.sensor.rig import OmnistereoRig
from sosvo_torch.synth.scene import FrameObservations
from sosvo_torch.utils import spans
from sosvo_torch.utils.config import FrontendConfig


class FrontendLUTs(NamedTuple):
    """Per-view panorama geometries, built once per calibration."""

    top: PanoGeometry
    bottom: PanoGeometry


DESCRIPTORS = ("brief", "sift", "akaze")


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
                border_rows=cfg.descriptor_patch // 2 + 2, detector=cfg.detector,
                fast_threshold=cfg.fast_threshold)


def akaze_args(cfg: FrontendConfig) -> dict:
    """`akaze.extract_akaze`'s keyword arguments for a frontend configuration."""
    return dict(patch=cfg.descriptor_patch, threshold=cfg.detect_threshold * 1e-2,
                nms_radius=cfg.nms_grid)


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
    describe_fn = describe_sift if cfg.descriptor == "sift" else describe
    rows_l, cols_l, ok_l, desc_l = [], [], [], []
    lvl_img = pano
    for lvl in range(n):
        if lvl > 0:
            lvl_img = _halve(lvl_img)
        with spans.span("frontend.detect"):
            smoothed = gaussian_smooth(lvl_img)
            kps = detect(lvl_img, ks[lvl], **detect_args(cfg))
        with spans.span("frontend.describe"):
            angles = orientation(smoothed, kps) if cfg.oriented else None
            desc_l.append(describe_fn(lvl_img, kps, smoothed=smoothed, angles=angles))
        s = float(2 ** lvl)
        # Pooled cell i covers full-res [s*i, s*i + s), centred at s*i + (s-1)/2.
        rows_l.append(kps.rows * s + (s - 1.0) / 2.0)
        cols_l.append(kps.cols * s + (s - 1.0) / 2.0)
        ok_l.append(kps.valid)
    return _lift(view, geom, torch.cat(rows_l), torch.cat(cols_l), torch.cat(desc_l),
                 torch.cat(ok_l))


def _akaze_view_features(cfg: FrontendConfig, pano: torch.Tensor, view: ViewParams,
                         geom: PanoGeometry):
    """(uv, rays, desc, valid) of one warped panorama with the AKAZE option:
    K slots over its own diffusion levels at full resolution."""
    kps, desc = extract_akaze(pano, cfg.max_features, **akaze_args(cfg))
    return _lift(view, geom, kps.rows, kps.cols, desc, kps.valid)


def _lift(view: ViewParams, geom: PanoGeometry, rows, cols, desc, valid):
    """Keypoints at panorama (rows, cols) -> (uv, rays, desc, valid)."""
    with spans.span("frontend.lift"):
        rays = pano_ray(geom.height, geom.width, geom.min_elevation, geom.max_elevation, rows,
                        cols)
        uv, _ = project(view, rays)
        # Keypoints whose pano cell has no raw-image support are invalid; the
        # cell index truncates toward zero, as the reference's int cast does.
        lut_ok = geom.valid[rows.to(torch.int64), cols.to(torch.int64)]
        return uv, rays, desc, valid & lut_ok


def _extract(rig: OmnistereoRig, luts: FrontendLUTs, cfg: FrontendConfig,
             image: torch.Tensor) -> FrameObservations:
    if cfg.descriptor not in DESCRIPTORS:
        raise ValueError(f"unknown descriptor {cfg.descriptor!r}; one of {DESCRIPTORS}")
    view_features = _akaze_view_features if cfg.descriptor == "akaze" else _view_features
    with spans.span("frontend.warp"):
        pano_t = warp_panorama(image, luts.top)
    uv_t, ray_t, desc_t, ok_t = view_features(cfg, pano_t, rig.top, luts.top)
    with spans.span("frontend.warp"):
        pano_b = warp_panorama(image, luts.bottom)
    uv_b, ray_b, desc_b, ok_b = view_features(cfg, pano_b, rig.bottom, luts.bottom)
    return FrameObservations(
        uv_top=uv_t, uv_bottom=uv_b, ray_top=ray_t, ray_bottom=ray_b,
        desc_top=desc_t, desc_bottom=desc_b, valid_top=ok_t, valid_bottom=ok_b,
        lm_id=torch.full((cfg.max_features,), -1, dtype=torch.int32, device=image.device))


def extract_observations(rig: OmnistereoRig, luts: FrontendLUTs, cfg: FrontendConfig,
                         image: torch.Tensor) -> FrameObservations:
    """The full frontend for one raw omni image (on its device); fixed K
    slots per view, `lm_id` all -1."""
    with spans.span("frontend"):
        return _extract(rig, luts, cfg, image)


def extract_sequence(rig: OmnistereoRig, luts: FrontendLUTs, cfg: FrontendConfig,
                     images: torch.Tensor) -> FrameObservations:
    """`extract_observations` of each of (F, H, W) images, stacked per frame."""
    with spans.span("frontend"):
        frames = [_extract(rig, luts, cfg, im) for im in images]
        return FrameObservations(*(torch.stack(x) for x in zip(*frames)))
