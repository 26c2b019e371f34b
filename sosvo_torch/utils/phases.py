"""Per-stage timing of the VO frame and of the image frontend (counterpart of
`sosvo/utils/phases.py`).

Each stage of an observation-mode (c1) frame runs on its own, on the card
unless the caller names another device, under PHASES.json's stage names:
stereo match, triangulation, temporal match, rigid RANSAC, bearing refine,
essential RANSAC, and a whole frame (`full_step`, from a fresh state, so
the lazy essential gate runs: the slowest legitimate frame). The image
frontend's stages (panorama warp, smoothing, detection, BRIEF and SIFT
description, both views' full extraction) are timed the same way. Times
are per call, `utils/profiling.time_amortized`: calls back to back between
two synchronizations, the median of `reps` rounds.

Run:  python -m sosvo_torch.utils.phases [--k 512] [--images] [--device cpu]
It prints one JSON object and writes no file (PHASES.json is the JAX
package's record on a TPU).
"""

from __future__ import annotations

import argparse
import json

import torch

from sosvo_torch.utils.device import resolve
from sosvo_torch.utils.profiling import time_amortized


def _device_name(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    from sosvo_torch.tools.workload import card_info

    return card_info()  # the card's name and power limit, as nvidia-smi prints them


def phase_breakdown(k: int = 512, n_landmarks: int = 4096, reps: int = 5, inner: int = 16,
                    device: torch.device | str | None = None) -> dict:
    """Per-call ms of each stage of a c1 frame at K=k; the matchers and the
    triangulation run 4 x `inner` calls per round, the rest `inner`."""
    from sosvo_torch.backend.refine import refine_pose_bearings
    from sosvo_torch.geometry.ransac import gumbel, ransac_essential, ransac_rigid
    from sosvo_torch.geometry.triangulate import midpoint_triangulate
    from sosvo_torch.sensor.model import viewpoint
    from sosvo_torch.sensor.rig import default_rig
    from sosvo_torch.synth.scene import draw_observation, make_scene, observe_frame
    from sosvo_torch.utils.config import FrontendConfig, PipelineConfig
    from sosvo_torch.vo.pipeline import _match, azimuth_of, step
    from sosvo_torch.vo.state import init_track_state

    device = torch.device(resolve(device))
    rig = default_rig(device=device)
    cfg = PipelineConfig(frontend=FrontendConfig(max_features=k))
    gen = torch.Generator(device=device).manual_seed(0)
    scene = make_scene(gen, n_frames=3, n_landmarks=n_landmarks, device=device)
    o0, o1 = (observe_frame(rig, scene, f, k, draw_observation(gen, k, 0.0, device),
                            pixel_noise=0.3) for f in (1, 2))
    az0, az0b = azimuth_of(o0.ray_top), azimuth_of(o0.ray_bottom)
    band = cfg.frontend.stereo_band_rad
    h = cfg.ransac.n_hyps

    def stereo(_):
        return _match(cfg, o0.desc_top, o0.desc_bottom, o0.valid_top, o0.valid_bottom,
                      az_a=az0, az_b=az0b, band=band)

    def triangulate(ray_b):
        return midpoint_triangulate(o0.ray_top, ray_b, viewpoint(rig.top), viewpoint(rig.bottom))

    def temporal(_):
        return _match(cfg, o0.desc_top, o1.desc_top, o0.valid_top, o1.valid_top)

    m = stereo(None)
    ray_b = o0.ray_bottom[m.idx_b]
    tri = triangulate(ray_b)
    tm = temporal(None)
    valid = m.valid & tri.valid & tm.valid
    g_rigid, g_ess = gumbel(gen, (h, k), device), gumbel(gen, (h, k), device)
    rays_curr = o1.ray_top[tm.idx_b]

    def rigid(pts):
        return ransac_rigid(g_rigid, pts, pts[tm.idx_b], valid, rays_curr)

    rr = rigid(tri.points)

    def refine(T):
        return refine_pose_bearings(T, tri.points, rays_curr, rr.inliers.float(),
                                    iters=cfg.refine_iters)

    def essential(rays):
        return ransac_essential(g_ess, rays, rays_curr, valid)

    state = init_track_state(k, torch.Generator(device=device).manual_seed(4), device=device)

    def full(s):
        return step(rig, cfg, s, o0)

    stages = (("stereo_match", stereo, None, 4), ("triangulate", triangulate, ray_b, 4),
              ("temporal_match", temporal, None, 4), ("ransac_rigid", rigid, tri.points, 1),
              ("refine", refine, rr.model, 1), ("ransac_essential", essential, o0.ray_top, 1),
              ("full_step", full, state, 1))
    times = {name: time_amortized(fn, x, inner=inner * mult, n=reps) * 1e3
             for name, fn, x, mult in stages}
    return {"device": _device_name(device), "k": k, "phases_ms": times,
            "note": ("per-call ms, calls back to back between two synchronizations, median of "
                     f"{reps} rounds; full_step from a fresh state (the essential gate runs)")}


def image_phase_breakdown(image_size: int = 768, k: int = 384, reps: int = 5, inner: int = 8,
                          cfg=None, device: torch.device | str | None = None) -> dict:
    """Per-call ms of the image frontend's stages on one view of a rendered
    frame (the command line's room), and of both views' full extraction."""
    from sosvo_torch.frontend.descriptor import describe, describe_sift
    from sosvo_torch.frontend.detect import detect, gaussian_smooth
    from sosvo_torch.frontend.image_frontend import (build_frontend_luts, detect_args,
                                                     extract_observations)
    from sosvo_torch.frontend.panorama import warp_panorama
    from sosvo_torch.sensor.rig import default_rig
    from sosvo_torch.synth.render import render_frame
    from sosvo_torch.synth.scene import make_trajectory
    from sosvo_torch.tools.workload import ROOM, TRAJECTORY_RADIUS
    from sosvo_torch.utils.config import FrontendConfig

    device = torch.device(resolve(device))
    rig = default_rig(image_size=image_size, device=device)
    fe = cfg or FrontendConfig(max_features=k, pano_height=96, pano_width=768,
                               descriptor_patch=16)
    luts = build_frontend_luts(rig, fe)
    img = render_frame(rig, make_trajectory(2, radius=TRAJECTORY_RADIUS, device=device)[1], ROOM)
    geom = luts.top
    pano = warp_panorama(img, geom)
    smoothed = gaussian_smooth(pano)
    kps = detect(pano, fe.max_features, **detect_args(fe))
    stages = (("warp", lambda im: warp_panorama(im, geom), img),
              ("smooth", gaussian_smooth, pano),
              ("detect", lambda p: detect(p, fe.max_features, **detect_args(fe)), pano),
              ("describe_brief", lambda s: describe(s, kps, smoothed=s), smoothed),
              ("describe_sift", lambda s: describe_sift(s, kps, smoothed=s), smoothed),
              ("extract_full_2views", lambda im: extract_observations(rig, luts, fe, im), img))
    times = {name: time_amortized(fn, x, inner=inner, n=reps) * 1e3 for name, fn, x in stages}
    return {"device": _device_name(device), "image_size": image_size, "k": fe.max_features,
            "pano": [fe.pano_height, fe.pano_width], "phases_ms": times,
            "note": "per-view stage cost except extract_full_2views (both views)"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--images", action="store_true",
                    help="time the image frontend's stages (c2's path)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the stages run; cuda fails without a card")
    args = ap.parse_args(argv)
    fn = image_phase_breakdown if args.images else phase_breakdown
    print(json.dumps(fn(k=args.k, device=args.device), indent=2))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
