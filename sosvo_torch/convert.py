"""Turn the JAX package's objects, as numpy arrays, into the port's.

Used by the parity tests so both packages compute on the same calibration,
inputs and state; this module imports neither jax nor `sosvo` (it reads
fields by name). Like every entry point, each function puts its tensors on
the card unless the caller names another device. Binary descriptors are
uint32 in the reference and int32 bit patterns here: `desc_to_torch` views
them, never converts values; float (SIFT) descriptors pass through as f32.
"""

from __future__ import annotations

import numpy as np
import torch

from sosvo_torch.backend.ba import BAWindow
from sosvo_torch.backend.pose_graph import PoseGraph
from sosvo_torch.calib.boards import BoardObservations, RigCalibResult
from sosvo_torch.calib.fit import CalibResult
from sosvo_torch.frontend.detect import Keypoints
from sosvo_torch.frontend.image_frontend import FrontendLUTs
from sosvo_torch.frontend.panorama import PanoGeometry
from sosvo_torch.sensor.model import ViewParams
from sosvo_torch.sensor.rig import OmnistereoRig
from sosvo_torch.synth.scene import FrameObservations
from sosvo_torch.utils.device import resolve
from sosvo_torch.vo.ba_pipeline import BAState
from sosvo_torch.vo.keyframes import MapState
from sosvo_torch.vo.state import TrackState


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x, copy=True), dtype=dtype, device=resolve(device))


def desc_to_torch(desc, device: torch.device | str | None = None) -> torch.Tensor:
    """Descriptors -> the port's: uint32 words -> int32 with the same bits;
    float descriptors -> f32."""
    a = np.asarray(desc)
    if np.issubdtype(a.dtype, np.floating):
        return _t(a, device, torch.float32)
    words = np.ascontiguousarray(a.astype(np.uint32, copy=False)).view(np.int32)
    return torch.as_tensor(words.copy(), device=resolve(device))


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """The port's descriptors -> the reference's layout: int32 words ->
    uint32 with the same bits; float descriptors -> float32."""
    a = desc.detach().cpu().numpy()
    return a if desc.is_floating_point() else a.view(np.uint32)


def view_from_numpy(view, device: torch.device | str | None = None) -> ViewParams:
    return ViewParams(*(_t(getattr(view, f), device, torch.float32) for f in ViewParams._fields))


def rig_from_numpy(rig, device: torch.device | str | None = None) -> OmnistereoRig:
    """An `OmnistereoRig`-shaped object (numpy or jax leaves) -> the port's rig."""
    return OmnistereoRig(top=view_from_numpy(rig.top, device),
                         bottom=view_from_numpy(rig.bottom, device),
                         baseline=_t(rig.baseline, device, torch.float32),
                         image_height=int(rig.image_height), image_width=int(rig.image_width))


def observations_from_numpy(obs, device: torch.device | str | None = None) -> FrameObservations:
    """A `FrameObservations`-shaped object -> the port's (uint32 viewed as int32)."""
    return FrameObservations(
        uv_top=_t(obs.uv_top, device, torch.float32),
        uv_bottom=_t(obs.uv_bottom, device, torch.float32),
        ray_top=_t(obs.ray_top, device, torch.float32),
        ray_bottom=_t(obs.ray_bottom, device, torch.float32),
        desc_top=desc_to_torch(obs.desc_top, device),
        desc_bottom=desc_to_torch(obs.desc_bottom, device),
        valid_top=_t(obs.valid_top, device, torch.bool),
        valid_bottom=_t(obs.valid_bottom, device, torch.bool),
        lm_id=_t(obs.lm_id, device, torch.int32),
    )


def track_state_from_numpy(state, generator: torch.Generator,
                           device: torch.device | str | None = None) -> TrackState:
    """A `TrackState`-shaped object -> the port's; the PRNG key is dropped and
    `generator` takes its place."""
    return TrackState(
        T_world=_t(state.T_world, device, torch.float32),
        prev_points=_t(state.prev_points, device, torch.float32),
        prev_desc=desc_to_torch(state.prev_desc, device),
        prev_rays=_t(state.prev_rays, device, torch.float32),
        prev_azimuth=_t(state.prev_azimuth, device, torch.float32),
        prev_valid=_t(state.prev_valid, device, torch.bool),
        frame_idx=_t(state.frame_idx, device, torch.int32),
        generator=generator,
    )


def map_state_from_numpy(m, device: torch.device | str | None = None) -> MapState:
    """A `MapState`-shaped object -> the port's (descriptors viewed as int32)."""
    f32, i32 = torch.float32, torch.int32
    return MapState(
        kf_X=_t(m.kf_X, device, f32), kf_valid=_t(m.kf_valid, device, torch.bool),
        kf_frame=_t(m.kf_frame, device, i32), head=_t(m.head, device, i32),
        n_kf=_t(m.n_kf, device, i32), lm_pos=_t(m.lm_pos, device, f32),
        lm_desc=desc_to_torch(m.lm_desc, device), lm_valid=_t(m.lm_valid, device, torch.bool),
        lm_last_seen=_t(m.lm_last_seen, device, i32), obs_rays=_t(m.obs_rays, device, f32),
        obs_w=_t(m.obs_w, device, f32))


def ba_state_from_numpy(state, generator: torch.Generator,
                        device: torch.device | str | None = None) -> BAState:
    """A `BAState`-shaped object -> the port's; `generator` replaces the key."""
    return BAState(track=track_state_from_numpy(state.track, generator, device),
                   map=map_state_from_numpy(state.map, device))


def ba_window_from_numpy(win, device: torch.device | str | None = None) -> BAWindow:
    """A `BAWindow`-shaped object -> the port's."""
    return BAWindow(*(_t(getattr(win, f), device, torch.float32) for f in BAWindow._fields))


def loop_edges_from_numpy(ei, ej, T_meas, w, device: torch.device | str | None = None):
    """Edges (ei, ej, T_meas, w) as numpy or jax arrays -> the port's
    (int64 endpoints, f32 transforms and weights)."""
    return (_t(ei, device, torch.int64), _t(ej, device, torch.int64),
            _t(T_meas, device, torch.float32), _t(w, device, torch.float32))


def pose_graph_from_numpy(g, device: torch.device | str | None = None) -> PoseGraph:
    """A `PoseGraph`-shaped object -> the port's."""
    ei, ej, T_meas, w = loop_edges_from_numpy(g.ei, g.ej, g.T_meas, g.w, device)
    return PoseGraph(X=_t(g.X, device, torch.float32),
                     node_valid=_t(g.node_valid, device, torch.bool),
                     ei=ei, ej=ej, T_meas=T_meas, w=w)


def images_from_numpy(images, device: torch.device | str | None = None) -> torch.Tensor:
    """Rendered raw images (numpy or jax) -> an f32 tensor."""
    return _t(images, device, torch.float32)


def pano_geometry_from_numpy(geom, image_height: int = 768, image_width: int = 768,
                             device: torch.device | str | None = None) -> PanoGeometry:
    """A `PanoGeometry`-shaped object -> the port's. The bilinear cell's
    corner (u0, v0) is decoded from the reference's quad-table index
    `idx_r0` (even-x0 quads first, then odd-x0 ones, `image_width // 2`
    per image row), so the port warps with the reference's own cells."""
    half = image_width // 2
    idx = np.asarray(geom.idx_r0).astype(np.int64)
    odd = idx >= image_height * half
    rem = idx - np.where(odd, image_height * half, 0)
    v0, m = rem // half, rem % half
    return PanoGeometry(height=int(geom.height), width=int(geom.width),
                        min_elevation=float(geom.min_elevation),
                        max_elevation=float(geom.max_elevation),
                        lut_uv=_t(geom.lut_uv, device, torch.float32),
                        valid=_t(geom.valid, device, torch.bool),
                        u0=_t(2 * m + odd, device, torch.int64), v0=_t(v0, device, torch.int64),
                        fu=_t(geom.fu, device, torch.float32),
                        fv=_t(geom.fv, device, torch.float32))


def frontend_luts_from_numpy(luts, image_height: int = 768, image_width: int = 768,
                             device: torch.device | str | None = None) -> FrontendLUTs:
    """A `FrontendLUTs`-shaped object -> the port's."""
    return FrontendLUTs(*(pano_geometry_from_numpy(g, image_height, image_width, device)
                          for g in (luts.top, luts.bottom)))


def keypoints_from_numpy(kps, device: torch.device | str | None = None) -> Keypoints:
    """A `Keypoints`-shaped object -> the port's."""
    return Keypoints(rows=_t(kps.rows, device, torch.float32),
                     cols=_t(kps.cols, device, torch.float32),
                     response=_t(kps.response, device, torch.float32),
                     valid=_t(kps.valid, device, torch.bool))


def board_observations_from_numpy(obs, device: torch.device | str | None = None
                                  ) -> BoardObservations:
    """A `BoardObservations`-shaped object -> the port's (all f32)."""
    return BoardObservations(*(_t(getattr(obs, f), device, torch.float32)
                               for f in BoardObservations._fields))


def calib_result_from_numpy(res, device: torch.device | str | None = None) -> CalibResult:
    """A `CalibResult`-shaped object (`calib.fit.fit_view`'s) -> the port's."""
    return CalibResult(view=view_from_numpy(res.view, device),
                       rms_px=_t(res.rms_px, device, torch.float32),
                       rms0_px=_t(res.rms0_px, device, torch.float32),
                       accepted=_t(res.accepted, device, torch.bool))


def rig_calib_result_from_numpy(res, device: torch.device | str | None = None
                                ) -> RigCalibResult:
    """A `RigCalibResult`-shaped object (`calib.boards`' fits) -> the port's."""
    return RigCalibResult(rig=rig_from_numpy(res.rig, device),
                          poses=_t(res.poses, device, torch.float32),
                          rms_px=_t(res.rms_px, device, torch.float32),
                          rms0_px=_t(res.rms0_px, device, torch.float32),
                          accepted=_t(res.accepted, device, torch.bool))
