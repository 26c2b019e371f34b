"""Synthetic omnistereo world with exact ground truth (observation mode).

Counterpart of `sosvo/synth/scene.py`: random landmarks in a cylindrical
shell, a deterministic trajectory, one canonical 256-bit descriptor per
landmark, and per-frame fixed-size feature observations (project through
both views, keep the K stereo-visible landmarks, add pixel noise, re-lift,
flip descriptor bits).

Randomness comes from an explicit `torch.Generator`; it cannot reproduce
`jax.random`'s threefry draws, so every draw is a separate input
(`ObservationDraws`) that a test can fill with the reference's own numbers.

Descriptors are 8 x 32-bit words carried as int32 bit patterns (torch's
uint32 supports few ops); `sosvo_torch.convert` views the reference's uint32
arrays as int32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sosvo_torch.geom.lie import mat_inv, rt_to_mat, so3_exp, transform_points
from sosvo_torch.sensor.model import lift, project, viewpoint
from sosvo_torch.sensor.rig import OmnistereoRig
from sosvo_torch.utils.device import resolve

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


class Scene(NamedTuple):
    landmarks: torch.Tensor   # (L, 3) world-frame 3D points
    lm_desc: torch.Tensor     # (L, DESC_WORDS) int32 canonical descriptor per landmark
    poses: torch.Tensor       # (F, 4, 4) ground-truth world-from-rig poses


class ObservationDraws(NamedTuple):
    """The random inputs of one `observe_frame` call."""

    noise_top: torch.Tensor     # (K, 2) standard normal pixel noise
    noise_bottom: torch.Tensor  # (K, 2)
    flips_top: torch.Tensor     # (K, DESC_WORDS) int32 bit-flip masks
    flips_bottom: torch.Tensor


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)


def as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def make_landmarks(gen: torch.Generator, n: int, r_min: float = 1.5, r_max: float = 6.0,
                   z_min: float = -1.5, z_max: float = 1.0,
                   device: torch.device | str | None = None) -> torch.Tensor:
    """Random landmarks in a cylindrical shell around the trajectory region."""
    device = resolve(device)
    theta = _uniform(gen, n, -math.pi, math.pi, device)
    r = torch.sqrt(_uniform(gen, n, r_min**2, r_max**2, device))
    z = _uniform(gen, n, z_min, z_max, device)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), z], dim=-1)


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


def landmark_descriptors(gen: torch.Generator, n_landmarks: int,
                         device: torch.device | str | None = None) -> torch.Tensor:
    """One canonical random 256-bit descriptor per landmark (int32 words)."""
    device = resolve(device)
    return torch.randint(-2**31, 2**31, (n_landmarks, DESC_WORDS), generator=gen,
                         dtype=torch.int32, device=device)


def descriptor_flips(gen: torch.Generator, shape: tuple[int, ...], flip_prob: float,
                     device: torch.device | str | None = None) -> torch.Tensor:
    """int32 masks with each of the 32 bits set independently w.p. flip_prob."""
    device = resolve(device)
    if flip_prob <= 0.0:
        return torch.zeros(shape, dtype=torch.int32, device=device)
    bits = torch.rand(shape + (32,), generator=gen, device=device) < flip_prob
    weights = torch.ones(32, dtype=torch.int64, device=device) << torch.arange(32, device=device)
    return as_int32_bits(torch.sum(bits.to(torch.int64) * weights, dim=-1))


def make_scene(gen: torch.Generator, n_frames: int, n_landmarks: int = 4096,
               device: torch.device | str | None = None) -> Scene:
    device = resolve(device)
    return Scene(
        landmarks=make_landmarks(gen, n_landmarks, device=device),
        lm_desc=landmark_descriptors(gen, n_landmarks, device=device),
        poses=make_trajectory(n_frames, device=device),
    )


def draw_observation(gen: torch.Generator, max_features: int, desc_flip_prob: float,
                     device: torch.device | str | None = None) -> ObservationDraws:
    device = resolve(device)
    k = max_features
    return ObservationDraws(
        noise_top=torch.randn(k, 2, generator=gen, device=device),
        noise_bottom=torch.randn(k, 2, generator=gen, device=device),
        flips_top=descriptor_flips(gen, (k, DESC_WORDS), desc_flip_prob, device),
        flips_bottom=descriptor_flips(gen, (k, DESC_WORDS), desc_flip_prob, device),
    )


def observe_frame(rig: OmnistereoRig, scene: Scene, frame_idx: int, max_features: int,
                  draws: ObservationDraws, pixel_noise: float = 0.0) -> FrameObservations:
    """Exact (optionally noisy) observations of the scene from one pose.

    Keeps the `max_features` stereo-visible landmarks with the highest
    descriptor-derived priority (a detector re-fires on the same corners, so
    consecutive frames overlap). `lax.top_k` keeps the lower index among
    equal scores; a stable descending sort does the same, where `torch.topk`
    promises no order among ties.
    """
    T_wr = scene.poses[frame_idx]
    pts_rig = transform_points(mat_inv(T_wr), scene.landmarks)
    uv_t, ok_t = project(rig.top, pts_rig - viewpoint(rig.top))
    uv_b, ok_b = project(rig.bottom, pts_rig - viewpoint(rig.bottom))
    visible = ok_t & ok_b

    priority = (scene.lm_desc[:, 0] & 0xFFFF).to(torch.float32) / float(1 << 17)
    score = visible.to(torch.float32) + priority
    idx = torch.sort(score, descending=True, stable=True).indices[:max_features]
    valid = visible[idx]

    uv_t = uv_t[idx] + pixel_noise * draws.noise_top
    uv_b = uv_b[idx] + pixel_noise * draws.noise_bottom
    ray_t, _ = lift(rig.top, uv_t)
    ray_b, _ = lift(rig.bottom, uv_b)
    desc = scene.lm_desc[idx]
    desc_t = desc ^ draws.flips_top
    desc_b = desc ^ draws.flips_bottom

    v = valid[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    zero_i = torch.zeros((), dtype=torch.int32, device=valid.device)
    return FrameObservations(
        uv_top=torch.where(v, uv_t, zero),
        uv_bottom=torch.where(v, uv_b, zero),
        ray_top=torch.where(v, ray_t, zero),
        ray_bottom=torch.where(v, ray_b, zero),
        desc_top=torch.where(v, desc_t, zero_i),
        desc_bottom=torch.where(v, desc_b, zero_i),
        valid_top=valid,
        valid_bottom=valid,
        lm_id=torch.where(valid, idx, -1).to(torch.int32),
    )


def observe_sequence(rig: OmnistereoRig, scene: Scene, max_features: int,
                     gen: torch.Generator, pixel_noise: float = 0.0,
                     desc_flip_prob: float = 0.0) -> FrameObservations:
    """Observations of every frame, stacked along a leading frame dim."""
    device = scene.landmarks.device
    frames = [observe_frame(rig, scene, f, max_features,
                            draw_observation(gen, max_features, desc_flip_prob, device),
                            pixel_noise)
              for f in range(scene.poses.shape[0])]
    return FrameObservations(*(torch.stack(x) for x in zip(*frames)))
