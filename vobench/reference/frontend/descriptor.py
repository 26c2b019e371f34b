"""Binary descriptors: BRIEF-style 256-bit intensity-pair comparisons
(counterpart of `sosvo/frontend/descriptor.py`).

A fixed random pattern of point pairs in a patch (numpy `default_rng(7)`,
the reference's pattern) is sampled around each keypoint on the smoothed
panorama, one gather for all K x 256 x 2 samples; columns wrap (azimuth),
rows clamp, sample positions round half to even. Optional steering
(rBRIEF): the pattern is rotated by each keypoint's intensity-centroid
angle. Bits are packed 32 to a word, as int32 bit patterns (the reference
packs uint32 words; the port's matcher takes the same bits as int32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vobench.reference.frontend.detect import Keypoints, gaussian_smooth
from vobench.reference.synth.scene import as_int32_bits

NBITS = 256
WORDS = NBITS // 32


def _disk_offsets(radius: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """All integer (drow, dcol) offsets within `radius`, as two flat arrays."""
    rr, cc = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    keep = rr * rr + cc * cc <= radius * radius
    return rr[keep].astype(np.float32), cc[keep].astype(np.float32)


_DISK_DR, _DISK_DC = _disk_offsets()


def _sample(img: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """img at the rounded positions; rows clamp, columns wrap."""
    h, w = img.shape
    r = torch.clamp(torch.round(rows).to(torch.int64), 0, h - 1)
    c = torch.remainder(torch.round(cols).to(torch.int64), w)
    return img[r, c]


def orientation(img: torch.Tensor, kps: Keypoints) -> torch.Tensor:
    """Per-keypoint patch orientation by intensity centroid (ORB IC_Angle):
    atan2(m01, m10) over a radius-7 disk. (K,) f32 radians."""
    dr, dc = _constant("disk_dr", img.device), _constant("disk_dc", img.device)
    patch = _sample(img, kps.rows[:, None] + dr, kps.cols[:, None] + dc)  # (K, |disk|)
    m10 = torch.sum(patch * dc, dim=1)
    m01 = torch.sum(patch * dr, dim=1)
    return torch.atan2(m01, m10)


def _make_pattern(patch: int = 24, seed: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """Fixed random BRIEF pattern: two (NBITS, 2) float offsets, Gaussian-
    distributed within the patch (sigma = patch/5, BRIEF-G II)."""
    rng = np.random.default_rng(seed)
    sigma = patch / 5.0
    a = np.clip(rng.normal(0.0, sigma, (NBITS, 2)), -patch / 2 + 1, patch / 2 - 1)
    b = np.clip(rng.normal(0.0, sigma, (NBITS, 2)), -patch / 2 + 1, patch / 2 - 1)
    return a.astype(np.float32), b.astype(np.float32)


_PAT_A, _PAT_B = _make_pattern()

_CONSTANTS = {"disk_dr": _DISK_DR, "disk_dc": _DISK_DC, "pat_a": _PAT_A, "pat_b": _PAT_B}


@functools.lru_cache(maxsize=None)
def _constant(name: str, device: torch.device) -> torch.Tensor:
    """A sampling pattern as a tensor on `device`, copied there once: a copy
    from host memory per call would block the host on every frame."""
    return torch.as_tensor(_CONSTANTS[name], device=device)


def describe(pano: torch.Tensor, kps: Keypoints, smoothed: torch.Tensor | None = None,
             angles: torch.Tensor | None = None) -> torch.Tensor:
    """(K, WORDS) int32 packed descriptors at the keypoints.

    `smoothed`: the pre-smoothed panorama (the detector's), else `pano` is
    smoothed here. `angles`: optional (K,) orientations; the pattern is then
    rotated per keypoint (steered BRIEF)."""
    img = gaussian_smooth(pano) if smoothed is None else smoothed
    device = img.device
    if angles is not None:
        ca, sa = torch.cos(angles)[:, None], torch.sin(angles)[:, None]

    def sample(name):
        off = _constant(name, device)
        dr, dc = off[None, :, 0], off[None, :, 1]  # (1, NBITS)
        if angles is not None:
            # The pattern rotated into the patch frame (x = col, y = row, y down).
            dr, dc = sa * dc + ca * dr, ca * dc - sa * dr
        return _sample(img, kps.rows[:, None] + dr, kps.cols[:, None] + dc)  # (K, NBITS)

    bits = (sample("pat_a") < sample("pat_b")).to(torch.int64)
    shifts = torch.arange(32, device=device)
    words = torch.sum(bits.reshape(bits.shape[0], WORDS, 32) << shifts, dim=-1)
    return as_int32_bits(words)

