"""Binary descriptors: BRIEF-style 256-bit intensity-pair comparisons
(counterpart of `sosvo/frontend/descriptor.py`).

A fixed random pattern of point pairs in a patch (numpy `default_rng(7)`,
the reference's pattern) is sampled around each keypoint on the smoothed
panorama, one gather for all K x 256 x 2 samples; columns wrap (azimuth),
rows clamp, sample positions round half to even. Optional steering
(rBRIEF): the pattern is rotated by each keypoint's intensity-centroid
angle. Bits are packed 32 to a word, as int32 bit patterns (the reference
packs uint32 words; the port's matcher takes the same bits as int32).

`describe_sift` is the SIFT-style float option: 4 x 4 cells x 8
orientation bins of Gaussian-weighted gradient magnitude over a 16 x 16
sample grid (one gather of an 18 x 18 patch per keypoint), L2-normalised
with the 0.2 clip, matched by L2 (`frontend/match.py:match_l2`). Its bin
edges come from `atan2`, whose last bit differs between XLA's CPU
polynomial and torch's, so a sample on an edge can change bins: the tests
hold it to the reference at a stated tolerance.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sosvo_torch.frontend.detect import Keypoints, gaussian_smooth
from sosvo_torch.synth.scene import as_int32_bits

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

# SIFT-style float descriptor (the reference's `cv2.SIFT_create` option).
SIFT_CELLS = 4      # spatial cells per side
SIFT_SPC = 4        # samples per cell per side -> 16x16 sample grid
SIFT_BINS = 8       # orientation bins
SIFT_DIM = SIFT_CELLS * SIFT_CELLS * SIFT_BINS  # 128
_SIFT_SIDE = SIFT_CELLS * SIFT_SPC              # 16
_SIFT_CLIP = 0.2    # standard SIFT histogram clipping
# The reference's division by 2 pi: XLA multiplies by the f32 reciprocal.
_SIFT_INV_2PI = float(np.float32(1.0) / np.float32(2.0 * np.pi))


def _sift_grid() -> np.ndarray:
    """(S+2, S+2, 2) float sample offsets: 16x16 descriptor grid plus a
    one-sample halo on each side for central-difference gradients."""
    s = _SIFT_SIDE + 2
    ax = np.arange(s, dtype=np.float32) - (s - 1) / 2.0
    rr, cc = np.meshgrid(ax, ax, indexing="ij")
    return np.stack([rr, cc], axis=-1)


_SIFT_GRID = _sift_grid()
# Gaussian spatial weight over the 16x16 descriptor window (sigma = half side,
# as in Lowe's SIFT), evaluated at the inner grid samples.
_SIFT_W = np.exp(
    -(_SIFT_GRID[1:-1, 1:-1, 0] ** 2 + _SIFT_GRID[1:-1, 1:-1, 1] ** 2)
    / (2.0 * (_SIFT_SIDE / 2.0) ** 2)
).astype(np.float32)

_CONSTANTS = {"disk_dr": _DISK_DR, "disk_dc": _DISK_DC, "pat_a": _PAT_A, "pat_b": _PAT_B,
              "sift_dr": _SIFT_GRID[..., 0].reshape(1, -1),
              "sift_dc": _SIFT_GRID[..., 1].reshape(1, -1), "sift_w": _SIFT_W,
              "sift_bins": np.arange(SIFT_BINS, dtype=np.int64)}


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


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows divided by their L2 norm (at least 1e-12), the norm a plain sqrt
    of the sum of squares, as `jnp.linalg.norm` writes it."""
    return x / torch.clamp_min(torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)), 1e-12)


def describe_sift(pano: torch.Tensor, kps: Keypoints, smoothed: torch.Tensor | None = None,
                  angles: torch.Tensor | None = None) -> torch.Tensor:
    """(K, 128) float32 SIFT-style descriptors at the keypoints.

    An 18 x 18 patch per keypoint in one gather (rows clamp, columns wrap),
    central differences over its inner 16 x 16 samples, Gaussian-weighted
    magnitudes split between the two nearest of 8 orientation bins, summed
    over 4 x 4 cells, L2-normalised, clipped at 0.2, renormalised.
    `angles` rotates the sample grid per keypoint; the gradients, taken
    along the rotated axes, are then in the patch frame."""
    img = gaussian_smooth(pano) if smoothed is None else smoothed
    device = img.device
    dr, dc = _constant("sift_dr", device), _constant("sift_dc", device)   # (1, 324)
    if angles is not None:
        ca, sa = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
        dr, dc = sa * dc + ca * dr, ca * dc - sa * dr
    side = _SIFT_SIDE + 2
    patch = _sample(img, kps.rows[:, None] + dr, kps.cols[:, None] + dc).reshape(-1, side, side)

    gy = (patch[:, 2:, 1:-1] - patch[:, :-2, 1:-1]) * 0.5   # (K, 16, 16)
    gx = (patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2]) * 0.5
    mag = torch.sqrt(gx * gx + gy * gy + 1e-20) * _constant("sift_w", device)[None]
    theta = torch.atan2(gy, gx)                              # [-pi, pi]

    # Each sample split between its two nearest orientation bins.
    tb = (theta * _SIFT_INV_2PI + 0.5) * SIFT_BINS           # [0, 8]
    b0 = torch.floor(tb)
    f = tb - b0
    b0 = torch.remainder(b0.to(torch.int64), SIFT_BINS)
    b1 = torch.remainder(b0 + 1, SIFT_BINS)
    bins = _constant("sift_bins", device)
    contrib = mag[..., None] * ((bins == b0[..., None]) * (1.0 - f[..., None])
                                + (bins == b1[..., None]) * f[..., None])   # (K, 16, 16, 8)
    k = contrib.shape[0]
    hist = contrib.reshape(k, SIFT_CELLS, SIFT_SPC, SIFT_CELLS, SIFT_SPC, SIFT_BINS).sum(
        dim=(2, 4)).reshape(k, SIFT_DIM)
    return _unit_rows(torch.clamp_max(_unit_rows(hist), _SIFT_CLIP))
