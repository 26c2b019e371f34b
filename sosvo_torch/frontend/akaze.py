"""AKAZE-style features: nonlinear scale space, Hessian detection and M-LDB
bits (counterpart of `sosvo/frontend/akaze.py`).

* Scale space: Perona-Malik g2 diffusion, I += DT * div(g(|grad I|) grad I)
  with g = 1 / (1 + |grad I|^2 / k^2), in fixed explicit steps
  (STEPS_PER_LEVEL between snapshots). The contrast factor k is the 70th
  percentile of the smoothed image's gradient magnitude.
* Detector: the scale-normalised determinant of the Hessian per level, its
  maximum over levels (and the first level reaching it), then the image
  frontend's NMS, the border band and a fixed top-K with a subpixel
  parabola.
* Descriptor: M-LDB, the mean (intensity, dx, dy) of a 4 x 4 grid of cells
  around the keypoint on its own level, compared over 256 fixed
  channel-consistent cell pairs and packed into 8 int32 words (the
  reference's uint32 bits), so the Hamming matcher takes them unchanged.
Columns wrap (azimuth), rows clamp.

Differences from the reference:
  * `lax.scan` over levels is a Python loop (3 x 6 steps of ~15 eager ops
    each per view).
  * The reference's `lax.approx_max_k` is the exact top-K in `lax.top_k`'s
    order (`detect.top_k_ordered`): what the reference computes on its CPU
    backend.
  * `jnp.quantile` is written as JAX writes it (a sort, the two
    neighbouring order statistics, linear weights), not `torch.quantile`,
    whose interpolation rounds otherwise and which refuses more than 2^24
    elements. The reference's CPU backend contracts the interpolation into
    one fused multiply-add; the port rounds that sum once too (in float64),
    so k equals the reference's bit for bit on equal magnitudes.
  * Means over a cell's taps are a sum in tap order times the f32
    reciprocal of the tap count, as XLA evaluates `jnp.mean`: on equal
    inputs the M-LDB bits are the reference's.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from sosvo_torch.frontend.detect import (Keypoints, _conv2_sep, _DERIV, _ONE, _wrap_pad,
                                         gaussian_smooth, nms_local_max, top_k_ordered)
from sosvo_torch.synth.scene import as_int32_bits

NBITS = 256
WORDS = NBITS // 32
N_LEVELS = 4          # diffusion levels (evolution snapshots)
STEPS_PER_LEVEL = 6   # explicit diffusion steps between snapshots
DT = 0.2              # explicit-scheme step (stable for dt <= 0.25 in 2D)
GRID = 4              # M-LDB cell grid (GRID x GRID cells)
TAPS = 3              # per-cell mean estimated from TAPS x TAPS samples
_INV_TAPS2 = float(np.float32(1.0) / np.float32(TAPS * TAPS))


def _grad(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _conv2_sep(img, _ONE, _DERIV), _conv2_sep(img, _DERIV, _ONE)


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """`jnp.quantile(x, q)` (linear) of a 1-D f32 tensor, as a 0-dim tensor
    on its device: sort, the order statistics at floor and ceil of
    q (n - 1), weights 1 - t and t; the weighted sum rounded once."""
    n = x.shape[0]
    pos = np.float32(q) * np.float32(n - 1)
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = np.float32(pos - lo)
    w_lo = np.float32(1.0) - w_hi
    s = torch.sort(x).values
    a, b = s[int(lo)], s[int(hi)]
    b_term = b * float(w_hi)  # rounded to f32
    return (a.double() * float(w_lo) + b_term.double()).to(torch.float32)


def contrast_k(img: torch.Tensor, q: float = 0.7, smoothed: torch.Tensor | None = None
               ) -> torch.Tensor:
    """AKAZE contrast factor: the q-quantile of the smoothed image's gradient
    magnitude, at least 1e-6 (0-dim f32). `smoothed`: `gaussian_smooth(img)`
    when the caller has it."""
    gx, gy = _grad(gaussian_smooth(img) if smoothed is None else smoothed)
    mag = torch.sqrt(gx * gx + gy * gy)
    return torch.clamp_min(quantile(mag.reshape(-1), q), 1e-6)


def _diffusion_step(img: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """One explicit Perona-Malik step. Conductivities live on the half-grid
    faces (g averaged onto each face); columns wrap, rows clamp."""
    h, w = img.shape
    x = _wrap_pad(img, 1)
    c = x[1:h + 1, 1:w + 1]
    n = x[0:h, 1:w + 1]
    s = x[2:h + 2, 1:w + 1]
    e = x[1:h + 1, 2:w + 2]
    we = x[1:h + 1, 0:w]
    gx, gy = _grad(img)
    g = 1.0 / (1.0 + (gx * gx + gy * gy) / k2)
    gp = _wrap_pad(g, 1)
    gn = 0.5 * (g + gp[0:h, 1:w + 1])
    gs = 0.5 * (g + gp[2:h + 2, 1:w + 1])
    ge = 0.5 * (g + gp[1:h + 1, 2:w + 2])
    gw = 0.5 * (g + gp[1:h + 1, 0:w])
    return img + DT * (gn * (n - c) + gs * (s - c) + ge * (e - c) + gw * (we - c))


def nonlinear_scale_space(img: torch.Tensor, n_levels: int = N_LEVELS,
                          steps: int = STEPS_PER_LEVEL) -> torch.Tensor:
    """(n_levels, H, W) diffusion snapshots; level 0 is the smoothed image."""
    base = gaussian_smooth(img)
    k = contrast_k(img, smoothed=base)
    k2 = k * k
    levels = [base]
    x = base
    for _ in range(n_levels - 1):
        for _ in range(steps):
            x = _diffusion_step(x, k2)
        levels.append(x)
    return torch.stack(levels)


def hessian_response(space: torch.Tensor) -> torch.Tensor:
    """(n_levels, H, W) determinants of the Hessian, level l scaled by
    (l + 1)^2 (evolution time grows linearly with level, so sigma^4 does
    quadratically)."""
    out = []
    for lvl, im in enumerate(space):
        lxx = _conv2_sep(_conv2_sep(im, _ONE, _DERIV), _ONE, _DERIV)
        lyy = _conv2_sep(_conv2_sep(im, _DERIV, _ONE), _DERIV, _ONE)
        lxy = _conv2_sep(_conv2_sep(im, _DERIV, _ONE), _ONE, _DERIV)
        out.append(float((lvl + 1.0) ** 2) * (lxx * lyy - lxy * lxy))
    return torch.stack(out)


class AkazeKeypoints(NamedTuple):
    kps: Keypoints        # fixed-K rows/cols/response/valid
    level: torch.Tensor   # (K,) int64 diffusion level of each keypoint


def detect_akaze(pano: torch.Tensor, max_features: int, threshold: float = 1e-4,
                 nms_radius: int = 1, border_rows: int = 12,
                 n_levels: int = N_LEVELS) -> tuple[AkazeKeypoints, torch.Tensor]:
    """Top-K det-of-Hessian extrema over the nonlinear scale space -> (the
    keypoints with their levels, the scale space for the descriptor)."""
    h, w = pano.shape
    space = nonlinear_scale_space(pano, n_levels)
    resp_l = hessian_response(space)
    resp, lvl_of = torch.max(resp_l, dim=0)   # the first level on ties, as jnp.argmax
    resp_nms = nms_local_max(resp, nms_radius)
    row_ids = torch.arange(h, device=pano.device)[:, None]
    in_band = (row_ids >= border_rows) & (row_ids < h - border_rows)
    resp_nms = torch.where(in_band, resp_nms, -torch.inf)

    vals, idx = top_k_ordered(resp_nms.reshape(-1), max_features)
    r_i = idx // w
    c_i = idx % w
    scale = torch.clamp_min(torch.max(vals), 1e-12)
    valid = vals > threshold * scale

    # Subpixel parabola along each axis on the max-reduced response.
    c0 = resp[r_i, c_i]

    def refined(m, p):
        denom = m - 2.0 * c0 + p
        off = torch.where(torch.abs(denom) > 1e-12, 0.5 * (m - p) / denom, 0.0)
        return torch.clamp(off, -0.5, 0.5)

    d_row = refined(resp[torch.clamp(r_i - 1, 0, h - 1), c_i],
                    resp[torch.clamp(r_i + 1, 0, h - 1), c_i])
    d_col = refined(resp[r_i, torch.remainder(c_i - 1, w)], resp[r_i, torch.remainder(c_i + 1, w)])
    kps = Keypoints(rows=r_i.to(torch.float32) + d_row, cols=c_i.to(torch.float32) + d_col,
                    response=vals, valid=valid)
    return AkazeKeypoints(kps=kps, level=lvl_of[r_i, c_i]), space


def _mldb_pairs(n_cells: int = GRID * GRID, n_bits: int = NBITS,
                seed: int = 11) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed channel-consistent cell pairs (bit -> cell_a, cell_b, channel):
    all C(16, 2) = 120 pairs of each channel (I, dx, dy), 256 of the 360
    chosen by a seeded permutation (the reference's pattern)."""
    pairs = [(a, b, ch) for ch in range(3)
             for a in range(n_cells) for b in range(a + 1, n_cells)]
    rng = np.random.default_rng(seed)
    sel = rng.permutation(len(pairs))[:n_bits]
    arr = np.array([pairs[i] for i in sel], np.int32)
    return arr[:, 0], arr[:, 1], arr[:, 2]


_PAIR_A, _PAIR_B, _PAIR_CH = _mldb_pairs()


def _mldb_offsets(patch: int) -> np.ndarray:
    """(cells x taps^2, 2) f32 sample offsets: cell centres plus the taps
    within each cell, cell-major (the reference's layout)."""
    cell = patch / GRID
    cidx = (np.arange(GRID, dtype=np.float32) + 0.5) * cell - patch / 2.0
    crr, ccc = np.meshgrid(cidx, cidx, indexing="ij")
    centers = np.stack([crr.reshape(-1), ccc.reshape(-1)], -1)      # (cells, 2)
    t = (np.arange(TAPS, dtype=np.float32) - (TAPS - 1) / 2.0) * (cell / TAPS)
    trr, tcc = np.meshgrid(t, t, indexing="ij")
    taps = np.stack([trr.reshape(-1), tcc.reshape(-1)], -1)         # (taps^2, 2)
    return (centers[:, None, :] + taps[None, :, :]).reshape(-1, 2)


@functools.lru_cache(maxsize=None)
def _mldb_constants(patch: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """(offsets, pair cell a, pair cell b, pair channel) on `device`, copied
    there once: a copy from host memory per call would block the host on
    every frame."""
    return (torch.as_tensor(_mldb_offsets(patch), device=device),
            *(torch.as_tensor(x, dtype=torch.int64, device=device)
              for x in (_PAIR_A, _PAIR_B, _PAIR_CH)))


def describe_mldb(space: torch.Tensor, ak: AkazeKeypoints, patch: int = 24) -> torch.Tensor:
    """(K, WORDS) int32 packed M-LDB descriptors: per keypoint, the mean
    intensity, dx and dy of GRID x GRID cells (TAPS x TAPS samples each) on
    its own level; bit i compares channel ch of cells a and b of pair i."""
    n_lvl, h, w = space.shape
    device = space.device
    k = ak.kps.rows.shape[0]
    off, pa, pb, ch = _mldb_constants(patch, device)                  # off: (S, 2)
    r = torch.round(ak.kps.rows[:, None] + off[None, :, 0]).to(torch.int64)
    c = torch.round(ak.kps.cols[:, None] + off[None, :, 1]).to(torch.int64)
    flat = (ak.level.to(torch.int64)[:, None] * (h * w)
            + torch.clamp(r, 0, h - 1) * w + torch.remainder(c, w)).reshape(-1)
    gx = torch.stack([_conv2_sep(im, _ONE, _DERIV) for im in space])
    gy = torch.stack([_conv2_sep(im, _DERIV, _ONE) for im in space])
    vals = torch.stack([space.reshape(-1)[flat], gx.reshape(-1)[flat], gy.reshape(-1)[flat]],
                       dim=-1).reshape(k, GRID * GRID, TAPS * TAPS, 3)
    tap_sum = vals[:, :, 0]
    for t in range(1, TAPS * TAPS):
        tap_sum = tap_sum + vals[:, :, t]
    cells = tap_sum * _INV_TAPS2                                       # (K, cells, 3)

    bits = (cells[:, pa, ch] > cells[:, pb, ch]).to(torch.int64)      # (K, NBITS)
    shifts = torch.arange(32, device=device)
    return as_int32_bits(torch.sum(bits.reshape(k, WORDS, 32) << shifts, dim=-1))


def extract_akaze(pano: torch.Tensor, max_features: int, patch: int = 24,
                  threshold: float = 1e-4, nms_radius: int = 1,
                  n_levels: int = N_LEVELS) -> tuple[Keypoints, torch.Tensor]:
    """(keypoints, descriptors): the AKAZE option's detect + describe."""
    ak, space = detect_akaze(pano, max_features, threshold=threshold, nms_radius=nms_radius,
                             border_rows=patch // 2 + 2, n_levels=n_levels)
    return ak.kps, describe_mldb(space, ak, patch=patch)
