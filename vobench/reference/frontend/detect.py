"""Feature detection on panoramas: Harris corners, NMS and a fixed top-K
(counterpart of `sosvo/frontend/detect.py`).

Fixed-size output: exactly K keypoint slots with a validity mask. The
panorama wraps horizontally (azimuth), so the filters and NMS pad columns
circularly; rows are edge-padded.

Differences from the reference:
  * The top-K is always exact: a stable descending sort of the response
    map, sliced to K, which is `lax.top_k`'s selection and order (value
    descending, ties by lower flat index). The reference's default is the
    TPU's bucketed `approx_max_k`; on its CPU backend that is exact too. Ties are
    common: NMS and the border band leave most of the map at -inf, and
    where fewer than K maxima survive the remaining slots are -inf ties
    whose positions still reach the rays and descriptors.
  * Filters are shift-and-add with the reference's taps in its order, not
    `conv2d`: another summation order changes the response in its last bits
    and reorders near-equal corners at the K-th boundary.
  * NMS is `max_pool2d` (stride 1, no padding) over the wrap-padded map,
    one separable pass per axis: exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class Keypoints(NamedTuple):
    rows: torch.Tensor      # (K,) f32 subpixel row
    cols: torch.Tensor      # (K,) f32 subpixel col
    response: torch.Tensor  # (K,) f32 Harris response
    valid: torch.Tensor     # (K,) bool


def _wrap_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad rows with edge values, columns circularly (azimuth wrap)."""
    img = torch.cat([img[:, -pad:], img, img[:, :pad]], dim=1)
    return torch.cat([img[:1].expand(pad, -1), img, img[-1:].expand(pad, -1)], dim=0)


def _conv2_sep(img: torch.Tensor, kr: np.ndarray, kc: np.ndarray) -> torch.Tensor:
    """Separable 2D filter with wrap-padded borders, as shift-and-add over the
    taps in the reference's order (Python's `sum`, from 0)."""
    pr, pc = kr.shape[0] // 2, kc.shape[0] // 2
    h, w = img.shape
    off = max(pr, pc, 1)
    x = _wrap_pad(img, off) if (pr or pc) else img
    if pr:
        x = sum(float(kr[i]) * x[off - pr + i:off - pr + i + h] for i in range(kr.shape[0]))
    else:
        x = x[off:off + h]
    if pc:
        x = sum(float(kc[j]) * x[:, off - pc + j:off - pc + j + w] for j in range(kc.shape[0]))
    else:
        x = x[:, off:off + w]
    return x


_GAUSS5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
_DERIV = np.array([-0.5, 0.0, 0.5], np.float32)
_ONE = np.array([1.0], np.float32)


def gaussian_smooth(img: torch.Tensor) -> torch.Tensor:
    return _conv2_sep(img, _GAUSS5, _GAUSS5)


def harris_response(img: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """Harris corner response with a Gaussian-windowed structure tensor."""
    ix = _conv2_sep(img, _ONE, _DERIV)
    iy = _conv2_sep(img, _DERIV, _ONE)
    sxx = _conv2_sep(ix * ix, _GAUSS5, _GAUSS5)
    syy = _conv2_sep(iy * iy, _GAUSS5, _GAUSS5)
    sxy = _conv2_sep(ix * iy, _GAUSS5, _GAUSS5)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def nms_local_max(resp: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Keep the responses that equal the max of their (2r+1)^2 window (wrap
    columns); plateau maxima stay, as in the reference."""
    win = 2 * radius + 1
    x = _wrap_pad(resp, radius)[None, None]
    mx = F.max_pool2d(F.max_pool2d(x, (win, 1), stride=1), (1, win), stride=1)[0, 0]
    return torch.where(resp >= mx, resp, -torch.inf)


def top_k_ordered(flat: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries in `lax.top_k`'s order:
    value descending, ties by lower index."""
    vals, idx = torch.sort(flat, descending=True, stable=True)
    return vals[:k], idx[:k]


def detect(pano: torch.Tensor, max_features: int, threshold: float = 1e-6,
           nms_radius: int = 1, border_rows: int = 12) -> Keypoints:
    """Up to K Harris corners, with a validity mask: response > threshold *
    the largest selected response. `border_rows` rows are excluded at top
    and bottom."""
    h, w = pano.shape
    smoothed = gaussian_smooth(pano)
    resp_raw = harris_response(smoothed)  # also used for the subpixel fit
    resp = nms_local_max(resp_raw, nms_radius)
    row_ids = torch.arange(h, device=pano.device)[:, None]
    resp = torch.where((row_ids >= border_rows) & (row_ids < h - border_rows), resp, -torch.inf)

    vals, idx = top_k_ordered(resp.reshape(-1), max_features)
    r_i = idx // w
    c_i = idx % w
    scale = torch.clamp_min(torch.max(vals), 1e-12)
    valid = vals > threshold * scale

    # Subpixel refinement: a 1D parabola through the response along each axis.
    c0 = resp_raw[r_i, c_i]

    def refined(m, p):
        denom = m - 2.0 * c0 + p
        off = torch.where(torch.abs(denom) > 1e-12, 0.5 * (m - p) / denom, 0.0)
        return torch.clamp(off, -0.5, 0.5)

    d_row = refined(resp_raw[torch.clamp(r_i - 1, 0, h - 1), c_i],
                    resp_raw[torch.clamp(r_i + 1, 0, h - 1), c_i])
    d_col = refined(resp_raw[r_i, torch.remainder(c_i - 1, w)],
                    resp_raw[r_i, torch.remainder(c_i + 1, w)])
    return Keypoints(rows=r_i.to(torch.float32) + d_row, cols=c_i.to(torch.float32) + d_col,
                     response=vals, valid=valid)
