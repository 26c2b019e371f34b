"""Slot-by-slot comparison of two runs of the frontend's keypoint selection.

Used by chip_smoke.py (the frontend on the card against the port on the
CPU) and by the parity tests (the port against the JAX package). Both
select the top K of a response map in the same order (value descending,
ties by lower index), so the slots agree one for one, except where two
responses are within rounding of each other: two f32 computations of the
same map may then order the pair the other way round, or, at the K-th
value, select the other one. `slot_mismatches` finds the slots whose
positions differ and whether each such slot has that excuse.
"""

from __future__ import annotations

import numpy as np

from sosvo_torch.frontend.akaze import extract_akaze
from sosvo_torch.frontend.detect import Keypoints, detect
from sosvo_torch.frontend.image_frontend import FrontendLUTs, akaze_args, detect_args
from sosvo_torch.frontend.panorama import warp_panorama
from sosvo_torch.utils.config import FrontendConfig


def view_keypoints(luts: FrontendLUTs, cfg: FrontendConfig, image) -> tuple[Keypoints, Keypoints]:
    """The keypoints `extract_observations` selects in the top and the
    bottom panorama of `image` (one pyramid level: `n_scales=1`; AKAZE's
    detector, which takes no pyramid, for `descriptor="akaze"`)."""
    if cfg.descriptor == "akaze":
        return tuple(extract_akaze(warp_panorama(image, g), cfg.max_features,
                                   **akaze_args(cfg))[0] for g in (luts.top, luts.bottom))
    if cfg.n_scales != 1:
        raise ValueError("view_keypoints reads the full-resolution level only")
    return tuple(detect(warp_panorama(image, g), cfg.max_features, **detect_args(cfg))
                 for g in (luts.top, luts.bottom))


def slot_mismatches(ref_rows, ref_cols, ref_response, got_rows, got_cols, width: int,
                    tol: float) -> tuple[np.ndarray, np.ndarray]:
    """(differ, unexplained) boolean (K,) masks over the slots of two
    selections. A slot differs where its positions are half a pixel or more
    apart (columns modulo `width`). A differing slot is explained where the
    reference's response there lies within `tol` of a neighbouring slot's
    (a near-tie that two roundings may order either way) or of the K-th
    value (the selection's boundary). Responses are the reference's, in its
    descending slot order; -inf slots are exact ties and are never excused."""
    rows = [np.asarray(x, np.float64) for x in (ref_rows, got_rows)]
    cols = [np.asarray(x, np.float64) for x in (ref_cols, got_cols)]
    dc = np.abs(cols[0] - cols[1])
    differ = (np.abs(rows[0] - rows[1]) >= 0.5) | (np.minimum(dc, width - dc) >= 0.5)
    resp = np.asarray(ref_response, np.float64)
    gap = np.where(np.isfinite(resp[:-1]) & np.isfinite(resp[1:]), resp[:-1] - resp[1:], np.inf)
    near = np.zeros(resp.shape, bool)
    near[:-1] |= gap <= tol
    near[1:] |= gap <= tol
    near |= np.isfinite(resp) & (np.abs(resp - resp[-1]) <= tol)
    return differ, differ & ~near
