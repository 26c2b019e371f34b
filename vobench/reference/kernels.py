"""The reference's matcher and Schur reduction: plain torch on any device.

These take the place of the program's two CUDA kernels and their wrappers.
The Hamming statistics are `frontend.match.match_stats` (an exact integer
distance matrix), the Schur reduction is `inv3x3` of the damped landmark
blocks followed by `schur_terms` and `assemble_camera_system`, as their
contracts define them. Nothing here launches a hand-written kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.backend.schur import assemble_camera_system, inv3x3, schur_terms
from vobench.reference.frontend.match import MatchResult, match_from_stats, match_stats


class SchurParts(NamedTuple):
    S_off: torch.Tensor     # (W, W, 6, 6) sum_l A H_cl^T
    b_sub: torch.Tensor     # (W, 6) sum_l A b_l
    H_ll_inv: torch.Tensor  # (L, 3, 3) (H_ll + lam I)^-1
    S: torch.Tensor         # (W, W, 6, 6) blockdiag(H_cc [+ lam I]) - S_off
    b_red: torch.Tensor     # (W, 6) b_c - b_sub


def match_metric(metric: str, desc_a: torch.Tensor, desc_b: torch.Tensor,
                 valid_a: torch.Tensor, valid_b: torch.Tensor, max_distance: float,
                 ratio: float, az_a: torch.Tensor | None = None,
                 az_b: torch.Tensor | None = None, band: float = 0.0) -> MatchResult:
    """Ratio-tested, cross-checked matching of Hamming words through the
    plain statistics."""
    if metric != "hamming":
        raise ValueError(f"the reference matches Hamming words only, not {metric!r}")
    stats = match_stats(desc_a, desc_b, valid_a, valid_b, az_a, az_b, band)
    return match_from_stats(stats, valid_a, max_distance, ratio)


def schur_parts(H_cc, H_cl, H_ll, b_c, b_l, lam, damp_H_cc: bool = True) -> SchurParts:
    """The damped landmark inverses, S_off, b_sub and the reduced system."""
    eye3 = torch.eye(3, dtype=H_ll.dtype, device=H_ll.device)
    H_ll_inv = inv3x3(H_ll + lam * eye3[None])
    S_off, b_sub = schur_terms(H_cl, H_ll_inv, b_l)
    if damp_H_cc:
        H_cc = H_cc + lam * torch.eye(6, dtype=H_cc.dtype, device=H_cc.device)[None]
    S, b_red = assemble_camera_system(H_cc, b_c, S_off, b_sub)
    return SchurParts(S_off, b_sub, H_ll_inv, S, b_red)


def reduce_camera_system(H_cc, H_cl, H_ll, b_c, b_l, lam, damp_H_cc: bool = True):
    """(S, b_red, H_ll_inv) of one window."""
    parts = schur_parts(H_cc, H_cl, H_ll, b_c, b_l, lam, damp_H_cc)
    return parts.S, parts.b_red, parts.H_ll_inv
