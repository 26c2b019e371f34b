"""Descriptor matching: Hamming distance + ratio test + cross-check, plain
torch.

Counterpart of `sosvo/frontend/match.py`. The Hamming statistics
`match_stats` are the plain twin of the CUDA kernel in
`sosvo_torch/kernels/match_cuda.py`: that wrapper runs `match_stats` for CPU
tensors, and `chip_smoke.py` holds the kernel against it on the card.

Hamming distance between 256-bit descriptors is a +/-1 matmul:
    hamming(a, b) = (NBITS - <bits(a)*2-1, bits(b)*2-1>) / 2,
exact in f32 (integers up to 256). Invalid rows/columns and pairs outside the
stereo azimuth band get an additive +BIG, in the reference's order
(d + pen_row + pen_col, then the band term), so the two implementations
agree bit for bit. `metric_params` says which matcher and threshold a
frontend configuration's descriptor family takes, as the family's module
(`frontend/families/<descriptor>.py`) states them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vobench.reference.frontend.families import family

NBITS = 256
WORDS = NBITS // 32
BIG = 1e9  # exactly representable in f32


class MatchResult(NamedTuple):
    """Fixed-size match set from A-features to B-features."""

    idx_b: torch.Tensor   # (KA,) int64 matched B index (always in [0, KB))
    dist: torch.Tensor    # (KA,) float32 best Hamming distance
    valid: torch.Tensor   # (KA,) bool: ratio test, cross-check, threshold, masks


class MatchStats(NamedTuple):
    """What the matcher reduces the penalized distance matrix to."""

    d_best: torch.Tensor      # (KA,) f32 row minimum
    d_second: torch.Tensor    # (KA,) f32 row minimum with the best column masked
    idx_b: torch.Tensor       # (KA,) int32 row argmin (first index on ties)
    col_argmin: torch.Tensor  # (KB,) int32 column argmin (first index on ties)


def unpack_bits_pm1(desc: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(..., WORDS) int32 bit patterns -> (..., NBITS) +/-1 values.

    Arithmetic right shift on int32 then `& 1` reads every bit, bit 31 too.
    """
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., :, None] >> shifts) & 1
    bits = bits.reshape(desc.shape[:-1] + (NBITS,))
    return (bits.to(dtype) * 2.0 - 1.0)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(KA, KB) Hamming distances via the +/-1 f32 matmul (exact)."""
    dot = unpack_bits_pm1(desc_a) @ unpack_bits_pm1(desc_b).T
    return (NBITS - dot) * 0.5


def column_band_penalty(cols_a: torch.Tensor, cols_b: torch.Tensor, max_delta: float,
                        wrap: float | None = None) -> torch.Tensor:
    """(KA, KB) additive penalty: BIG outside the +/-max_delta (wrapped) band."""
    d = cols_a[:, None] - cols_b[None, :]
    if wrap is not None:
        half = wrap / 2.0
        d = torch.where(d > half, d - wrap, d)
        d = torch.where(d < -half, d + wrap, d)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    return torch.where(torch.abs(d) <= max_delta, zero, zero + BIG)


def metric_params(fe) -> tuple[str, float]:
    """(metric, max_distance) of a FrontendConfig's descriptor family: every
    stage that matches descriptors routes through it."""
    return family(fe.descriptor).metric_params(fe)


def _pen(valid: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(valid, zero, zero + BIG)


def match_stats(desc_a, desc_b, valid_a, valid_b, az_a=None, az_b=None,
                band: float = 0.0) -> MatchStats:
    """Plain matcher statistics: the CUDA kernel's contract. `band` <= 0
    means no azimuth band."""
    return _reduce(hamming_matrix(desc_a, desc_b), valid_a, valid_b, az_a, az_b, band)


def _reduce(dmat, valid_a, valid_b, az_a, az_b, band: float) -> MatchStats:
    """The statistics of a distance matrix with the validity and band
    penalties added in the reference's order."""
    dmat = dmat + _pen(valid_a)[:, None] + _pen(valid_b)[None, :]
    if band > 0.0:
        dmat = dmat + column_band_penalty(az_a, az_b, band, wrap=2.0 * math.pi)
    d_best = torch.amin(dmat, dim=1)
    best_b = torch.argmin(dmat, dim=1)  # first index on ties, as jnp.argmin
    cols = torch.arange(dmat.shape[1], device=dmat.device)
    d_second = torch.min(torch.where(cols[None, :] == best_b[:, None], math.inf, dmat), dim=1).values
    col_argmin = torch.argmin(dmat, dim=0)
    return MatchStats(d_best, d_second, best_b.to(torch.int32), col_argmin.to(torch.int32))


def match_from_stats(stats: MatchStats, valid_a: torch.Tensor, max_distance: float,
                     ratio: float) -> MatchResult:
    """Distance threshold, strict ratio test and cross-check on the stats.

    Strict inequality: an exactly ambiguous best (d_best == d_second) fails.
    """
    idx_b = stats.idx_b.long()
    rows = torch.arange(idx_b.shape[0], dtype=torch.int32, device=idx_b.device)
    ok = (valid_a & (stats.d_best <= max_distance) & (stats.d_best < ratio * stats.d_second)
          & (stats.col_argmin[idx_b] == rows))
    return MatchResult(idx_b=idx_b, dist=stats.d_best, valid=ok)

