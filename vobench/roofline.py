"""The benchmark's frozen yardstick for the two kernels' roofline shares.

The least time an H100 could take for each kernel's work (its bound).

The bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the card's memory rate, and
the operations it does on these inputs over the card's peak rate for their
type. Peaks are NVIDIA's data-sheet figures for the H100 SXM at its 700 W
power limit, dense: 3.35 TB/s of HBM3, 67 TFLOP/s of f32 outside the tensor
cores, 1979 TOP/s of int8 in the tensor cores. The data sheet gives no rate
for b1 (binary AND/popc) products, so B1_OP_PER_S is measured by
the program's `tools/mma_rate.py` probe on an NVIDIA H100 80GB HBM3 at 700.00 W,
counting two operations per bit pair as the int8 rate counts a multiply-add:
the faster of its two b1 forms at 1024 iterations, wgmma m64n256k256
(1.574104e16; mma.sync m16n8k256 gave 9.688161e15). The same tool's wgmma
int8 loop reached 1.967325e15, 99.4 % of the data sheet's int8 rate, so the
b1 reading is the card's rate and not the probe's.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12
B1_OP_PER_S = 1.574104e16
# The matcher's distances run at the faster tensor-core form of the same work.
MATCHER_OP_PER_S = max(INT8_OP_PER_S, B1_OP_PER_S)


def matcher_work(ka: int, kb: int, band: bool) -> tuple[float, float]:
    """(bytes, operations) of one Hamming-match statistics call at ka x kb:
    `matcher_bound_ms` says what they count."""
    n_in = (ka + kb) * (32 + 1 + (4 if band else 0))
    n_out = ka * 12 + kb * 4
    return float(n_in + n_out), 2.0 * ka * kb * 256


def schur_work(W: int, L: int) -> tuple[float, float]:
    """(bytes, f32 operations) of one Schur reduction of a W x L window:
    `schur_bound_ms` says what they count."""
    n = 6 * W
    n_bytes = 4 * (W * L * 18 + 9 * L + 3 * L + 36 * W + 6 * W + 1
                   + 9 * L + n * n + n)
    return float(n_bytes), float(L * (3 * n * (n + 1) + 18 * n + 6 * n + 40))


def _bound(n_bytes: float, ops: float, op_rate: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / op_rate
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def matcher_bound_ms(ka: int, kb: int, band: bool) -> tuple[float, str]:
    """(ms, what bounds it) for one Hamming-match statistics call at ka x kb.

    Bytes: 32-byte descriptors and a validity byte per row and column (and
    an f32 azimuth each with the band) in; the contract's outputs, best,
    second and argmin per row (3 x 4 bytes) and the int32 column argmin,
    out. Operations: the distances over 256 bits, 2 * ka * kb * 256, at the
    faster of the two tensor-core forms of the same work: a +/-1 int8
    product at the data sheet's int8 rate, or the b1 AND/popc product at its
    measured wgmma rate. The b1 rate is the faster (B1_OP_PER_S, 8x int8),
    so it bounds the operations; at 512 x 512 the bytes bound the call.
    """
    return _bound(*matcher_work(ka, kb, band), MATCHER_OP_PER_S)


def schur_bound_ms(W: int, L: int) -> tuple[float, str]:
    """(ms, what bounds it) for one Schur reduction of a W x L window.

    Bytes (f32): H_cl (W L 18), H_ll (9 L), b_l (3 L), H_cc (36 W), b_c
    (6 W) and lam in; the contract's outputs H_ll_inv (9 L), S ((6W)^2)
    and b_red (6 W) out. Operations per landmark: 3 n (n + 1) for the
    symmetric S_off (n = 6W; one multiply-add over k = 1..3 for each entry
    of its upper triangle), 2 n 9 for A, 2 n 3 for b_sub, and about 40 for
    the damped adjugate inverse.
    """
    return _bound(*schur_work(W, L), F32_FLOP_PER_S)
