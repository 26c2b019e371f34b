"""Which Cholesky the essential-matrix fits use on the card, by measurement.

    python -m sosvo_torch.tools.chol_bench

The reference (`sosvo/geometry/essential.py`) unrolls its batched 9x9
Cholesky and the triangular solves into elementwise ops, because that beat
XLA's blocked Cholesky on the TPU. This script times, on the card, the
package's `fit_essential_fast` (library `cholesky_ex` + triangular solves)
against the same fit with the unrolled factor and solves kept below, at
the hypothesis batches of c1 (H=512) and c3 (H=1024), and one 9x9
factorization as the single-instance refit does it. Times are CUDA events
over back-to-back calls, in turns (unrolled, library, library, unrolled);
accuracy is each form's largest difference (sign-aligned) from the same fit
run in float64, over the minimal sets whose normal matrix has a
well-separated null vector (the sets the CPU parity test compares), and
over all sets.
"""

from __future__ import annotations

import torch

from sosvo_torch.geom.lie import norm
from sosvo_torch.geometry.essential import _frob, _normal_matrix, _trace, fit_essential_fast
from sosvo_torch.tools.workload import card_info, cuda_ms
from sosvo_torch.utils.device import default_device


def chol9_unrolled(M: torch.Tensor) -> torch.Tensor:
    """The reference's batched 9x9 Cholesky, unrolled; diagonal floored at 1e-12."""
    n = 9
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp_min(s, 1e-12))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    zero = torch.zeros_like(M[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1)
            for i in range(n)]
    return torch.stack(rows, dim=-2)


def chol9_solve_unrolled(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L L^T) x = b by unrolled forward + back substitution; b: (..., 9)."""
    n = 9
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def fit_essential_unrolled(rays1, rays2, weights, iters: int = 2) -> torch.Tensor:
    """`fit_essential_fast` with the unrolled factor and solves."""
    M = _normal_matrix(rays1, rays2, weights)
    scale = _trace(M)[..., None, None] / 9.0 + 1e-12
    eye = torch.eye(9, dtype=M.dtype, device=M.device)
    L = chol9_unrolled(M / scale + 1e-5 * eye)
    v = torch.full(M.shape[:-2] + (9,), 1.0 / 3.0, dtype=M.dtype, device=M.device)
    for _ in range(iters):
        v = chol9_solve_unrolled(L, v)
        v = v / torch.clamp_min(norm(v, keepdim=True), 1e-30)
    E = v.reshape(M.shape[:-2] + (3, 3))
    return E / torch.clamp_min(_frob(E), 1e-12)


def minimal_sets(gen: torch.Generator, h: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, 8, 3) ray pairs of a random rigid motion seen by an omnidirectional
    rig, with 1e-3 relative noise."""
    pts = torch.randn(h, 8, 3, generator=gen, device=device) * 4.0  # all around the rig
    ang = torch.randn(h, 3, generator=gen, device=device) * 0.05
    t = torch.randn(h, 3, generator=gen, device=device) * 0.5
    R = torch.linalg.matrix_exp(torch.linalg.cross(
        torch.eye(3, device=device).expand(h, 3, 3), ang[:, None, :].expand(h, 3, 3), dim=-1))
    p2 = torch.einsum("hij,hnj->hni", R, pts) + t[:, None, :]

    def rays(p):
        noise = torch.randn(p.shape, generator=gen, device=device)
        r = p + noise * 1e-3 * p.norm(dim=-1, keepdim=True)
        return r / r.norm(dim=-1, keepdim=True)

    return rays(pts), rays(p2)


def main() -> None:
    device = default_device()
    print(f"card: {card_info()}", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    for h in (512, 1024):
        r1, r2 = minimal_sets(gen, h, device)
        w = torch.ones(r1.shape[:2], device=device)
        E64 = fit_essential_fast(r1.double(), r2.double(), w.double())
        M = _normal_matrix(r1.double(), r2.double(), w.double())
        ev = torch.linalg.eigvalsh(M / (_trace(M)[:, None, None] / 9.0))
        keep = ev[:, 1] > 1e-3

        def error(E):
            """(separated, all) largest |E - E64| up to sign."""
            E = E.double()
            sign = torch.sign(torch.sum(E * E64, dim=(-2, -1), keepdim=True))
            d = torch.amax(torch.abs(E * sign - E64), dim=(-2, -1))
            return float(d[keep].max()), float(d.max())

        E_lib = fit_essential_fast(r1, r2, w)
        lib_err, unr_err = error(E_lib), error(fit_essential_unrolled(r1, r2, w))
        u1 = cuda_ms(lambda: fit_essential_unrolled(r1, r2, w), 50)
        l1 = cuda_ms(lambda: fit_essential_fast(r1, r2, w), 50)
        l2 = cuda_ms(lambda: fit_essential_fast(r1, r2, w), 50)
        u2 = cuda_ms(lambda: fit_essential_unrolled(r1, r2, w), 50)
        print(f"fit_essential_fast H={h}: library_ms={(l1 + l2) / 2} unrolled_ms={(u1 + u2) / 2} "
              f"turns_ms=[{u1}, {l1}, {l2}, {u2}] "
              f"err_vs_f64_separated library={lib_err[0]} unrolled={unr_err[0]} "
              f"(sets {int(keep.sum())}/{h}) err_vs_f64_all library={lib_err[1]} "
              f"unrolled={unr_err[1]} finite={bool(torch.isfinite(E_lib).all())}",
              flush=True)

    # One 9x9 factorization, as the single-instance refit does it.
    A = torch.randn(9, 9, generator=gen, device=device)
    S = A @ A.T + 1e-5 * torch.eye(9, device=device)
    u1 = cuda_ms(lambda: chol9_unrolled(S), 200)
    l1 = cuda_ms(lambda: torch.linalg.cholesky_ex(S).L, 200)
    l2 = cuda_ms(lambda: torch.linalg.cholesky_ex(S).L, 200)
    u2 = cuda_ms(lambda: chol9_unrolled(S), 200)
    err = float(torch.abs(torch.linalg.cholesky_ex(S).L - chol9_unrolled(S)).max())
    print(f"cholesky 9x9 single: cholesky_ex_ms={(l1 + l2) / 2} unrolled_ms={(u1 + u2) / 2} "
          f"turns_ms=[{u1}, {l1}, {l2}, {u2}] max_abs_diff_L={err}", flush=True)


if __name__ == "__main__":
    main()
