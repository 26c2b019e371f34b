"""Landmark-sharded windowed BA (config c5; counterpart of `sosvo/dist/ba_dist.py`).

The solver is the single-rank one (`sosvo_torch/backend/ba.py`) with the
mesh's "model" axis: rank i of D holds the contiguous landmark block
[i L/D, (i+1) L/D) (the JAX package's `P("model")` on the landmark axis,
`_window_specs`), reduces its own shard's camera-system terms, and the
landmark sums go through the axis's all-reduce; the small camera solve is
the same on every rank, and each rank back-substitutes its own landmarks.
Poses come out replicated; the landmarks are gathered back so every rank
holds the whole refined window. L must divide by D.
"""

from __future__ import annotations

from sosvo_torch.backend.ba import BAResult, BAWindow, ba_solve
from sosvo_torch.dist.mesh import MODEL_AXIS, Mesh
from sosvo_torch.vo.keyframes import landmark_shard


def ba_solve_sharded(mesh: Mesh, win: BAWindow, iters: int = 5, lam0: float = 1e-3,
                     anchor=0, huber_delta: float | None = None) -> BAResult:
    """Solve the (replicated) window `win` with its landmarks sharded over
    `mesh`'s model axis; every rank returns the same result."""
    axis = mesh.axis(MODEL_AXIS)
    res = ba_solve(landmark_shard(win, axis), iters=iters, lam0=lam0, anchor=anchor,
                   huber_delta=huber_delta, axis=axis)
    return res._replace(landmarks=axis.all_gather(res.landmarks))
