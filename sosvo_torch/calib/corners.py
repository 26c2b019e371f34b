"""Chessboard corner detection from raw omni images (counterpart of
`sosvo/calib/corners.py`).

The detector is host-side numpy and scipy, copied from the reference (the
port imports nothing of the JAX package): saddle detection on -det(Hessian)
of the smoothed image with non-max suppression and quadratic subpixel
refinement, then lattice growing with locally extrapolated steps, which
follows the catadioptric warp. The symmetry resolution and the observation
bundle run on the rig's device through the port's own model: each
(top, bottom) dihedral orientation is lifted, stereo-triangulated and
Umeyama-fitted to the known grid, and the best fit wins (a reflected
assignment cannot fit: Umeyama returns a proper rotation).

The output is `calib.boards.BoardObservations`, what `fit_rig_full_gum`
consumes: images -> board_observations_from_images -> fit -> rig JSON.
"""

from __future__ import annotations

import numpy as np
import torch

from sosvo_torch.calib.boards import BoardObservations, make_board_grid


def _gaussian_smooth_np(img: np.ndarray, sigma: float) -> np.ndarray:
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(img.astype(np.float64), sigma, mode="nearest")


def detect_saddles(
    img: np.ndarray,
    mask: np.ndarray | None = None,
    max_corners: int = 256,
    sigma: float = 1.5,
    rel_threshold: float = 0.12,
    nms_radius: int = 3,
) -> tuple[np.ndarray, np.ndarray]:
    """((N, 2) subpixel (u, v) saddle points, (N,) strengths), strongest
    first.

    Response = -det(Hessian) of the smoothed image: positive at saddles
    (X-corners), negative at blobs/ridges, so thresholding needs no corner
    template and is rotation invariant -- important because azimuth rotates
    the checker orientation continuously around the omni annulus.
    """
    from scipy.ndimage import maximum_filter

    g = _gaussian_smooth_np(img, sigma)
    gy, gx = np.gradient(g)
    gxy, gxx = np.gradient(gx)
    gyy, _ = np.gradient(gy)
    resp = gxy * gxy - gxx * gyy               # -det(H) > 0 at saddles
    if mask is not None:
        resp = np.where(mask, resp, 0.0)
    peak = (resp == maximum_filter(resp, size=2 * nms_radius + 1)) \
        & (resp > rel_threshold * resp.max())
    vs, us = np.nonzero(peak)
    order = np.argsort(resp[vs, us])[::-1][:max_corners]
    vs, us = vs[order], us[order]

    # Subpixel: quadratic fit of the response surface in the 3x3 patch.
    h, w = resp.shape
    out = []
    for v, u in zip(vs, us):
        if 1 <= v < h - 1 and 1 <= u < w - 1:
            p = resp[v - 1:v + 2, u - 1:u + 2]
            du = 0.5 * (p[1, 2] - p[1, 0])
            dv = 0.5 * (p[2, 1] - p[0, 1])
            duu = p[1, 2] - 2 * p[1, 1] + p[1, 0]
            dvv = p[2, 1] - 2 * p[1, 1] + p[0, 1]
            duv = 0.25 * (p[2, 2] - p[2, 0] - p[0, 2] + p[0, 0])
            det = duu * dvv - duv * duv
            if abs(det) > 1e-12:
                ou = -(dvv * du - duv * dv) / det
                ov = -(duu * dv - duv * du) / det
                if abs(ou) < 1.0 and abs(ov) < 1.0:
                    out.append((u + ou, v + ov))
                    continue
        out.append((float(u), float(v)))
    return (np.asarray(out, np.float64).reshape(-1, 2),
            resp[vs, us].astype(np.float64))


def grow_grid(pts: np.ndarray, nx: int, ny: int,
              strengths: np.ndarray | None = None) -> np.ndarray | None:
    """Assign lattice coordinates to detected saddle points.

    Returns (nx, ny, 3): [:, :, :2] = (u, v), [:, :, 2] = found flag; or
    None when no (nx, ny)-compatible lattice emerges. Orientation is
    arbitrary (resolved later against the rig's stereo geometry).

    BFS with LOCALLY EXTRAPOLATED steps: the prediction for cell (i+1, j) is
    2 p(i, j) - p(i-1, j) (or a nearby parallel edge when there is no
    opposite neighbor), so the lattice follows the annulus curvature --
    steps rotate gradually and a global basis would drift off within a few
    cells on an omni image.

    An OVERSIZED lattice (the border squares' T-junctions are
    lattice-consistent one-square continuations of the inner X-corners, so
    the BFS happily annexes them) is trimmed to the (nx, ny) subwindow with
    the largest summed saddle `strengths` -- true X-corners respond far
    stronger than border T-corners, so the inner grid wins.
    """
    n = len(pts)
    if n < 4:
        return None
    centroid = pts.mean(axis=0)
    seed = int(np.argmin(np.linalg.norm(pts - centroid, axis=1)))
    d_seed = np.linalg.norm(pts - pts[seed], axis=1)
    order = np.argsort(d_seed)
    n1 = int(order[1])
    u_vec = pts[n1] - pts[seed]
    vi = None
    for cand in order[2:]:
        wv = pts[cand] - pts[seed]
        cosang = abs(np.dot(u_vec, wv)) / (np.linalg.norm(u_vec) * np.linalg.norm(wv) + 1e-12)
        ratio = np.linalg.norm(wv) / (np.linalg.norm(u_vec) + 1e-12)
        if cosang < 0.7 and 0.25 < ratio < 4.0:
            vi = int(cand)
            break
    if vi is None:
        return None

    grid = {(0, 0): seed, (1, 0): n1, (0, 1): vi}
    used = {seed, n1, vi}
    changed = True
    while changed:
        changed = False
        for (i, j), idx in list(grid.items()):
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                tgt = (i + di, j + dj)
                if tgt in grid:
                    continue
                opp = (i - di, j - dj)
                if opp in grid:
                    step = pts[idx] - pts[grid[opp]]
                else:
                    step = None
                    for (pi, pj), pidx in grid.items():
                        q = (pi + di, pj + dj)
                        if q in grid and abs(pi - i) + abs(pj - j) <= 2:
                            step = pts[grid[q]] - pts[pidx]
                            break
                    if step is None:
                        continue
                pred = pts[idx] + step
                tol = 0.35 * np.linalg.norm(step)
                d = np.linalg.norm(pts - pred, axis=1)
                d[list(used)] = np.inf
                best = int(np.argmin(d))
                if d[best] < tol:
                    grid[tgt] = best
                    used.add(best)
                    changed = True

    if strengths is None:
        strengths = np.ones(n)
    ii = np.asarray([k[0] for k in grid])
    jj = np.asarray([k[1] for k in grid])
    ii -= ii.min()
    jj -= jj.min()
    di, dj = ii.max() + 1, jj.max() + 1
    full = np.zeros((di, dj, 3))
    s_full = np.zeros((di, dj))
    for (key, idx), i2, j2 in zip(grid.items(), ii, jj):
        full[i2, j2, :2] = pts[idx]
        full[i2, j2, 2] = 1.0
        s_full[i2, j2] = strengths[idx]
    # Strongest (nx, ny) subwindow over BOTH orientations (the border ring
    # can pad the lattice square -- e.g. a 4x5 true block inside 6x6 -- so
    # the transpose decision belongs to the window search, not the raw dims).
    #
    # Scoring (three measured failure modes shaped this):
    #   + count of STRONG cells -- true X-corners cluster ~4x stronger than
    #     the pattern-border T-junction saddles (0.012-0.013 vs 0.003);
    #   - penalty for WEAK-filled cells: a border saddle inside the window
    #     means the window overruns the pattern edge (the border row sits
    #     exactly one square outside the inner corners, ON the board plane,
    #     so no downstream geometric check can catch the mislabeling);
    #   o the search range is PADDED one cell beyond the grown extent: when
    #     a whole corner row is clipped by the annulus mask (measured on a
    #     board at the elevation limit), the correct window extends into
    #     empty cells on the clipped side -- empty must beat border-filled,
    #     and the pad makes that window exist at all.
    member_s = s_full[s_full > 0]
    thr = 0.6 * float(np.median(member_s)) if member_s.size else 0.0
    total_s = float(s_full.sum()) + 1e-12
    pad = 1
    sp = np.zeros((di + 2 * pad, dj + 2 * pad))
    sp[pad:pad + di, pad:pad + dj] = s_full
    fp = np.zeros((di + 2 * pad, dj + 2 * pad, 3))
    fp[pad:pad + di, pad:pad + dj] = full
    best = None
    for wx, wy, transpose in ((nx, ny, False), (ny, nx, True)):
        if di + 2 * pad < wx or dj + 2 * pad < wy:
            continue
        for oi in range(di + 2 * pad - wx + 1):
            for oj in range(dj + 2 * pad - wy + 1):
                swin = sp[oi:oi + wx, oj:oj + wy]
                strong = swin > thr
                weak = (swin > 0) & ~strong
                s = (float(strong.sum()) - 0.25 * float(weak.sum())
                     + 0.5 * swin.sum() / total_s)
                if best is None or s > best[0]:
                    best = (s, oi, oj, wx, wy, transpose)
    if best is None:
        return None
    _, oi, oj, wx, wy, transpose = best
    out = fp[oi:oi + wx, oj:oj + wy]
    if transpose:
        out = np.swapaxes(out, 0, 1)
    if out[..., 2].sum() < 0.8 * nx * ny:
        return None
    return out


_SYMMETRIES = ((False, False), (True, False), (False, True), (True, True))


def _apply_sym(g: np.ndarray, flip_i: bool, flip_j: bool) -> np.ndarray:
    if flip_i:
        g = g[::-1]
    if flip_j:
        g = g[:, ::-1]
    return g


def resolve_symmetry(rig, grid_pts: torch.Tensor, g_top: np.ndarray, g_bot: np.ndarray):
    """Pick the (top, bottom) dihedral orientation pair that the rig's own
    stereo geometry supports: triangulate the corners seen in both views and
    Umeyama-fit them to the known grid (`grid_pts`, on the rig's device).

    Returns (top grid, bottom grid, residual), `residual` the weighted mean
    squared 3D fit error (m^2) of the winning pair, a per-board quality score
    (a lattice grown one cell off the board still wins the ranking but fits
    the rigid grid badly); None when no pair shares 6 corners."""
    from sosvo_torch.geometry.align import umeyama
    from sosvo_torch.geometry.triangulate import midpoint_triangulate
    from sosvo_torch.sensor.model import lift, viewpoint

    device = grid_pts.device
    # Lift each view once: a dihedral flip only permutes the detections.
    tops = [_apply_sym(g_top, *s).reshape(-1, 3) for s in _SYMMETRIES]
    bots = [_apply_sym(g_bot, *s).reshape(-1, 3) for s in _SYMMETRIES]

    def lifted(view, grids):
        return [lift(view, torch.as_tensor(g[:, :2], dtype=torch.float32, device=device))
                for g in grids]

    lift_t, lift_b = lifted(rig.top, tops), lifted(rig.bottom, bots)
    c_t, c_b = viewpoint(rig.top), viewpoint(rig.bottom)

    best = None
    for gt_, (ray_t, ok_t) in zip(tops, lift_t):
        for gb_, (ray_b, ok_b) in zip(bots, lift_b):
            w = (gt_[:, 2] * gb_[:, 2]).astype(np.float32)
            if w.sum() < 6:
                continue
            tri = midpoint_triangulate(ray_t, ray_b, c_t.expand(ray_t.shape),
                                       c_b.expand(ray_b.shape))
            ww = torch.as_tensor(w, device=device) * ok_t * ok_b * tri.valid
            T, _ = umeyama(grid_pts, tri.points, weights=ww)
            fit = grid_pts @ T[:3, :3].T + T[:3, 3]
            res = float(torch.sum(torch.sum((fit - tri.points) ** 2, -1) * ww)
                        / torch.clamp_min(torch.sum(ww), 1e-9))
            if best is None or res < best[0]:
                best = (res, gt_, gb_)
    if best is None:
        return None
    return best[1], best[2], best[0]


def board_observations_from_images(rig, images, nx: int = 5, ny: int = 4, square: float = 0.07,
                                   erode_annulus: int = 4, board_residual_ratio: float = 4.0
                                   ) -> BoardObservations | None:
    """(M, H, W) raw omni board captures (numpy or a tensor) ->
    BoardObservations on the rig's device, or None if no board passes
    detection and the quality gate.

    Each image holds the same board twice (inner annulus: bottom mirror,
    outer: top); detection runs per view on the annulus-masked image so the
    two lattices never merge. A board whose winning symmetry fits the rigid
    grid worse than `board_residual_ratio` x the median board's residual is
    dropped (a lattice grown one cell off the board is a coherent outlier
    that per-corner robust weights cannot reject); the gate is relative
    because the residual floor scales with how wrong the prior rig is.
    """
    from scipy.ndimage import binary_erosion

    from sosvo_torch.sensor.model import annulus_mask

    device = rig.top.fx.device
    images = images.detach().cpu().numpy() if isinstance(images, torch.Tensor) \
        else np.asarray(images)
    h, w = images.shape[-2:]
    masks = {name: binary_erosion(annulus_mask(view, h, w).cpu().numpy(),
                                  iterations=erode_annulus)
             for name, view in (("top", rig.top), ("bottom", rig.bottom))}

    grid_pts = make_board_grid(nx, ny, square, device=device)
    g = nx * ny
    cands = []
    for img in images:
        grids = {}
        for name in ("top", "bottom"):
            pts, strengths = detect_saddles(img, masks[name], max_corners=4 * g)
            grids[name] = grow_grid(pts, nx, ny, strengths)
        if grids["top"] is None or grids["bottom"] is None:
            continue  # board dropped
        resolved = resolve_symmetry(rig, grid_pts, grids["top"], grids["bottom"])
        if resolved is not None:
            cands.append(resolved)
    if not cands:
        return None
    med = float(np.median([res for _, _, res in cands]))
    kept = [(gt_, gb_) for gt_, gb_, res in cands
            if res <= board_residual_ratio * max(med, 1e-12)]
    if not kept:
        return None

    def stacked(x):
        return torch.as_tensor(np.stack(x), dtype=torch.float32, device=device)

    # Only surviving boards are kept: a dropped board would leave a
    # zero-weight pose block whose closed-form init can reach the residuals
    # as NaN * 0.
    return BoardObservations(pts_board=grid_pts,
                             uv_top=stacked([gt_[:, :2] for gt_, _ in kept]),
                             w_top=stacked([gt_[:, 2] for gt_, _ in kept]),
                             uv_bottom=stacked([gb_[:, :2] for _, gb_ in kept]),
                             w_bottom=stacked([gb_[:, 2] for _, gb_ in kept]))
