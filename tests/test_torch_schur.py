"""The Schur reduction of BA: the port's plain version against the JAX package.

`reduce_camera_system_cuda` on CPU tensors runs the plain version of the
CUDA kernel (`inv3x3` + `reduce_camera_system`); it is held against the
Pallas kernel as the JAX tests run it (`interpret=True`) and against the XLA
`reduce_camera_system` that the reference's BA runs off the TPU. Inputs are
the blocks of `tests/test_ba.py::_make_window`'s window through the JAX
`build_blocks` (W=5, L=128, and its ragged L=100 slice), and random SPD
blocks from a numpy seed at W=8. Tolerances are the JAX tests' own: 1e-5
relative (to the array's largest magnitude) on S and b_red, 1e-4 on the
inverses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.backend import schur as jschur
from sosvo.backend.ba import build_blocks as jax_build_blocks
from sosvo.kernels.schur_pallas import reduce_camera_system_pallas
from sosvo_torch.backend import schur as tschur
from sosvo_torch.kernels import schur_cuda
from tests.test_ba import _make_window

torch.set_num_threads(1)


def _window_blocks(seed, lam, n_lm=None):
    win, _, _ = _make_window(jax.random.PRNGKey(seed), pose_noise=0.02, lm_noise=0.03,
                             pixel_like_noise=1e-3)
    H_cc, H_cl, H_ll, b_c, b_l, _ = (np.asarray(x) for x in jax_build_blocks(win))
    if n_lm is not None:
        H_cl, H_ll, b_l = H_cl[:, :n_lm], H_ll[:n_lm], b_l[:n_lm]
    return [np.array(x, dtype=np.float32) for x in (H_cc, H_cl, H_ll, b_c, b_l)] + [lam]


def _random_blocks(seed, W, L, lam):
    """SPD landmark and pose blocks with a dense coupling, at BA's scales."""
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((L, 6, 3)).astype(np.float32)
    H_ll = np.einsum("lri,lrj->lij", J, J) + np.eye(3, dtype=np.float32)
    G = rng.standard_normal((W, 8, 6)).astype(np.float32)
    H_cc = 50.0 * (np.einsum("wri,wrj->wij", G, G) + np.eye(6, dtype=np.float32))
    H_cl = rng.standard_normal((W, L, 6, 3)).astype(np.float32)
    b_c = rng.standard_normal((W, 6)).astype(np.float32)
    b_l = rng.standard_normal((L, 3)).astype(np.float32)
    return [x.astype(np.float32) for x in (H_cc, H_cl, H_ll, b_c, b_l)] + [lam]


CASES = {
    "W5_L128": lambda: _window_blocks(21, 1e-3),
    "W5_L100_ragged": lambda: _window_blocks(22, 1e-2, n_lm=100),
    "W8_L300_random": lambda: _random_blocks(0, 8, 300, 1e-3),
}


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref))) / (float(np.max(np.abs(ref))) + 1e-9)


def _port(blocks, damp_H_cc=True):
    *arrays, lam = blocks
    return schur_cuda.reduce_camera_system_cuda(*(torch.from_numpy(a) for a in arrays), lam,
                                                damp_H_cc=damp_H_cc)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_pallas_kernel(case):
    blocks = CASES[case]()
    *arrays, lam = blocks
    S_p, b_p, inv_p = reduce_camera_system_pallas(*(jnp.asarray(a) for a in arrays), lam,
                                                  interpret=True)
    S, b_red, inv = _port(blocks)
    assert _rel(S, S_p) < 1e-5
    assert _rel(b_red, b_p) < 1e-5
    assert _rel(inv, inv_p) < 1e-4


@pytest.mark.parametrize("damp_H_cc", [True, False], ids=["damped", "caller_damped"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_xla_reduction(case, damp_H_cc):
    """Against what the reference's `lm_step` runs off the TPU: the XLA
    `inv3x3` + `reduce_camera_system` (with `damp_H_cc=False` the caller's
    H_cc is used as it is, as `lm_step` passes it)."""
    blocks = CASES[case]()
    (H_cc, H_cl, H_ll, b_c, b_l), lam = [jnp.asarray(a) for a in blocks[:5]], blocks[5]
    H_ll_inv = jschur.inv3x3(H_ll + lam * jnp.eye(3, dtype=H_ll.dtype)[None])
    H_cc_eff = H_cc + lam * jnp.eye(6, dtype=H_cc.dtype)[None] if damp_H_cc else H_cc
    S_ref, b_ref = jschur.reduce_camera_system(H_cc_eff, H_cl, H_ll_inv, b_c, b_l)
    S, b_red, inv = _port(blocks, damp_H_cc)
    assert _rel(S, S_ref) < 1e-5
    assert _rel(b_red, b_ref) < 1e-5
    assert _rel(inv, H_ll_inv) < 1e-4


@pytest.mark.parametrize("case", sorted(CASES))
def test_raw_sums_match_the_reference_einsums(case):
    """The kernel's raw outputs (what chip_smoke.py compares on the card):
    S_off and b_sub, each to its own largest magnitude."""
    blocks = CASES[case]()
    (H_cc, H_cl, H_ll, b_c, b_l), lam = [jnp.asarray(a) for a in blocks[:5]], blocks[5]
    inv = jschur.inv3x3(H_ll + lam * jnp.eye(3, dtype=H_ll.dtype)[None])
    A = jnp.einsum("wlij,ljk->wlik", H_cl, inv)
    S_off_ref = jnp.einsum("wlik,vljk->wvij", A, H_cl)
    b_sub_ref = jnp.einsum("wlik,lk->wi", A, b_l)
    parts = schur_cuda.schur_reduce_plain(*(torch.from_numpy(a) for a in blocks[:5]), lam)
    assert _rel(parts.S_off, S_off_ref) < 1e-5
    assert _rel(parts.b_sub, b_sub_ref) < 1e-5
    # S = blockdiag(H_cc + lam I) - S_off and b_red = b_c - b_sub, exactly.
    W = H_cc.shape[0]
    H_cc_eff = torch.from_numpy(blocks[0]) + lam * torch.eye(6)[None]
    assert torch.equal(parts.S, torch.eye(W)[:, :, None, None] * H_cc_eff[:, None] - parts.S_off)
    assert torch.equal(parts.b_red, torch.from_numpy(blocks[3]) - parts.b_sub)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reduce_camera_system_matches(case):
    """The port's `reduce_camera_system` on the same inverted blocks."""
    blocks = CASES[case]()
    H_cc, H_cl, H_ll, b_c, b_l = blocks[:5]
    inv = np.linalg.inv(H_ll + blocks[5] * np.eye(3, dtype=np.float32)).astype(np.float32)
    S_ref, b_ref = jschur.reduce_camera_system(*(jnp.asarray(a) for a in (H_cc, H_cl, inv, b_c, b_l)))
    S, b_red = tschur.reduce_camera_system(*(torch.from_numpy(a) for a in (H_cc, H_cl, inv, b_c, b_l)))
    assert _rel(S, S_ref) < 1e-5
    assert _rel(b_red, b_ref) < 1e-5


def test_lam_as_a_tensor_equals_lam_as_a_float():
    blocks = CASES["W5_L128"]()
    a = _port(blocks)
    b = _port(blocks[:5] + [torch.tensor(1e-3, dtype=torch.float32)])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_back_substitute_and_pose_updates_match():
    rng = np.random.default_rng(3)
    W, L = 5, 64
    *arrays, _ = _random_blocks(1, W, L, 1e-3)
    H_cc, H_cl, H_ll, b_c, b_l = arrays
    inv = np.linalg.inv(H_ll).astype(np.float32)
    delta_c = (0.01 * rng.standard_normal((W, 6))).astype(np.float32)
    ref = jschur.back_substitute(jnp.asarray(inv), jnp.asarray(H_cl), jnp.asarray(b_l),
                                 jnp.asarray(delta_c))
    got = tschur.back_substitute(torch.from_numpy(inv), torch.from_numpy(H_cl),
                                 torch.from_numpy(b_l), torch.from_numpy(delta_c))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    win, _, _ = _make_window(jax.random.PRNGKey(5), pose_noise=0.02)
    X = np.array(win.X)
    ref = jschur.apply_pose_updates(jnp.asarray(X), jnp.asarray(delta_c))
    got = tschur.apply_pose_updates(torch.from_numpy(X), torch.from_numpy(delta_c))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_kernel_wrapper_needs_cuda_tensors():
    """The CUDA entry point refuses CPU tensors (there is no fallback), and
    the CPU path never counts a launch."""
    blocks = CASES["W5_L128"]()
    schur_cuda.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        schur_cuda.schur_reduce_cuda(*(torch.from_numpy(a) for a in blocks[:5]), blocks[5])
    _port(blocks)
    assert schur_cuda.launches == 0


@pytest.mark.parametrize("W,L", [(5, 512), (8, 4096)])
def test_bound_counts_the_contract(W, L):
    """The kernel's bound counts each input read once and each of the
    contract's outputs (S, b_red, H_ll_inv) written once, and the
    multiply-adds of the symmetric S_off's upper triangle."""
    from sosvo_torch.tools import bounds

    *arrays, lam = _random_blocks(2, W, L, 1e-3)
    n_bytes = sum(a.nbytes for a in arrays) + 4 + sum(o.numel() * 4 for o in _port(arrays + [lam]))
    n = 6 * W
    flops = L * (3 * n * (n + 1) + 18 * n + 6 * n + 40)
    want = max(n_bytes / bounds.HBM_BYTES_PER_S, flops / bounds.F32_FLOP_PER_S) * 1e3
    ms, by = bounds.schur_bound_ms(W, L)
    assert ms == pytest.approx(want, rel=1e-12)
    assert by == "bytes"


def _cluster_order_sums(H_cl, inv, b_l, cluster, resident):
    """float32 sums in the CUDA kernel's order on a card that holds
    `resident` clusters at once (the order, not the kernel's rounding: the
    kernel fuses each multiply-add, numpy rounds the product and the sum): CTA b of the K clusters of `cluster`
    CTAs sums tiles b, b + K C, ...; in each tile, thread (pair, group) adds landmarks group,
    group + G, ... one k at a time into its block of S_off and b_sub; each
    CTA adds its groups in four chains (g mod 4, each in order) and then
    (c0 + c1) + (c2 + c3), each cluster its ranks in order, and the
    clusters are added in order. Returns (S_off (W, W, 6, 6), b_sub (W, 6))
    with the upper block triangle mirrored, as the kernel writes it."""
    W, L = H_cl.shape[:2]
    n = 6 * W
    clusters, tile, groups = schur_cuda.schedule(W, L, cluster, resident)
    ctas = clusters * cluster
    A = np.einsum("wlij,ljk->lkwi", H_cl, inv).reshape(L, 3, n).astype(np.float32)
    H = H_cl.transpose(1, 3, 0, 2).reshape(L, 3, n)
    seqs = [[[] for _ in range(groups)] for _ in range(ctas)]
    for t0 in range(0, L, tile):
        for g in range(groups):
            seqs[(t0 // tile) % ctas][g] += list(range(t0 + g, min(t0 + tile, L), groups))
    steps = max(len(s) for cta in seqs for s in cta)
    idx = np.full((ctas, groups, steps), -1)
    for r in range(ctas):
        for g in range(groups):
            idx[r, g, :len(seqs[r][g])] = seqs[r][g]
    acc = np.zeros((ctas, groups, n, n), np.float32)
    bacc = np.zeros((ctas, groups, n), np.float32)
    for s in range(steps):
        lm = idx[:, :, s]
        on = (lm >= 0)[..., None]
        for k in range(3):
            a, h, b = A[lm, k], H[lm, k], b_l[lm, k]
            acc = np.where(on[..., None], acc + a[..., :, None] * h[..., None, :], acc)
            bacc = np.where(on, bacc + a * b[..., None], bacc)
    chains = [(acc[:, j], bacc[:, j]) for j in range(min(4, groups))]
    chains += [(np.zeros_like(acc[:, 0]), np.zeros_like(bacc[:, 0]))] * (4 - len(chains))
    for g in range(4, groups):
        a, b = chains[g % 4]
        chains[g % 4] = (a + acc[:, g], b + bacc[:, g])
    part = (chains[0][0] + chains[1][0]) + (chains[2][0] + chains[3][0])
    bpart = (chains[0][1] + chains[1][1]) + (chains[2][1] + chains[3][1])
    per_cluster = []
    for c in range(clusters):
        total, btotal = part[c * cluster], bpart[c * cluster]
        for r in range(1, cluster):
            total, btotal = total + part[c * cluster + r], btotal + bpart[c * cluster + r]
        per_cluster.append((total, btotal))
    total, btotal = per_cluster[0]
    for t, b in per_cluster[1:]:
        total, btotal = total + t, btotal + b
    S_off = total.reshape(W, 6, W, 6).transpose(0, 2, 1, 3).copy()
    for w in range(W):
        for v in range(w + 1, W):
            S_off[v, w] = S_off[w, v].T
    return S_off, btotal.reshape(W, 6)


@pytest.mark.parametrize("cluster,resident", [(8, 16), (16, 7), (16, 8)])
@pytest.mark.parametrize("W,L", [(5, 512), (8, 4096)])
def test_cluster_summation_order_matches_jax(W, L, cluster, resident):
    """A tolerance check of the kernel's schedule: float32 sums in its order
    (tiles strided over the CTAs of its clusters, ranks and then clusters
    summed in order, the upper block triangle mirrored) stay within the
    tolerance chip_smoke.py holds the kernel to against the JAX reduction,
    at the c2 and c5 window sizes, for clusters of 8 or 16 CTAs and as many
    resident at once as a 132-SM card holds (16 of 8; 7 or 8 of 16, as its
    GPCs allow). It does not pin the kernel's bits: chip_smoke.py checks
    those against the plain version and between repeats on the card."""
    from chip_smoke import SCHUR_TOL

    *arrays, lam = _random_blocks(W + L, W, L, 1e-3)
    H_cc, H_cl, H_ll, b_c, b_l = arrays
    inv = np.asarray(jschur.inv3x3(jnp.asarray(H_ll) + lam * jnp.eye(3)[None]))
    S_off, b_sub = _cluster_order_sums(H_cl, inv, b_l, cluster, resident)
    A = jnp.einsum("wlij,ljk->wlik", H_cl, inv)
    assert _rel(S_off, jnp.einsum("wlik,vljk->wvij", A, H_cl)) < SCHUR_TOL["S_off"]
    assert _rel(b_sub, jnp.einsum("wlik,lk->wi", A, b_l)) < SCHUR_TOL["b_sub"]
    H_cc_eff = H_cc + lam * np.eye(6, dtype=np.float32)[None]
    S = np.eye(W, dtype=np.float32)[:, :, None, None] * H_cc_eff[:, None] - S_off
    S_ref, b_ref = jschur.reduce_camera_system(*(jnp.asarray(x) for x in (H_cc_eff, H_cl, inv, b_c, b_l)))
    assert _rel(S, S_ref) < 1e-5
    assert _rel(b_c - b_sub, b_ref) < 1e-5


@pytest.mark.parametrize("ka,kb,band", [(512, 512, True), (2048, 2048, True),
                                        (1024, 2048, False), (4096, 1024, False)])
def test_matcher_bound_counts_the_contract(ka, kb, band):
    """The matcher's bound counts each input read once (descriptors,
    validity, azimuths with the band) and each of the contract's four
    statistics written once, with their dtypes as the plain twin returns
    them, and 2 ka kb 256 operations at the faster tensor-core form of the
    work, the b1 AND/popc rate (the faster of its measured mma.sync and
    wgmma forms) over the data sheet's int8 rate."""
    from sosvo_torch.frontend.match import match_stats
    from sosvo_torch.tools import bounds

    rng = np.random.default_rng(ka + kb)
    da = torch.from_numpy(rng.integers(-2**31, 2**31, (ka, 8), dtype=np.int64).astype(np.int32))
    db = torch.from_numpy(rng.integers(-2**31, 2**31, (kb, 8), dtype=np.int64).astype(np.int32))
    va, vb = torch.ones(ka, dtype=torch.bool), torch.ones(kb, dtype=torch.bool)
    aza, azb = torch.zeros(ka), torch.zeros(kb)
    ins = [da, db, va, vb] + ([aza, azb] if band else [])
    stats = match_stats(da, db, va, vb, aza, azb, 0.06 if band else 0.0)
    n_bytes = sum(t.numel() * t.element_size() for t in ins + list(stats))
    ops = 2.0 * ka * kb * 256
    assert bounds.B1_OP_PER_S > bounds.INT8_OP_PER_S
    want = max(n_bytes / bounds.HBM_BYTES_PER_S, ops / bounds.B1_OP_PER_S) * 1e3
    ms, by = bounds.matcher_bound_ms(ka, kb, band)
    assert ms == pytest.approx(want, rel=1e-12)
    assert by == ("operations" if ops / bounds.B1_OP_PER_S > n_bytes / bounds.HBM_BYTES_PER_S
                  else "bytes")
