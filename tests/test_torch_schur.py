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
