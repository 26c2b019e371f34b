"""The port's plain Hamming matcher against the JAX matcher and the Pallas kernel.

Same inputs (the JAX tests' `_random_problem`) through
`sosvo.frontend.match.match`, `sosvo.kernels.match_pallas.match_pallas`
(interpret mode) and the port's `match_hamming` on CPU tensors, which is the
plain twin of the CUDA kernel. Contract, as in tests/test_match_pallas.py:
`valid` equal everywhere; `idx_b` and `dist` equal where valid (exact: the
distances are integers plus exactly representable penalties).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.frontend.match import column_band_penalty, hamming_matrix_mxu, hamming_matrix_xor, match
from sosvo.kernels.match_pallas import match_pallas, match_stats_pallas
from sosvo_torch.convert import desc_to_numpy, desc_to_torch
from sosvo_torch.frontend.match import WORDS, hamming_matrix, match_stats
from sosvo_torch.kernels import match_cuda
from test_match_pallas import _random_problem

torch.set_num_threads(1)

CASES = [  # (band, seed, ka, kb)
    (0.0, 0, 200, 170),
    (0.06, 1, 200, 170),
    (0.06, 2, 256, 128),
    (0.0, 3, 128, 256),
]


def _port_inputs(da, db, va, vb, aza, azb):
    return (desc_to_torch(da, "cpu"), desc_to_torch(db, "cpu"),
            *(torch.tensor(np.asarray(x)) for x in (va, vb, aza, azb)))


def _assert_contract(ref, got):
    ref_valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), ref_valid)
    m = ref_valid
    np.testing.assert_array_equal(got.idx_b.numpy()[m], np.asarray(ref.idx_b)[m])
    np.testing.assert_array_equal(got.dist.numpy()[m], np.asarray(ref.dist)[m])
    assert m.sum() > 10  # the comparison is not vacuous


@pytest.mark.parametrize("band,seed,ka,kb", CASES)
def test_plain_matcher_equals_jax_match(band, seed, ka, kb):
    da, db, va, vb, aza, azb = _random_problem(jax.random.PRNGKey(seed), ka, kb)
    pen = None if band <= 0 else column_band_penalty(aza, azb, band, wrap=2 * np.pi)
    ref = match(da, db, va, vb, max_distance=80.0, ratio=0.9, penalty=pen)
    a, b, pva, pvb, paza, pazb = _port_inputs(da, db, va, vb, aza, azb)
    got = match_cuda.match_hamming(a, b, pva, pvb, max_distance=80.0, ratio=0.9,
                                   az_a=paza, az_b=pazb, band=band)
    _assert_contract(ref, got)


@pytest.mark.parametrize("band,seed,ka,kb", CASES[:3])
def test_plain_matcher_equals_pallas_kernel(band, seed, ka, kb):
    da, db, va, vb, aza, azb = _random_problem(jax.random.PRNGKey(seed), ka, kb)
    ref = match_pallas(da, db, va, vb, max_distance=80.0, ratio=0.9,
                       az_a=aza, az_b=azb, band=band, interpret=True)
    a, b, pva, pvb, paza, pazb = _port_inputs(da, db, va, vb, aza, azb)
    got = match_cuda.match_hamming(a, b, pva, pvb, max_distance=80.0, ratio=0.9,
                                   az_a=paza, az_b=pazb, band=band)
    _assert_contract(ref, got)


def test_plain_stats_equal_pallas_stats_everywhere():
    """The four statistics the CUDA kernel must produce, on every row and
    column (invalid ones too), against the Pallas kernel's."""
    da, db, va, vb, aza, azb = _random_problem(jax.random.PRNGKey(4), 200, 170)
    ref = match_stats_pallas(da, db, va, vb, aza, azb, 0.06, interpret=True)
    got = match_stats(*_port_inputs(da, db, va, vb, aza, azb), band=0.06)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_descriptor_int32_round_trip():
    da, _, _, _, _, _ = _random_problem(jax.random.PRNGKey(5), 64, 64)
    ref = np.asarray(da)
    assert ref.dtype == np.uint32 and (ref >= 2**31).any()  # bit 31 is exercised
    t = desc_to_torch(ref, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(desc_to_numpy(t), ref)
    # Bit unpacking reads every bit, bit 31 included, as the reference's does.
    from sosvo.frontend.match import unpack_bits_pm1 as jax_unpack
    from sosvo_torch.frontend.match import unpack_bits_pm1
    np.testing.assert_array_equal(unpack_bits_pm1(t).numpy(),
                                  np.asarray(jax_unpack(jnp.asarray(ref), jnp.float32)))


def test_cpu_path_never_counts_a_launch():
    da, db, va, vb, aza, azb = _random_problem(jax.random.PRNGKey(6), 64, 64)
    match_cuda.reset_launches()
    a, b, pva, pvb, paza, pazb = _port_inputs(da, db, va, vb, aza, azb)
    match_cuda.match_hamming(a, b, pva, pvb, az_a=paza, az_b=pazb, band=0.06)
    match_cuda.match_hamming(a, b, pva, pvb)
    assert match_cuda.launches == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    da, db, va, vb, _, _ = _random_problem(jax.random.PRNGKey(7), 16, 16)
    a, b, pva, pvb, _, _ = _port_inputs(da, db, va, vb, np.zeros(16, np.float32),
                                        np.zeros(16, np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        match_cuda.match_stats_cuda(a, b, pva, pvb)


def _popc(words: np.ndarray) -> np.ndarray:
    """Per-word popcount of int32 bit patterns."""
    return np.bitwise_count(np.ascontiguousarray(words).view(np.uint32)).astype(np.int32)


def _edge_rows(kind: str, rng) -> np.ndarray:
    """Descriptor rows of the edge words: all-zero, all-one and sign-bit-set
    int32 words, alone and mixed with random words."""
    words = {"zero": [0], "ones": [-1], "sign_bit": [-2**31],
             "mixed_edges": [0, -1, -2**31, 2**31 - 1]}[kind]
    whole = [np.full(WORDS, w, np.int32) for w in words]
    mixed = rng.choice(np.array(words + [int(rng.integers(-2**31, 2**31))], np.int64),
                       size=(6, WORDS)).astype(np.int32)
    return np.concatenate([np.stack(whole), mixed,
                           rng.integers(-2**31, 2**31, (4, WORDS), dtype=np.int64).astype(np.int32)])


@pytest.mark.parametrize("words", [0, 1, 2, "zero", "ones", "sign_bit", "mixed_edges"])
def test_and_popc_distance_equals_xor_and_jax(words):
    """The CUDA kernel's distance popc(a) + popc(b) - 2 popc(a & b) on the
    packed int32 words (what its b1 AND/popc tensor-core product gives)
    equals the XOR distance popc(a ^ b), the JAX package's Hamming matrices
    and the port's plain one, on random seeds and on the edge words."""
    rng = np.random.default_rng(words if isinstance(words, int) else 100)
    if isinstance(words, int):
        a = rng.integers(-2**31, 2**31, (37, WORDS), dtype=np.int64).astype(np.int32)
        b = rng.integers(-2**31, 2**31, (29, WORDS), dtype=np.int64).astype(np.int32)
        b[:5] = a[:5]
    else:
        a, b = _edge_rows(words, rng), _edge_rows(words, rng)[::-1].copy()
    and_popc = (_popc(a).sum(1)[:, None] + _popc(b).sum(1)[None, :]
                - 2 * _popc(a[:, None, :] & b[None, :, :]).sum(-1))
    xor = _popc(a[:, None, :] ^ b[None, :, :]).sum(-1)
    np.testing.assert_array_equal(and_popc, xor)
    ja, jb = jnp.asarray(a.view(np.uint32)), jnp.asarray(b.view(np.uint32))
    np.testing.assert_array_equal(np.asarray(hamming_matrix_xor(ja, jb)), and_popc)
    np.testing.assert_array_equal(np.asarray(hamming_matrix_mxu(ja, jb)), and_popc)
    plain = hamming_matrix(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(plain.numpy(), and_popc.astype(np.float32))
