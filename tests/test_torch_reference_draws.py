"""`sosvo_torch.tools.reference_draws` against `jax.random` itself.

Keys (`PRNGKey`, `split`, `fold_in`) and the 32-bit draws and uniforms are
integer work and must be bit-equal; Gumbel draws go through two logs and
must agree within 2e-6 relative (a few f32 steps: the logs are torch's,
not XLA's). The stacked draws of a replay and of the loop pairs are the
ones tests/test_torch_ba_pipeline.py and test_torch_loop_closure.py build
with jax.random.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo_torch.tools import reference_draws as rd

torch.set_num_threads(1)


def _key(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", [0, 2, 17, 2**32 - 1])
def test_keys_are_bit_equal(seed):
    k = jax.random.PRNGKey(seed)
    assert rd.prng_key(seed) == _key(k)
    assert rd.split(rd.prng_key(seed), 5) == [_key(x) for x in jax.random.split(k, 5)]
    for data in (0, 1, 0x5e10c, 2**32 - 1):
        assert rd.fold_in(rd.prng_key(seed), data) == _key(jax.random.fold_in(k, data))


@pytest.mark.parametrize("shape", [(7,), (33, 65), (4, 5, 6)])
def test_bits_and_uniforms_are_bit_equal(shape):
    k = jax.random.split(jax.random.PRNGKey(3), 2)[1]
    bits = rd.random_bits(_key(k), shape, "cpu").numpy().astype(np.uint32)
    np.testing.assert_array_equal(bits, np.asarray(jax.random.bits(k, shape, jnp.uint32)))
    tiny = float(jnp.finfo(jnp.float32).tiny)
    np.testing.assert_array_equal(rd.uniform(_key(k), shape, "cpu").numpy(),
                                  np.asarray(jax.random.uniform(k, shape, minval=tiny, maxval=1.0)))


def test_gumbel_matches():
    k = jax.random.PRNGKey(11)
    got = rd.gumbel(_key(k), (64, 300), "cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(jax.random.gumbel(k, (64, 300))), rtol=2e-6, atol=1e-6)


def test_replay_and_loop_draws_match():
    h, k, l, f = 16, 24, 20, 4
    got = rd.replay_draws(f, h, k, "cpu", reloc_slots=l)
    key = jax.random.PRNGKey(rd.CLI_REPLAY_SEED)
    for i in range(f):
        key, k_r, k_e = jax.random.split(key, 3)
        for g, kk, shape in ((got.gumbel_rigid, k_r, (h, k)), (got.gumbel_ess, k_e, (h, k)),
                             (got.gumbel_reloc, jax.random.fold_in(key, rd.RELOC_FOLD), (h, l))):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(jax.random.gumbel(kk, shape)),
                                       rtol=2e-6, atol=1e-6)
    assert rd.replay_draws(2, h, k, "cpu").gumbel_reloc is None
    loops = rd.loop_draws(3, h, k, "cpu")
    keys = jax.random.split(jax.random.PRNGKey(rd.LOOP_SEED), 3)
    np.testing.assert_allclose(loops.numpy(), np.stack([np.asarray(jax.random.gumbel(kk, (h, k)))
                                                        for kk in keys]), rtol=2e-6, atol=1e-6)
