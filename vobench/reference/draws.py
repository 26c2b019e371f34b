"""The JAX package's random draws, reproduced in torch on any device.

`jax.random`'s default generator is Threefry-2x32 (20 rounds) with
partitionable key derivation (`jax_threefry_partitionable`, on by default):
  * `PRNGKey(s)` is the word pair (0, s) for 0 <= s < 2^32;
  * `split(key, n)[i]` and `fold_in(key, i)` are threefry(key, (0, i));
  * element i (row-major) of a 32-bit draw is the XOR of the two words of
    threefry(key, (0, i));
  * a uniform f32 puts the top 23 bits into the mantissa of [1, 2), takes
    1 away and clamps below at the smallest normal; `gumbel` is
    -log(-log(uniform)).
With these, a replay on the card can use the very draws the JAX package's
command line makes, so an ATE on the card compares with the reference's on
the same rendered sequence and the same random stream. The integer steps
are exact (int64 holding uint32 values, masked after every add and
shift); the two logs are the device's, within a few f32 steps of XLA's.

Keys are Python int pairs, derived on the host; draws are made on the
requested device. Nothing here imports jax.
"""

from __future__ import annotations

import torch

from vobench.reference.vo.pipeline import StepDraws

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = float(torch.finfo(torch.float32).tiny)
RELOC_FOLD = 0x5e10c    # sosvo/vo/ba_pipeline.py: relocalisation's fold_in constant
Key = tuple[int, int]


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 words."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = x0 ^ (((x1 << r) | (x1 >> (32 - r))) & _MASK32)
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def split(key: Key, n: int) -> list[Key]:
    a, b = threefry2x32(key, torch.zeros(n, dtype=torch.int64), torch.arange(n))
    return list(zip(a.tolist(), b.tolist()))


def fold_in(key: Key, data: int) -> Key:
    a, b = threefry2x32(key, torch.zeros(1, dtype=torch.int64),
                        torch.full((1,), data & _MASK32, dtype=torch.int64))
    return (int(a), int(b))


def random_bits(key: Key, shape: tuple[int, ...], device) -> torch.Tensor:
    """The 32-bit draw of `shape`, as int64 values in [0, 2^32)."""
    n = 1
    for s in shape:
        n *= s
    a, b = threefry2x32(key, torch.zeros(n, dtype=torch.int64, device=device),
                        torch.arange(n, device=device))
    return (a ^ b).reshape(shape)


def uniform(key: Key, shape: tuple[int, ...], device) -> torch.Tensor:
    """`jax.random.uniform(key, shape, minval=tiny, maxval=1)` in f32."""
    bits = (random_bits(key, shape, device) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats + _TINY_F32, _TINY_F32)


def gumbel(key: Key, shape: tuple[int, ...], device) -> torch.Tensor:
    """`jax.random.gumbel(key, shape)` in f32."""
    return -torch.log(-torch.log(uniform(key, shape, device)))


def replay_draws_from_key(key: Key, n_frames: int, n_hyps: int, k: int, device,
                          reloc_slots: int | None = None) -> StepDraws:
    """The per-frame RANSAC draws of the JAX package's replay from `key`
    (`frame_draws` frame after frame), stacked over frames."""
    frames = []
    for _ in range(n_frames):
        key, d = frame_draws(key, n_hyps, k, device, reloc_slots)
        frames.append(d)
    return StepDraws(*(None if x[0] is None else torch.stack(x) for x in zip(*frames)))


def frame_draws(key: Key, n_hyps: int, k: int, device, reloc_slots: int | None = None
                ) -> tuple[Key, StepDraws]:
    """One frame's draws of the JAX package's step from its state's `key`:
    the key splits into (next key, rigid, essential), each of the last two
    draws an (H, K) Gumbel matrix; with `reloc_slots` L, also
    relocalisation's (H, L) matrix from the next key folded with RELOC_FOLD
    (the BA step's). Returns (next key, draws)."""
    key, k_rigid, k_ess = split(key, 3)
    reloc = None if reloc_slots is None else \
        gumbel(fold_in(key, RELOC_FOLD), (n_hyps, reloc_slots), device)
    return key, StepDraws(gumbel(k_rigid, (n_hyps, k), device), gumbel(k_ess, (n_hyps, k), device),
                          reloc)
