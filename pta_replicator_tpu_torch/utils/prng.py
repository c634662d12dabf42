"""Threefry-2x32 key derivation in numpy: the two key operations the scenario
compiler seeds its draws from.

The reference compiler seeds every compile-time draw from
``jax.random.fold_in(jax.random.PRNGKey(seed), family)`` and reads the key's
two uint32 words (``jax.random.key_data``). This module computes the same
words without JAX: ``PRNGKey(s)`` is the word pair ``(s >> 32, s &
0xffffffff)`` (JAX's 64-bit mode; without it JAX keeps only the low word,
so the two agree for seeds below 2**32), and ``fold_in(k, d)`` is one
Threefry-2x32 block (20 rounds) of the counter pair ``(0, d)`` under the key
``k``. Only the key derivation is reproduced: the realization draws of the
port come from ``torch.Generator``s, not from Threefry.
"""
from __future__ import annotations

import numpy as np

_MASK32 = 0xFFFFFFFF
#: Threefry-2x32's rotation schedule, the first and the second group of
#: four rounds, and its key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(key, count) -> np.ndarray:
    """One Threefry-2x32 block: the counter word pair ``count`` encrypted
    under the key word pair ``key``; (2,) uint32."""
    k0, k1 = (int(w) & _MASK32 for w in key)
    x0, x1 = (int(w) & _MASK32 for w in count)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for step in range(1, 6):
        for r in _ROTATIONS[(step - 1) % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[step % 3]) & _MASK32
        x1 = (x1 + ks[(step + 1) % 3] + step) & _MASK32
    return np.array([x0, x1], dtype=np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """The key words of ``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**63
    (JAX's 64-bit mode); (2,) uint32."""
    seed = int(seed)
    if not 0 <= seed < 2**63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    return np.array([seed >> 32, seed & _MASK32], dtype=np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """The key words of ``jax.random.fold_in(key, data)`` for a uint32
    ``data``; (2,) uint32."""
    data = int(data)
    if not 0 <= data <= _MASK32:
        raise ValueError(f"fold_in data must be a uint32, got {data}")
    return threefry2x32(key, (0, data))


def key_bits(key) -> np.ndarray:
    """The key's two words, as ``jax.random.key_data`` returns them;
    (2,) uint32."""
    return np.asarray(key, dtype=np.uint32).reshape(2)
