"""Threefry-2x32 ``fold_in``, ``split`` and ``bits``, bit-equal to ``jax.random``.

The JAX package draws its RANSAC hypotheses from
``jax.random.bits(jax.random.fold_in(key, 2·n), (H,), uint32)``.  To draw the
same hypotheses the port reproduces that stream exactly, for JAX's default
``threefry2x32`` implementation with ``jax_threefry_partitionable=True``:

- a key is its two 32-bit words (``jax.random.key_data``; ``key(s)`` is
  ``[0, s]`` for ``0 <= s < 2**32``);
- ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
- ``split(key, n)[i]`` is the same block, ``threefry2x32(key, (0, i))``;
- ``bits(key, (n,))[i]`` is ``b1 ^ b2`` with
  ``(b1, b2) = threefry2x32(key, (0, i))``.

Words are held in int64 tensors masked to 32 bits, because PyTorch's uint32
arithmetic is incomplete on CUDA.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 block (20 rounds) of counters (x0, x1) under the
    two-word ``key`` (..., 2); all int64 tensors of 32-bit values, broadcast
    against each other."""
    k0 = key[..., 0] & _MASK
    k1 = key[..., 1] & _MASK
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """The key words of ``jax.random.key(seed)`` for ``0 <= seed < 2**32``."""
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def fold_in(key_words: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new (..., 2) key from a (2,) key and 32-bit
    values (a Python int or an integer tensor of any shape)."""
    d = torch.as_tensor(data, device=key_words.device).to(torch.int64) & _MASK
    y0, y1 = threefry2x32(key_words, torch.zeros_like(d), d)
    return torch.stack([y0, y1], -1)


def split(key_words: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.key_data(jax.random.split(key, n))``: (n, 2) keys from
    a (2,) key, the ``fold_in`` of each index ``0 .. n-1``."""
    return fold_in(key_words, torch.arange(n, dtype=torch.int64, device=key_words.device))


def bits(key_words: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` of each (..., 2) key, as an
    (..., n) int64 tensor."""
    ctr = torch.arange(n, dtype=torch.int64, device=key_words.device)
    b1, b2 = threefry2x32(key_words[..., None, :], torch.zeros_like(ctr), ctr)
    return b1 ^ b2
