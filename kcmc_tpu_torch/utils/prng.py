"""Threefry-2x32 keys, `fold_in` and `uniform`, bit-exact with jax.random.

The reference draws RANSAC hypotheses from `jax.random` (a per-frame
key folded from the global frame index, a per-hypothesis key folded
from it, then a uniform score per match). Reproducing those bits lets
the port's consensus be held against the reference exactly instead of
statistically.

Words are uint32 values held in int64 tensors (torch's uint32 support
is thin); every operation masks back to 32 bits. A key is a (..., 2)
int64 tensor. `uniform` follows jax's `jax_threefry_partitionable=True`
bit layout: element i of an (N,) draw hashes the counter pair (0, i)
and takes the XOR of the two output words.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(
    k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 block function on broadcastable int64
    word tensors."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.key(seed)` for a 32-bit seed: words (0, seed)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: threefry(key, (0, data)). `data` may be a
    Python int or an integer tensor; the result broadcasts the key
    (..., 2) against data's shape and has shape data.shape + (2,) (or
    the key's shape for scalar data)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) 32-bit words: threefry(key, (0, i)) XOR-folded, per
    key in the leading axes of k (..., 2)."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(
        k[..., 0, None], k[..., 1, None], torch.zeros_like(i), i
    )
    return y0 ^ y1


def uniform(k: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.uniform(k, (n,))` in [0, 1) float32, batched over the
    leading axes of k: the top 23 bits become the mantissa of a float in
    [1, 2), minus 1."""
    bits = (random_bits(k, n) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(f, min=0.0)
