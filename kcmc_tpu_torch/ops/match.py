"""KNN binary-descriptor matching: Hamming 2-NN by one exact matmul.

Counterpart of `kcmc_tpu/ops/match.py::knn_match_impl`. Descriptors
unpack to ±1 float32 vectors, whose dot product is N_BITS - 2 * hamming
exactly (integer sums <= 256 are exact in float32), so the (Kq, Kr)
distance matrix is one `torch.matmul` — the reference leaves this
product to XLA outside any kernel. Then two min/argmin passes, the
ratio test, the mutual check and the zero-descriptor guard.
`hamming_matrix` (XOR + popcount) is the independent oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kcmc_tpu_torch.ops.patterns import N_BITS

BIG = (1 << 16) - 1  # distance sentinel of masked slots


class Matches(NamedTuple):
    idx: torch.Tensor  # (..., Kq) int64 reference index
    dist: torch.Tensor  # (..., Kq) int32 best distance
    second: torch.Tensor  # (..., Kq) int32 second-best distance
    valid: torch.Tensor  # (..., Kq) bool


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of 32-bit words held in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    """(..., W) packed words -> (..., 32*W) float32 ±1 vectors."""
    sh = torch.arange(32, device=desc.device, dtype=torch.int64)
    bits = (desc[..., None] >> sh) & 1
    pm = (2 * bits - 1).to(torch.float32)
    return pm.reshape(desc.shape[:-1] + (32 * desc.shape[-1],))


def hamming_matrix(q, r, q_valid, r_valid) -> torch.Tensor:
    """(Kq, Kr) Hamming distances by XOR + popcount; BIG where masked."""
    d = popcount32(q[:, None, :] ^ r[None, :, :]).sum(-1).to(torch.int32)
    mask = q_valid[:, None] & r_valid[None, :]
    return torch.where(mask, d, torch.full_like(d, BIG))


def hamming_matrix_mm(q, r, q_valid, r_valid) -> torch.Tensor:
    """The same matrix as `hamming_matrix`, batched over q's leading
    axes, as one float32 ±1 matmul."""
    n_bits = 32 * q.shape[-1]
    s = torch.matmul(unpack_pm1(q), unpack_pm1(r).transpose(-1, -2))
    d = ((n_bits - s) * 0.5).to(torch.int32)
    mask = q_valid[..., :, None] & r_valid[..., None, :]
    return torch.where(mask, d, torch.full_like(d, BIG))


def knn_match_impl(
    q_desc: torch.Tensor,
    r_desc: torch.Tensor,
    q_valid: torch.Tensor,
    r_valid: torch.Tensor,
    ratio: float = 0.85,
    max_dist: int = 80,
    mutual: bool = True,
) -> Matches:
    """2-NN Hamming match of (..., Kq, W) query descriptors against
    (Kr, W) reference descriptors (match.py:129). Valid iff best <
    max_dist, best < ratio * second and, with `mutual`, the reference
    keypoint's own nearest query is this one. All-zero descriptors (the
    invalid sentinel) never match."""
    q_valid = q_valid & torch.any(q_desc != 0, dim=-1)
    r_valid = r_valid & torch.any(r_desc != 0, dim=-1)
    Di = hamming_matrix_mm(q_desc, r_desc, q_valid, r_valid)
    Kq, Kr = Di.shape[-2:]
    best = Di.amin(dim=-1)
    idx = torch.argmin(Di, dim=-1)  # first index among ties
    taken = idx[..., None] == torch.arange(Kr, device=Di.device)
    second = torch.where(taken, torch.full_like(Di, BIG), Di).amin(dim=-1)
    r32 = torch.tensor(ratio, dtype=torch.float32, device=Di.device)
    ok = (best < max_dist) & (best.to(torch.float32) < r32 * second.to(torch.float32))
    if mutual:
        rev_best = torch.argmin(Di, dim=-2)  # (..., Kr) best query per ref
        back = torch.gather(rev_best, -1, idx)
        ok = ok & (back == torch.arange(Kq, device=Di.device))
    ok = ok & q_valid & (best < N_BITS + 1)
    return Matches(idx=idx, dist=best, second=second, valid=ok)
