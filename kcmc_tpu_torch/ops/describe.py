"""Binary keypoint descriptors, upright BRIEF route.

Counterpart of the unoriented route of
`kcmc_tpu/ops/describe.py::describe_keypoints_batch` (describe.py:359-440),
the one the translation model runs:

1. the blurred frames lose their finite-pixel mean, are quantized to
   bf16 and edge-padded by PATCH_RADIUS + 1 (P = 28);
2. kernel K2 cuts and blends each keypoint's (P-1, P-1) patch;
3. the 512 pattern samples are read out of each patch. The reference
   does this as a one-hot (729, 512) matmul, which selects exactly, so
   an index gather of the same rows is the same function;
4. bit i is `sample[2i] < sample[2i+1]`, packed into N_WORDS 32-bit
   words (bit i at word i // 32, position i % 32); invalid slots are 0.

Descriptors are (..., N_WORDS) int64 tensors holding the uint32 bit
patterns of the reference's descriptors.
"""

from __future__ import annotations

import numpy as np
import torch

from kcmc_tpu_torch.ops.cuda_patch import extract_blended
from kcmc_tpu_torch.ops.detect import Keypoints, gaussian_blur
from kcmc_tpu_torch.ops.patterns import N_BITS, N_WORDS, PATCH_RADIUS, PATTERN


def _selection_index(pattern: np.ndarray, radius: int) -> np.ndarray:
    """Flat index into a (2r+1)^2 patch of each of the 2*N_BITS pattern
    samples: the row each column of the reference's one-hot selection
    matrix `_selection_matrix` picks."""
    side = 2 * radius + 1
    offs = pattern.reshape(-1, 2).astype(np.int64)
    return (offs[:, 1] + radius) * side + (offs[:, 0] + radius)


_SEL_UPRIGHT = _selection_index(PATTERN, PATCH_RADIUS)  # (512,)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., N_BITS) bool -> (..., N_WORDS) int64 words."""
    sh = torch.arange(32, device=bits.device, dtype=torch.int64)
    b = bits.reshape(bits.shape[:-1] + (N_WORDS, 32)).to(torch.int64)
    return torch.sum(b << sh, dim=-1)


def _finalize_descriptors(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., 2*N_BITS) selected samples -> packed words, zeroed where
    not valid. Tie rule: a bit is set iff the first sample is strictly
    less than the second."""
    v = vals.reshape(vals.shape[:-1] + (N_BITS, 2))
    desc = _pack_bits(v[..., 0] < v[..., 1])
    return torch.where(valid[..., None], desc, torch.zeros_like(desc))


def edge_pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-replicate the last two axes of x by r on every side (any
    dtype, bf16 included)."""
    H, W = x.shape[-2:]
    ry = torch.clamp(torch.arange(-r, H + r, device=x.device), 0, H - 1)
    rx = torch.clamp(torch.arange(-r, W + r, device=x.device), 0, W - 1)
    return x[..., ry, :][..., rx]


def describe_keypoints_batch(
    frames: torch.Tensor,
    kps: Keypoints,
    blur_sigma: float = 2.0,
    smooth: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, K, N_WORDS) upright descriptors of a (B, H, W) batch.

    `smooth` optionally supplies the blur_sigma-blurred batch (K1's
    free-ride output) so the blur is not recomputed."""
    r = PATCH_RADIUS
    P = 2 * r + 2
    if smooth is None:
        smooth = gaussian_blur(frames, blur_sigma)
    # finite-pixel mean off before the bf16 cast (describe.py:362-387):
    # large DC backgrounds would otherwise eat the bf16 mantissa
    finite = torch.isfinite(smooth)
    n_fin = torch.clamp(finite.sum(dim=(1, 2), keepdim=True), min=1)
    mu = torch.where(finite, smooth, torch.zeros((), device=smooth.device)).sum(
        dim=(1, 2), keepdim=True
    ) / n_fin
    padded = edge_pad((smooth - mu).to(torch.bfloat16), r + 1).contiguous()
    B, K = kps.xy.shape[:2]
    pb = extract_blended(padded, kps.xy.contiguous(), P)
    sel = torch.as_tensor(_SEL_UPRIGHT, device=pb.device)
    vals = pb.reshape(B, K, -1)[..., sel]
    return _finalize_descriptors(vals, kps.valid)


def describe_keypoints(
    img: torch.Tensor,
    kps: Keypoints,
    blur_sigma: float = 2.0,
    smooth: torch.Tensor | None = None,
) -> torch.Tensor:
    """(K, N_WORDS) upright descriptors of one (H, W) frame (the batched
    route on a batch of one)."""
    kb = Keypoints(*(t[None] for t in kps))
    return describe_keypoints_batch(
        img[None], kb, blur_sigma=blur_sigma,
        smooth=None if smooth is None else smooth[None],
    )[0]
