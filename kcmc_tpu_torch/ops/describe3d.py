"""3D binary descriptors: BRIEF pairs in an anisotropic ellipsoid.

Counterpart of `kcmc_tpu/ops/describe3d.py` (config 5). Each keypoint's
(2 RADIUS_Z + 2, 2 RADIUS_XY + 2, 2 RADIUS_XY + 2) slab of the
edge-padded blur is resampled trilinearly at the keypoint's subpixel
fraction, and the 512 integer-offset samples of PATTERN_3D are read out
of the (7, 19, 19) result: bit i is `sample[2i] < sample[2i+1]`, packed
as in `describe.py`.

`describe_keypoints_3d_batch` (the batch program's route) cuts and
blends through kernel K10 and reads the samples by an index gather of
their flat positions. The reference reads them with a one-hot matmul in
two bf16 passes (hi + lo, `describe._onehot_select`), which keeps ~16
mantissa bits of each sample; the gather is exact float32, so a bit can
differ from the reference's Pallas route only where two samples lie
within ~2^-16 relative of each other. `describe_keypoints_3d` mirrors
the reference's jnp route (the 8-corner blend of a dynamic slice, an
exact selection) and is the oracle of the batched route.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from kcmc_tpu_torch.ops.cuda_patch3d import extract_blended_3d
from kcmc_tpu_torch.ops.describe import _finalize_descriptors
from kcmc_tpu_torch.ops.detect import Keypoints
from kcmc_tpu_torch.ops.detect3d import gaussian_blur_3d
from kcmc_tpu_torch.ops.patterns import PATTERN_3D, RADIUS_XY, RADIUS_Z

_RX = int(RADIUS_XY)
_RZ = int(RADIUS_Z)
_SIDE_XY = 2 * _RX + 1
_SIDE_Z = 2 * _RZ + 1
PZ, PXY = 2 * _RZ + 2, 2 * _RX + 2  # slab sides, one more than the output


def _selection_index_3d(pattern: np.ndarray) -> np.ndarray:
    """Flat index into a (SIDE_Z, SIDE_XY, SIDE_XY) blended patch of each
    of the 2 * N_BITS integer (x, y, z) samples: the row each column of
    the reference's one-hot `_SEL_3D` picks."""
    offs = pattern.reshape(-1, 3).astype(np.int64)
    return (
        (offs[:, 2] + _RZ) * (_SIDE_XY * _SIDE_XY)
        + (offs[:, 1] + _RX) * _SIDE_XY
        + (offs[:, 0] + _RX)
    )


_SEL_3D_INDEX = _selection_index_3d(PATTERN_3D)  # (512,)


def edge_pad_3d(vols: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W) -> edge-replicated by (RADIUS_Z + 1, RADIUS_XY + 1,
    RADIUS_XY + 1) on every side."""
    pz, pxy = _RZ + 1, _RX + 1
    return F.pad(vols[:, None], (pxy, pxy, pxy, pxy, pz, pz), mode="replicate")[:, 0]


def _select(pb: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    sel = torch.as_tensor(_SEL_3D_INDEX, device=pb.device)
    vals = pb.reshape(pb.shape[:-3] + (-1,))[..., sel]
    return _finalize_descriptors(vals, valid)


def describe_keypoints_3d(
    vol: torch.Tensor,
    kps: Keypoints,
    blur_sigma: float = 1.5,
    smooth: torch.Tensor | None = None,
) -> torch.Tensor:
    """(K, N_WORDS) descriptors of one (D, H, W) volume through the
    reference's jnp route: the 8-corner trilinear blend of each slab.
    `smooth` optionally supplies the blurred volume."""
    if smooth is None:
        smooth = gaussian_blur_3d(vol[None], blur_sigma)[0]
    padded = edge_pad_3d(smooth[None])[0]
    fl = torch.floor(kps.xy)
    frac = kps.xy - fl
    org = fl.to(torch.int64) + 1
    # a dynamic slice: the start clamps so the slab fits the padded volume

    def index(axis, n, size):
        start = torch.clamp(org[:, axis, None], 0, size - n)
        return start + torch.arange(n, device=vol.device)

    zi = index(2, PZ, padded.shape[0])
    yi = index(1, PXY, padded.shape[1])
    xi = index(0, PXY, padded.shape[2])
    c = padded[zi[:, :, None, None], yi[:, None, :, None], xi[:, None, None, :]]
    fx, fy, fz = (frac[:, i, None, None, None] for i in range(3))
    pb = (
        (1 - fz) * (1 - fy) * (1 - fx) * c[:, :-1, :-1, :-1]
        + (1 - fz) * (1 - fy) * fx * c[:, :-1, :-1, 1:]
        + (1 - fz) * fy * (1 - fx) * c[:, :-1, 1:, :-1]
        + (1 - fz) * fy * fx * c[:, :-1, 1:, 1:]
        + fz * (1 - fy) * (1 - fx) * c[:, 1:, :-1, :-1]
        + fz * (1 - fy) * fx * c[:, 1:, :-1, 1:]
        + fz * fy * (1 - fx) * c[:, 1:, 1:, :-1]
        + fz * fy * fx * c[:, 1:, 1:, 1:]
    )  # (K, SIDE_Z, SIDE_XY, SIDE_XY)
    return _select(pb, kps.valid)


def describe_keypoints_3d_batch(
    vols: torch.Tensor,
    kps: Keypoints,
    blur_sigma: float = 1.5,
    smooth: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, K, N_WORDS) descriptors of a (B, D, H, W) batch through K10.
    `smooth` optionally supplies the blurred batch (K9's side output)."""
    if smooth is None:
        smooth = gaussian_blur_3d(vols, blur_sigma)
    padded = edge_pad_3d(smooth).contiguous()
    pb = extract_blended_3d(padded, kps.xy.contiguous(), PZ, PXY)
    return _select(pb, kps.valid)
