"""Multi-octave scale pyramid: ORB-style multi-scale detection.

Counterpart of `kcmc_tpu/ops/pyramid.py`. Each octave is the base batch
resized by two constant 1D resampling matrices (triangle weights in the
pixel-center convention with a first-moment correction, `resize_matrix`,
a copy of the reference's numpy construction) applied as float32 matmuls;
every octave runs the same fixed-K detect -> describe stages as the base
scale, and the per-octave keypoints map back to base coordinates with
(xy + 0.5) * s - 0.5 and concatenate octave-major. Octave sizes round up
to multiples of 8, floored at 32 px; the exact per-axis scale factors
carry the coordinate mapping.

The matmuls run in full float32: on the card the backend turns TF32 off
(the reference pins Precision.HIGHEST, since the octave images feed
detection comparisons and descriptor bits).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from kcmc_tpu_torch.ops.detect import Keypoints


def octave_sizes(shape: tuple, n_octaves: int, scale: float) -> list[tuple[int, int]]:
    """Per-octave (H_o, W_o), octave 0 = full size; rounded up to
    multiples of 8, floored at 32 px."""
    H, W = int(shape[0]), int(shape[1])
    out = []
    for o in range(n_octaves):
        f = scale**o
        ho = max(32, -(-int(round(H / f)) // 8) * 8)
        wo = max(32, -(-int(round(W / f)) // 8) * 8)
        out.append((min(ho, H), min(wo, W)))
    return out


@functools.lru_cache(maxsize=64)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) antialiased-linear (triangle) resampling matrix in
    the pixel-center convention, built in float64 numpy and cast; each
    interior row is projected onto {sum = 1, centroid = center} so the
    resize has no phase bias (clipped border rows keep the edge clamp)."""
    s = n_in / n_out
    w = max(s, 1.0)
    centers = (np.arange(n_out, dtype=np.float64) + 0.5) * s - 0.5
    x = np.arange(n_in, dtype=np.float64)
    d = np.abs(x[None, :] - centers[:, None]) / w
    k = np.clip(1.0 - d, 0.0, None)
    k /= k.sum(axis=1, keepdims=True)
    for i in range(n_out):
        c = centers[i]
        row = k[i]
        m = float(row @ (x - c))
        v = float(row @ (x - c) ** 2)
        if v > 1e-8 and abs(m) < 0.45 * w:
            g = np.stack([row, row * (x - c)])
            A = np.array([[g[0].sum(), g[1].sum()],
                          [g[0] @ (x - c), g[1] @ (x - c)]])
            rhs = np.array([1.0 - row.sum(), -m])
            try:
                ab = np.linalg.solve(A, rhs)
                k[i] = row + ab[0] * g[0] + ab[1] * g[1]
            except np.linalg.LinAlgError:
                pass
    return k.astype(np.float32)


class Octave(NamedTuple):
    frames: torch.Tensor  # (B, H_o, W_o) resized batch
    sx: float  # base x = (x_o + 0.5) * sx - 0.5
    sy: float


def build_pyramid(frames: torch.Tensor, n_octaves: int, scale: float) -> list[Octave]:
    """Resize a (B, H, W) float32 batch into the octave list (octave 0
    is the input, untouched): rh @ frame @ rw^T per frame."""
    B, H, W = frames.shape
    sizes = octave_sizes((H, W), n_octaves, scale)
    out = [Octave(frames=frames, sx=1.0, sy=1.0)]
    for ho, wo in sizes[1:]:
        rh = torch.as_tensor(resize_matrix(H, ho), device=frames.device)
        rw = torch.as_tensor(resize_matrix(W, wo), device=frames.device)
        small = torch.matmul(torch.matmul(rh, frames), rw.T).contiguous()
        out.append(Octave(frames=small, sx=W / wo, sy=H / ho))
    return out


def merge_octave_keypoints(
    per_octave: list[tuple[Keypoints, torch.Tensor]], octaves: list[Octave]
) -> tuple[Keypoints, torch.Tensor]:
    """Concatenate per-octave (Keypoints (B, K_o, ...), desc (B, K_o, W))
    into one multi-scale set in BASE-frame coordinates, octave-major."""
    xs, ss, vs, ds = [], [], [], []
    for (kp, desc), oc in zip(per_octave, octaves):
        sc = torch.tensor([oc.sx, oc.sy], dtype=torch.float32, device=kp.xy.device)
        xs.append((kp.xy + 0.5) * sc - 0.5)
        ss.append(kp.score)
        vs.append(kp.valid)
        ds.append(desc)
    return (
        Keypoints(xy=torch.cat(xs, dim=1), score=torch.cat(ss, dim=1),
                  valid=torch.cat(vs, dim=1)),
        torch.cat(ds, dim=1),
    )


def per_octave_k(max_keypoints: int, n_octaves: int) -> list[int]:
    """Fixed K per octave: an even split rounded up to 8."""
    k = max(8, -(-max_keypoints // (n_octaves * 8)) * 8)
    return [k] * n_octaves
