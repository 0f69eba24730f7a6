"""Transform-error metrics (numpy only), copied from kcmc_tpu.utils.metrics.

Transform error is the RMS control-point displacement, in pixels, that
an estimated ref -> frame transform induces relative to ground truth
over a 9x9 grid inset 10% from the borders.
"""

from __future__ import annotations

import numpy as np


def control_points(shape: tuple[int, ...], n_per_axis: int = 9) -> np.ndarray:
    """(N, d) control points in (x, y[, z]) order, inset 10% from borders."""
    axes = [
        np.linspace(0.1 * (s - 1), 0.9 * (s - 1), n_per_axis, dtype=np.float32)
        for s in shape
    ]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in reversed(mesh)], axis=-1)


def _apply_np(M: np.ndarray, pts: np.ndarray) -> np.ndarray:
    d = pts.shape[-1]
    lin = pts @ M[:d, :d].T + M[:d, d]
    w = pts @ M[d, :d] + M[d, d]
    return lin / np.where(np.abs(w) < 1e-8, 1e-8, w)[..., None]


def transform_rmse(
    est: np.ndarray, gt: np.ndarray, shape: tuple[int, ...], n_per_axis: int = 9
) -> float:
    """RMS control-point displacement error between two (T, d+1, d+1)
    stacks of ref -> frame transforms, in pixels."""
    pts = control_points(shape, n_per_axis)
    errs = []
    for Me, Mg in zip(np.asarray(est), np.asarray(gt)):
        diff = _apply_np(Me, pts) - _apply_np(Mg, pts)
        errs.append(np.sum(diff * diff, axis=-1))
    return float(np.sqrt(np.mean(np.stack(errs))))


def relative_transforms(gt: np.ndarray, ref_index: int = 0) -> np.ndarray:
    """Ground truth re-expressed relative to frame `ref_index`:
    gt_t @ inv(gt_ref), the target of an estimate against that frame."""
    inv = np.linalg.inv(gt[ref_index])
    return np.stack([M @ inv for M in np.asarray(gt)])
