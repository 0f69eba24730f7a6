"""Trajectory smoothing for stabilization, and repair of failed frames.

The port's own copy of `kcmc_tpu/utils/trajectory.py` (numpy only).
`MotionCorrector.correct` removes all motion; stabilization keeps the
intentional, slow motion and removes the jitter: low-pass the recovered
trajectory and apply only the residual,

    res = mc.correct(stack)
    stab = smooth_trajectory(res.transforms, sigma=15)
    stabilized = apply_correction(stack, stab)

With full-correction warps M_t (output -> source maps) and their
temporal low-pass M~_t, the stabilizing warp is S_t = M_t @ inv(M~_t):
a smooth trajectory gives S_t == I, and sigma -> inf recovers full
registration up to the mean pose. Matrix entries are smoothed directly
(exact for the translation family); homographies are renormalized to
M[2, 2] = 1 after smoothing. `interpolate_failed` replaces the
transforms of failed frames by interpolating their neighbours'.
"""

from __future__ import annotations

import numpy as np


def _check_transforms(transforms) -> np.ndarray:
    """Validate a (T, 3, 3) / (T, 4, 4) trajectory (shared by every
    public entry point here)."""
    M = np.asarray(transforms)
    d = M.shape[-1] if M.ndim == 3 else 0
    if M.ndim != 3 or M.shape[-2] != d or d not in (3, 4):
        raise ValueError(
            f"transforms must be (T, 3, 3) or (T, 4, 4), got {M.shape}"
        )
    return M


def _gaussian_taps(sigma: float) -> np.ndarray:
    r = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _smooth_along_t(arr: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian low-pass along axis 0 with odd-reflect padding.

    Odd reflection (p[-k] = 2*p[0] - p[k]) extends the trajectory
    C^1-continuously, so a path arriving at the boundary with nonzero
    velocity is extrapolated straight through it instead of kinking
    into a mirrored V (plain "reflect" at sigma=8 over a 30-px/240-frame
    sinusoid bends the smoothed endpoint ~5 px off the true path; odd
    reflection leaves O(sigma^2 * curvature))."""
    taps = _gaussian_taps(sigma)
    r = len(taps) // 2
    T = arr.shape[0]
    flat = arr.reshape(T, -1).astype(np.float64)
    # for T == 1 there is nothing to smooth
    if T == 1:
        return arr.astype(np.float64)
    pad = np.pad(flat, ((r, r), (0, 0)), mode="reflect", reflect_type="odd")
    # One vectorized shift-accumulate per tap (len(taps) ~ 6*sigma ops)
    # instead of a Python loop over columns — a piecewise (T, gh, gw, 2)
    # field flattens to gh*gw*2 columns (2048 for a 32x32 grid), which
    # made per-column np.convolve the dominant host cost on long runs.
    out = np.zeros_like(flat)
    for k, t in enumerate(taps):
        out += t * pad[k : k + T]
    return out.reshape(arr.shape)


def smooth_trajectory(
    transforms: np.ndarray | None = None,
    fields: np.ndarray | None = None,
    sigma: float = 15.0,
) -> np.ndarray:
    """Stabilizing transforms/fields from a recovered motion trajectory.

    Pass exactly one of:

    * `transforms` — (T, 3, 3) or (T, 4, 4) full-correction warps from
      `CorrectionResult.transforms` (any matrix model, 2D or rigid3d).
      Returns same-shape stabilizing warps S_t = M_t @ inv(smooth(M)_t)
      for `apply_correction`.
    * `fields` — (T, gh, gw, 2) piecewise displacement fields from
      `CorrectionResult.fields`. Displacement fields compose additively
      (to first order in the displacement), so the stabilizing field is
      the high-pass residual F_t - smooth(F)_t. Returns same shape.

    `sigma` is the temporal Gaussian's scale IN FRAMES: motion slower
    than ~sigma frames is kept, faster is removed. Boundary handling is
    odd reflection — the path is extrapolated slope-preservingly
    through the ends instead of sliding toward the sequence mean.
    """
    if (transforms is None) == (fields is None):
        raise ValueError("pass exactly one of transforms= or fields=")
    if sigma <= 0.0:
        raise ValueError(f"sigma must be positive, got {sigma}")
    if fields is not None:
        fields = np.asarray(fields)
        if fields.ndim != 4 or fields.shape[-1] != 2:
            raise ValueError(f"fields must be (T, gh, gw, 2), got {fields.shape}")
        sm = _smooth_along_t(fields, sigma)
        return (fields - sm).astype(np.float32)

    M = _check_transforms(transforms)
    sm = _smooth_along_t(M, sigma)
    # Projective entries drift off unit scale under averaging; renorm.
    sm = sm / sm[:, -1:, -1:]
    # Smoothing preserves the affine last row exactly (constant input
    # rows stay constant under a normalized kernel); inv() is then a
    # valid warp of the same kind.
    stab = np.einsum("tij,tjk->tik", M.astype(np.float64), np.linalg.inv(sm))
    return stab.astype(np.float32)


def interpolate_failed(
    transforms: np.ndarray, good: np.ndarray
) -> np.ndarray:
    """Replace failed frames' transforms by interpolating their
    neighbors' motion.

    A frame whose registration failed — stimulation artifact, shutter
    blank, a dropped camera frame — comes back with a meaningless
    transform (a blank frame consensus-defaults to identity, which
    mid-drift re-introduces the full motion into that one frame). Real
    motion is continuous, so the standard repair interpolates the
    trajectory across the gap:

        good = res.diagnostics["n_inliers"] >= 20
        fixed = interpolate_failed(res.transforms, good)
        corrected = apply_correction(stack, fixed)   # re-warp

    `transforms`: (T, 3, 3) or (T, 4, 4); `good`: (T,) boolean mask of
    trustworthy frames. Failed runs interior to the sequence are
    linearly interpolated entry-wise between the flanking good frames
    (exact for translation; the standard small-motion approximation for
    the rotational/projective entries, with homographies renormalized);
    failed runs at the ends copy the nearest good transform. Raises if
    no frame is good. Good frames pass through bit-unchanged.
    """
    M = _check_transforms(transforms)
    good = np.asarray(good, bool)
    if good.shape != (len(M),):
        raise ValueError(
            f"good mask must be ({len(M)},), got {good.shape}"
        )
    if good.all():
        return M.copy()
    if not good.any():
        raise ValueError("no good frames to interpolate from")
    t = np.arange(len(M), dtype=np.float64)
    tg = t[good]
    flat = M.reshape(len(M), -1).astype(np.float64)
    out = flat.copy()
    for j in range(flat.shape[1]):
        # np.interp clamps beyond the first/last good frame = nearest
        # extrapolation at the ends.
        out[~good, j] = np.interp(t[~good], tg, flat[good, j])
    out = out.reshape(M.shape)
    out = out / out[:, -1:, -1:]  # homography renorm; affine rows exact
    out[good] = M[good]  # good frames bit-unchanged
    return out.astype(M.dtype, copy=False)
