"""Descriptor sampling pattern and detector constants (numpy only).

A copy of the constants the upright, oriented and 3D describe routes
need from `kcmc_tpu/ops/patterns.py`. The port keeps its own copy instead of
importing the JAX package; `tests/test_torch_describe.py` and
`tests/test_torch_oriented.py` assert the two stay equal, which is what
keeps descriptor words bit-identical across the two packages.
"""

from __future__ import annotations

import numpy as np

N_BITS = 256
N_WORDS = N_BITS // 32
PATCH_RADIUS = 13  # BRIEF pattern support radius, pixels
MOMENT_RADIUS = 7  # intensity-centroid disc radius (ORB orientation)
N_ORIENT_BINS = 16  # orientation quantization (22.5 deg, ORB-style)
ROT_RADIUS = 15  # rotated-pattern support radius (rotated offsets clipped)
CAND_TILE = 8  # detector candidate-reduction tile side (one keypoint/tile)
WINDOW_SIGMA = 1.5  # Harris structure-tensor window sigma

# 3D descriptor support (anisotropic: z-stacks are shallow)
RADIUS_XY = 9.0
RADIUS_Z = 3.0


def make_pattern(seed: int = 7) -> np.ndarray:
    """The BRIEF pair pattern: (N_BITS, 2, 2) float32 (pair, endpoint,
    (x, y)). Gaussian offsets (sigma = radius/2), clipped to the patch
    and rounded to integer pixel offsets, so sampling a blended patch
    is a constant index selection."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH_RADIUS / 2.0, size=(N_BITS, 2, 2))
    return np.rint(np.clip(pts, -PATCH_RADIUS, PATCH_RADIUS)).astype(np.float32)


def make_rotated_patterns(n_bins: int = N_ORIENT_BINS) -> np.ndarray:
    """Per-orientation-bin rotated integer patterns: (n_bins, N_BITS, 2,
    2). Orientation is quantized into `n_bins` bins and the pattern
    rotated per bin on the host, rounded back to integer offsets, so
    sampling stays a constant selection for every bin."""
    base = make_pattern()
    out = np.empty((n_bins,) + base.shape, np.float32)
    for b in range(n_bins):
        th = 2.0 * np.pi * b / n_bins
        c, s = np.cos(th), np.sin(th)
        R = np.array([[c, -s], [s, c]], np.float32)
        out[b] = np.clip(np.rint(base @ R.T), -(ROT_RADIUS - 1), ROT_RADIUS - 1)
    return out


def moment_offsets(radius: int = MOMENT_RADIUS) -> np.ndarray:
    """Disc sample offsets and weights for the orientation moment:
    (P, P, 3) float32 of (dx, dy, inside-disc)."""
    ys, xs = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    inside = (xs * xs + ys * ys) <= radius * radius
    return np.stack([xs, ys, inside], axis=-1).astype(np.float32)


def make_pattern_3d(seed: int = 11) -> np.ndarray:
    """The 3D BRIEF pair pattern: (N_BITS, 2, 3) float32 (pair,
    endpoint, (x, y, z)) integer offsets, Gaussian with a smaller z
    extent, clipped to the anisotropic patch."""
    rng = np.random.default_rng(seed)
    xy = rng.normal(0.0, RADIUS_XY / 2.0, size=(N_BITS, 2, 2))
    z = rng.normal(0.0, RADIUS_Z / 2.0, size=(N_BITS, 2, 1))
    pts = np.concatenate([xy, z], axis=-1)
    lim = np.array([RADIUS_XY, RADIUS_XY, RADIUS_Z])
    return np.rint(np.clip(pts, -lim, lim)).astype(np.float32)


PATTERN = make_pattern()
ROT_PATTERNS = make_rotated_patterns()
MOMENTS = moment_offsets()
PATTERN_3D = make_pattern_3d()
