"""Descriptor sampling pattern and detector constants (numpy only).

A copy of the constants the translation path needs from
`kcmc_tpu/ops/patterns.py`. The port keeps its own copy instead of
importing the JAX package; `tests/test_torch_describe.py` asserts the
two stay equal, which is what keeps descriptor words bit-identical
across the two packages.
"""

from __future__ import annotations

import numpy as np

N_BITS = 256
N_WORDS = N_BITS // 32
PATCH_RADIUS = 13  # BRIEF pattern support radius, pixels
CAND_TILE = 8  # detector candidate-reduction tile side (one keypoint/tile)
WINDOW_SIGMA = 1.5  # Harris structure-tensor window sigma


def make_pattern(seed: int = 7) -> np.ndarray:
    """The BRIEF pair pattern: (N_BITS, 2, 2) float32 (pair, endpoint,
    (x, y)). Gaussian offsets (sigma = radius/2), clipped to the patch
    and rounded to integer pixel offsets, so sampling a blended patch
    is a constant index selection."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH_RADIUS / 2.0, size=(N_BITS, 2, 2))
    return np.rint(np.clip(pts, -PATCH_RADIUS, PATCH_RADIUS)).astype(np.float32)


PATTERN = make_pattern()
