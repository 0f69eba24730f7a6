"""Dtype-cast helpers shared by the host and device output paths."""

from __future__ import annotations

import numpy as np


def int_clip_bounds(int_dtype: np.dtype, float_dtype: np.dtype):
    """Clip bounds for a round-to-integer cast, exactly representable in
    the float dtype doing the math.

    float32(2**31 - 1) rounds UP to 2**31.0, so clipping int32 targets
    against np.iinfo(int32).max in float32 lets boundary values pass
    through as 2**31.0 and wrap to INT32_MIN on the final astype. Bounds
    are stepped one ulp inward whenever the float cast rounded outward,
    so clip-then-astype is always in range.
    """
    info = np.iinfo(int_dtype)
    f = np.dtype(float_dtype).type
    lo, hi = f(info.min), f(info.max)
    if int(hi) > info.max:
        hi = np.nextafter(hi, f(0))
    if int(lo) < info.min:
        lo = np.nextafter(lo, f(0))
    return lo, hi
