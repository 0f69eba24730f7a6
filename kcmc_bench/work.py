"""The work of the batch program, counted from shapes and counts alone.

The numerator of `kernel_roofline_share`: for every step of one batch
(detect, describe, moments and select, match, consensus, warp, polish)
the bytes it must read and write and the operations it must do at the
cell's shapes and configuration, priced at the H100's published peaks.
A step's least time is the larger of its bytes over the memory rate and
its operations over the peak of their type; the batch's least time is
the sum over its steps. The count follows the work, never a kernel's
name: a program that fuses, renames or moves a step reads the same
work. Each input byte is read once and each output byte written once;
where the work depends on the data (valid keypoints, matches), the
counts the run reported are used.

The kernel-shaped terms are the arithmetic of `chip_smoke.py`'s bounds
(`bound_ms`, `field_warp_ops` and the per-kernel bytes and operations),
frozen here; tests/test_kcmc_bench_work.py reproduces the port's kernel
table (PERF.md) from them. numpy only.
"""

from __future__ import annotations

import numpy as np

from kcmc_bench.reference.patterns import (
    MOMENTS,
    MOMENT_RADIUS,
    N_BITS,
    N_ORIENT_BINS,
    PATCH_RADIUS,
    ROT_RADIUS,
)

# NVIDIA H100 SXM, published (data sheet; dense, no sparsity), at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
BF16_TC_FLOPS = 989e12  # bf16 tensor cores
INT8_TC_OPS = 1979e12  # int8 tensor cores
RUN_ALIGN = 16  # the oriented describe's block of rows (K5)


def bound_s(n_bytes: float, n_ops: float, rate: float = F32_FLOPS) -> float:
    """Least seconds for a step: bytes over the memory rate or operations
    over their peak, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / rate)


def gauss_taps(sigma: float) -> int:
    """Number of taps of the detector's normalized Gaussian of `sigma`."""
    return 2 * max(1, int(3.0 * sigma + 0.5)) + 1


# -- the kernel-shaped steps ---------------------------------------------------


def detect(B: int, H: int, W: int, window_sigma: float, smooth_sigma: float) -> float:
    """K1's work: the frame read and four response fields written,
    (float32), and the smoothing, structure tensor, windowing, Harris
    response, NMS and subpixel operations per pixel."""
    px = B * H * W
    g, s = gauss_taps(window_sigma), gauss_taps(smooth_sigma)
    flops_px = 2 * (2 * s - 1) + 4 * 5 + 3 + 6 * (2 * g - 1) + 7 + 8 + 20
    return bound_s(px * 4 * 5, px * flops_px)


def patches(B: int, H: int, W: int, rows: int, P: int, radius: int) -> float:
    """K2's work: the edge-padded bf16 smooth frame read, the keypoint
    coordinates, `rows` (P-1)^2 bf16 patches written, 9 operations each
    sample (two bilinear weights and the blend)."""
    pad = radius + 1
    padded = B * (H + 2 * pad) * (W + 2 * pad)
    n_out = rows * (P - 1) ** 2
    return bound_s(padded * 2 + rows * 2 * 4 + n_out * 2, n_out * 9)


def band_widths() -> list[int]:
    """Half-widths of the orientation disc's rows (K4's bands)."""
    mr = MOMENT_RADIUS
    out = []
    for i in range(2 * mr + 1):
        inside = MOMENTS[i, :, 2] > 0
        if inside.any():
            out.append(int(abs(MOMENTS[i, inside, 0]).max()))
    return out


def moments(B: int, H: int, W: int) -> float:
    """K4's work: the padded bf16 smooth frame read, the two float32
    moment maps written, the disc's row sums once per width."""
    pad = ROT_RADIUS + 1
    Hp, Wp = H + 2 * pad, W + 2 * pad
    n_map = B * (Hp - 2 * MOMENT_RADIUS) * (Wp - 2 * MOMENT_RADIUS)
    widths = band_widths()
    ops_px = sum(6 * w for w in sorted(set(widths))) + len(widths) + 2 * 14
    return bound_s(B * Hp * Wp * 2 + 2 * n_map * 4, n_map * ops_px)


def select(rows: int, L: int, V: int) -> float:
    """K5's work: each keypoint's L patch samples times its orientation
    bin's (L, V) one-hot matrix on the bf16 tensor cores."""
    blocks = -(-rows // RUN_ALIGN)
    n_bytes = rows * L * 2 + N_ORIENT_BINS * L * V * 2 + blocks * 4 + rows * V * 2
    return bound_s(n_bytes, 2.0 * rows * L * V, BF16_TC_FLOPS)


def warp_matrix(B: int, H: int, W: int) -> float:
    """K7's work: the frames read and written once, the maps, 126
    operations per output pixel."""
    px = B * H * W
    return bound_s(2 * px * 4 + B * 9 * 4 + B, px * 126)


def field_warp_ops(B: int, H: int, W: int, gh: int, gw: int) -> int:
    """Float operations of the piecewise field warp's function, each
    term once at the granularity it varies on (chip_smoke.py)."""
    per_canvas_px = 2 * (17 + 1) + 17 + 6
    per_out_px = 6 + 2 + 4 + 9
    return (W * 14 + B * gh * W * 2 * 3 + H * 14
            + B * H * W * (per_canvas_px + per_out_px) + B * gh * gw * 8)


def warp_field(B: int, H: int, W: int, gh: int, gw: int) -> float:
    """K8's work: the frames read and written once, the fields."""
    return bound_s(2 * B * H * W * 4 + B * gh * gw * 2 * 4 + B,
                   field_warp_ops(B, H, W, gh, gw))


# -- the steps without a table row --------------------------------------------


def match(q_rows: int, r_rows: int) -> float:
    """Hamming distances of each of `q_rows` valid frame keypoints
    against the `r_rows` valid reference keypoints: 2 N_BITS operations
    a pair (the dot product of 0/1 bits), at the int8 tensor-core peak;
    descriptors read once, one (index, distance) pair written per
    keypoint."""
    words = N_BITS // 8
    pairs = q_rows * r_rows
    return bound_s(q_rows * words + r_rows * words + q_rows * 8, 2.0 * N_BITS * pairs,
                   INT8_TC_OPS)


def consensus(matches: int, hypotheses: int, per_residual: int, passes: int = 1) -> float:
    """Scoring every hypothesis on every match: a residual of
    `per_residual` float32 operations, `passes` times; the matches'
    coordinates read once."""
    return bound_s(matches * 16, float(matches) * hypotheses * per_residual * passes)


def polish(B: int, H: int, W: int) -> float:
    """One photometric polish pass: the warped frames and the template
    read, 20 operations a pixel (five shifted correlations, two terms)."""
    return bound_s(B * H * W * 4 + H * W * 4, B * H * W * 20)


RESIDUAL_OPS = {"translation": 6, "rigid": 14, "similarity": 14, "affine": 14,
                "homography": 20}


def batch_seconds(settings, H: int, W: int, keypoints: np.ndarray, matches: np.ndarray,
                  ref_keypoints: int) -> float:
    """Least seconds of one batch of the program at these shapes:
    `keypoints` and `matches` are the batch's per-frame valid keypoint
    and match counts, `ref_keypoints` the reference's valid keypoints."""
    B = len(keypoints)
    rows = int(np.sum(keypoints))
    m = int(np.sum(matches))
    t = detect(B, H, W, settings.harris_window_sigma, settings.blur_sigma)
    oriented = (settings.oriented if settings.oriented is not None
                else settings.model not in ("translation", "piecewise"))
    if oriented:
        P = 2 * ROT_RADIUS + 2
        t += moments(B, H, W) + patches(B, H, W, rows, P, ROT_RADIUS)
        t += select(rows, (P - 1) ** 2, 2 * N_BITS)
    else:
        t += patches(B, H, W, rows, 2 * PATCH_RADIUS + 2, PATCH_RADIUS)
    t += match(rows, ref_keypoints)
    if settings.model == "piecewise":
        gh, gw = settings.patch_grid
        t += consensus(m, settings.n_hypotheses, RESIDUAL_OPS["translation"])
        t += consensus(m, settings.patch_hypotheses, RESIDUAL_OPS[settings.patch_model],
                       settings.field_passes)
        n = 1 + int(settings.field_polish)
        t += n * warp_field(B, H, W, gh, gw) + (n - 1) * polish(B, H, W)
    else:
        t += consensus(m, settings.n_hypotheses, RESIDUAL_OPS[settings.model],
                       1 + int(settings.refine_iters))
        n = 1 + int(settings.transform_polish)
        t += n * warp_matrix(B, H, W) + (n - 1) * polish(B, H, W)
    return t


def reference_seconds(settings, H: int, W: int, ref_keypoints: int) -> float:
    """Least seconds of a call's reference preparation: detect and
    describe of the one reference frame."""
    t = detect(1, H, W, settings.harris_window_sigma, settings.blur_sigma)
    oriented = (settings.oriented if settings.oriented is not None
                else settings.model not in ("translation", "piecewise"))
    if oriented:
        P = 2 * ROT_RADIUS + 2
        return (t + moments(1, H, W) + patches(1, H, W, ref_keypoints, P, ROT_RADIUS)
                + select(ref_keypoints, (P - 1) ** 2, 2 * N_BITS))
    return t + patches(1, H, W, ref_keypoints, 2 * PATCH_RADIUS + 2, PATCH_RADIUS)
