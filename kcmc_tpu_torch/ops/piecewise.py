"""Piecewise-rigid (patch-grid) non-rigid correction: config 3.

Counterpart of `kcmc_tpu/ops/piecewise.py`, batched over frames (and
over frames x patches inside the estimator) instead of vmapped:

1. a global translation RANSAC with a generous threshold rejects gross
   mismatches and anchors patches with little data;
2. per-patch translation consensus over the matches within ~1.5 patch
   pitches of each patch centre, blended toward the global displacement
   by inlier mass;
3. the (gh, gw, 2) field is smoothed by a normalized Gaussian, then
   refined in residual passes with a shrinking reach.

Field convention: u lives on reference coordinates, u(r) =
position-in-frame(r) - r, and the corrected frame is frame(p + u(p)).
The reference pins Precision.HIGHEST for the two patch-centre matvecs;
here they are written out in float32 (the backend turns TF32 off).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kcmc_tpu_torch.models.transforms import MODELS
from kcmc_tpu_torch.ops.polish import measure_shifts
from kcmc_tpu_torch.ops.polish import region_centers as patch_centers
from kcmc_tpu_torch.ops.ransac import ransac_estimate
from kcmc_tpu_torch.utils import prng

__all__ = [
    "FieldResult", "correlation_polish", "estimate_field", "patch_centers",
    "sample_field_at", "smooth_field", "upsample_field",
]


class FieldResult(NamedTuple):
    field: torch.Tensor  # (B, gh, gw, 2) patch-centre displacements
    n_inliers: torch.Tensor  # (B,) int32, global stage
    rms_residual: torch.Tensor  # (B,) float32, global stage


def _gauss1d(sigma: float, radius: int, device=None) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    x = x / max(sigma, 1e-6)
    k = torch.exp(-0.5 * (x * x))
    return k / torch.sum(k)


def _blur_axis(c: torch.Tensor, k: torch.Tensor, radius: int, dim: int) -> torch.Tensor:
    """Zero-padded correlation of c with the (2r+1,) kernel k along dim
    (-2 or -1), summed tap by tap in ascending order."""
    n = c.shape[dim]
    pad = [radius, radius] if dim == -1 else [0, 0, radius, radius]
    cp = torch.nn.functional.pad(c, pad)
    acc = torch.zeros_like(c)
    for t in range(2 * radius + 1):
        acc = acc + cp.narrow(dim, t, n) * k[t]
    return acc


def smooth_field(field: torch.Tensor, sigma: float) -> torch.Tensor:
    """Normalized separable Gaussian smoothing of (..., gh, gw, 2)
    fields (rows, then columns; zero padding normalized by the blurred
    ones)."""
    if sigma <= 0:
        return field
    radius = max(1, int(2.0 * sigma + 0.5))
    k = _gauss1d(sigma, radius, field.device)

    def blur(chan):  # (..., gh, gw)
        return _blur_axis(_blur_axis(chan, k, radius, -2), k, radius, -1)

    num = torch.stack([blur(field[..., i]) for i in range(field.shape[-1])], dim=-1)
    den = blur(torch.ones(field.shape[-3:-1], dtype=field.dtype, device=field.device))
    return num / torch.clamp(den, min=1e-6)[..., None]


def upsample_field(field: torch.Tensor, shape) -> torch.Tensor:
    """Bilinear cell-centred upsample of (..., gh, gw, 2) to (..., H, W, 2)."""
    gh, gw = field.shape[-3:-1]
    H, W = shape
    dev = field.device
    ys = torch.clamp((torch.arange(H, dtype=torch.float32, device=dev) + 0.5) * gh / H - 0.5,
                     0, gh - 1)
    xs = torch.clamp((torch.arange(W, dtype=torch.float32, device=dev) + 0.5) * gw / W - 0.5,
                     0, gw - 1)
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=gh - 1)
    x1 = torch.clamp(x0 + 1, max=gw - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]

    def at(yi, xi):
        return field[..., yi, :, :][..., :, xi, :]

    return (
        at(y0, x0) * (1 - fy) * (1 - fx)
        + at(y0, x1) * (1 - fy) * fx
        + at(y1, x0) * fy * (1 - fx)
        + at(y1, x1) * fy * fx
    )


def sample_field_at(field: torch.Tensor, pts: torch.Tensor, shape) -> torch.Tensor:
    """Bilinear samples of (B, gh, gw, 2) fields at (B, N, 2) (x, y)
    points: the point-wise counterpart of `upsample_field`."""
    B, gh, gw, _ = field.shape
    H, W = shape
    gx = torch.clamp((pts[..., 0] + 0.5) * gw / W - 0.5, 0, gw - 1)
    gy = torch.clamp((pts[..., 1] + 0.5) * gh / H - 0.5, 0, gh - 1)
    x0 = torch.floor(gx).to(torch.int64)
    y0 = torch.floor(gy).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=gw - 1)
    y1 = torch.clamp(y0 + 1, max=gh - 1)
    fx = (gx - x0)[..., None]
    fy = (gy - y0)[..., None]
    flat = field.reshape(B, gh * gw, 2)

    def at(i):
        return torch.gather(flat, 1, i[..., None].expand(i.shape + (2,)))

    return (
        at(y0 * gw + x0) * (1 - fx) * (1 - fy)
        + at(y0 * gw + x1) * fx * (1 - fy)
        + at(y1 * gw + x0) * (1 - fx) * fy
        + at(y1 * gw + x1) * fx * fy
    )


def _disp_at_centers(M: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """M[:2, :2] @ c + M[:2, 2] - c for (B, P, 3, 3) fits at (P, 2)
    centres, in full float32."""
    cx, cy = centers[:, 0], centers[:, 1]
    dx = (M[..., 0, 0] * cx + M[..., 0, 1] * cy) + M[..., 0, 2] - cx
    dy = (M[..., 1, 0] * cx + M[..., 1, 1] * cy) + M[..., 1, 2] - cy
    return torch.stack([dx, dy], dim=-1)


def _f32(x: float) -> float:
    return float(np.float32(x))


def estimate_field(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    keys: torch.Tensor,
    grid,
    shape,
    n_global_hyps: int = 64,
    patch_hyps: int = 32,
    global_threshold: float = 8.0,
    patch_threshold: float = 2.0,
    prior: float = 8.0,
    smooth_sigma: float = 0.7,
    passes: int = 2,
    refine_reach_scale: float = 1.0,
    patch_model: str = "translation",
    refine_hyps: int = 0,
) -> FieldResult:
    """Per-patch consensus displacement fields of a batch (piecewise.py:
    134): src/dst (B, N, 2) reference/frame keypoint positions of the
    matches, valid (B, N), keys (B, 2) per-frame keys. Every frame's
    patches run as one (B x patches) RANSAC block per pass."""
    gh, gw = grid
    B, N = src.shape[:2]
    dev = src.device
    translation = MODELS["translation"]
    pmodel = MODELS[patch_model]
    ks = prng.split(keys, 2)
    kg, kp = ks[:, 0], ks[:, 1]

    gres = ransac_estimate(translation, src, dst, valid, kg,
                           n_hypotheses=n_global_hyps, threshold=global_threshold)
    g_t = gres.transform[:, None, :2, 2]  # (B, 1, 2)
    ok = gres.inlier_mask  # (B, N)

    centers = patch_centers(grid, shape, device=dev).reshape(-1, 2)  # (P, 2)
    P = centers.shape[0]
    ph, pw = shape[0] / gh, shape[1] / gw
    pitch = _f32(max(ph, pw))
    reach = _f32(1.5 * pitch)
    diff = src[:, None, :, :] - centers[None, :, None, :]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]  # (B, P, N)
    srcP = src[:, None].expand(B, P, N, 2)

    def patch_fits(dstP, member, pkeys, n_hyps):
        res = ransac_estimate(pmodel, srcP, dstP, member, pkeys,
                              n_hypotheses=n_hyps, threshold=patch_threshold)
        return _disp_at_centers(res.transform, centers), res.n_inliers.to(torch.float32)

    member = ok[:, None, :] & (d2 < _f32(reach * reach))
    disp, mass = patch_fits(dst[:, None].expand(B, P, N, 2), member,
                            prng.split(kp, P), patch_hyps)
    # trust region around the global displacement, then the inlier-mass
    # blend toward it
    delta = disp - g_t
    nrm = torch.sqrt(torch.sum(delta * delta, dim=-1, keepdim=True) + 1e-12)
    disp = g_t + delta * torch.clamp(2.0 * global_threshold / nrm, max=1.0)
    lam = (mass / (mass + prior))[..., None]
    field = smooth_field((lam * disp + (1.0 - lam) * g_t).reshape(B, gh, gw, 2), smooth_sigma)

    scale = np.float32(refine_reach_scale)
    for it in range(passes - 1):
        reach_r = max(_f32(np.float32(reach) * scale ** (it + 1)), _f32(0.75 * pitch))
        pred = sample_field_at(field, src, shape)  # (B, N, 2)
        resid = dst - src - pred
        gate = ok & (torch.sum(resid * resid, dim=-1) < (2.0 * patch_threshold) ** 2)
        member = gate[:, None, :] & (d2 < _f32(reach_r * reach_r))
        rkeys = prng.split(prng.fold_in(kp, it + 1), P)
        disp, mass = patch_fits((dst - pred)[:, None].expand(B, P, N, 2), member,
                                rkeys, refine_hyps or patch_hyps)
        nrm = torch.sqrt(torch.sum(disp * disp, dim=-1, keepdim=True) + 1e-12)
        disp = disp * torch.clamp(2.0 * patch_threshold / nrm, max=1.0)
        lam = (mass / (mass + prior))[..., None]
        field = smooth_field(field + (lam * disp).reshape(B, gh, gw, 2), smooth_sigma)

    return FieldResult(field, gres.n_inliers, gres.rms_residual)


def correlation_polish(corrected: torch.Tensor, template: torch.Tensor, grid,
                       window_frac: float = 0.25) -> torch.Tensor:
    """Photometric field corrections (B, gh, gw, 2) of flow-warped frames
    (B, H, W) against the template (H, W), to ADD to the field: the
    negated per-patch shifts of the `exact` correlation estimator."""
    d, _ = measure_shifts(corrected, template, grid, window_frac, exact=True)
    return -d
