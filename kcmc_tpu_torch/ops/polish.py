"""Photometric residual-shift measurement and the transform polish.

Counterpart of `kcmc_tpu/ops/polish.py`: both measurement branches, the
ring-windowed index-shifted one `polish_transforms` uses and the `exact`
per-region one the piecewise field polish uses. After the batch warp, each
corrected frame's per-region residual shift against the template is
measured by a center-weighted two-way cross-correlation at the 3x3
integer shifts with a separable quadratic peak fit; the model's own
solver fits (c -> c - d) over the significant, fully covered regions,
and the update composes as M' = M @ A in full float32 (the reference
pins Precision.HIGHEST there; the backend turns TF32 off on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from kcmc_tpu_torch.models.transforms import get_model
from kcmc_tpu_torch.ops.describe import edge_pad
from kcmc_tpu_torch.ops.warp import coverage_mask, valid_rect_mask


def region_window(sh: int, sw: int, window_frac: float, device=None,
                  ring: bool = True) -> torch.Tensor:
    """Flattened normalized Gaussian window of an (sh, sw) region, built
    in float64 numpy and cast (polish.region_window). With `ring` its
    outer 1-px ring is zero, which makes the index-shifted second
    correlation term of `measure_shifts` exact; the `exact` branch uses
    the full window."""
    yy = (np.arange(sh, dtype=np.float64) - (sh - 1) / 2) / (window_frac * sh)
    xx = (np.arange(sw, dtype=np.float64) - (sw - 1) / 2) / (window_frac * sw)
    w2 = np.exp(-0.5 * (yy[:, None] ** 2 + xx[None, :] ** 2))
    if ring and sh > 2 and sw > 2:
        mask = np.zeros((sh, sw))
        mask[1:-1, 1:-1] = 1.0
        w2 = w2 * mask
    w = (w2 / w2.sum()).reshape(-1)
    return torch.as_tensor(w.astype(np.float32), device=device)


def region_patches(x: torch.Tensor, grid) -> torch.Tensor:
    """(..., H, W) -> (..., gh, gw, sh*sw): whole regions, flattened."""
    gh, gw = grid
    H, W = x.shape[-2:]
    sh, sw = H // gh, W // gw
    lead = tuple(x.shape[:-2])
    p = x[..., : gh * sh, : gw * sw].reshape(lead + (gh, sh, gw, sw))
    return p.transpose(-3, -2).reshape(lead + (gh, gw, sh * sw))


def region_centers(grid, shape, device=None) -> torch.Tensor:
    """(gh, gw, 2) cell-center (x, y) coordinates of the region grid."""
    gh, gw = grid
    H, W = shape
    cy = (torch.arange(gh, dtype=torch.float32, device=device) + 0.5) * H / gh - 0.5
    cx = (torch.arange(gw, dtype=torch.float32, device=device) + 0.5) * W / gw - 0.5
    return torch.stack(torch.meshgrid(cx, cy, indexing="xy"), dim=-1)


_SHIFTS = ((0, 0), (0, -1), (0, 1), (-1, 0), (1, 0))


def _exact_scores(corrected, template, grid, window_frac: float):
    """The `exact` branch's scores (polish.py:164): per-region two-way
    correlation with the full window, every shifted view zero-meaned.
    Returns (s_c, s_xm, s_xp, s_ym, s_yp, e_c, e_t)."""
    B, H, W = corrected.shape
    gh, gw = grid
    w = region_window(H // gh, W // gw, window_frac, device=corrected.device, ring=False)

    def zero_mean(p):
        return p - torch.sum(w * p, dim=-1, keepdim=True)

    C = zero_mean(region_patches(corrected, grid))
    T0 = zero_mean(region_patches(template, grid))
    tpad = edge_pad(template, 1)
    cpad = edge_pad(corrected, 1)

    def score(dy, dx):
        t = zero_mean(region_patches(tpad[1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W], grid))
        c = zero_mean(region_patches(cpad[:, 1 - dy: 1 - dy + H, 1 - dx: 1 - dx + W], grid))
        return torch.sum(w * (C * t + c * T0), dim=-1)

    return (
        *(score(dy, dx) for dy, dx in _SHIFTS),
        torch.sum(w * C * C, dim=-1),
        torch.sum(w * T0 * T0, dim=-1),
    )


def measure_shifts(corrected, template, grid, window_frac: float = 0.25,
                   exact: bool = False):
    """(d (B, gh, gw, 2), significant (B, gh, gw)): per-region residual
    shifts of corrected (B, H, W) against template (H, W); content
    displaced by eps peaks at d = -eps. `exact` takes the per-region
    full-window estimator of the piecewise field polish."""
    scores = _exact_scores if exact else _ring_scores
    s_c, s_xm, s_xp, s_ym, s_yp, e_c, e_t = scores(corrected, template, grid, window_frac)
    significant = s_c > 0.2 * torch.sqrt(e_c * e_t * 4.0) + 1e-12

    def subpixel(sm, sp):
        denom = sm - 2.0 * s_c + sp
        peak = denom < -1e-12
        off = torch.where(
            peak,
            0.5 * (sm - sp) / torch.where(peak, denom, torch.full_like(denom, -1.0)),
            torch.sign(sp - sm),
        )
        off = torch.where(significant, off, torch.zeros_like(off))
        return torch.clamp(off, -1.0, 1.0)

    d = torch.stack([subpixel(s_xm, s_xp), subpixel(s_ym, s_yp)], dim=-1)
    return d, significant


def _ring_scores(corrected, template, grid, window_frac: float):
    """The ring-windowed branch's scores (polish.py:200): term 1 against
    shifted template views, term 2 index-shifted onto the template side.
    Returns (s_c, s_xm, s_xp, s_ym, s_yp, e_c, e_t)."""
    B, H, W = corrected.shape
    gh, gw = grid
    sh, sw = H // gh, W // gw
    w = region_window(sh, sw, window_frac, device=corrected.device)

    def zero_mean(p):
        return p - torch.sum(w * p, dim=-1, keepdim=True)

    CP = region_patches(corrected, grid)  # (B, gh, gw, S)
    V = w * zero_mean(CP)
    T0 = zero_mean(region_patches(template, grid))
    tpad = edge_pad(template, 1)
    tstack = torch.stack([
        region_patches(tpad[1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W], grid)
        for dy, dx in _SHIFTS
    ])  # (5, gh, gw, S)
    t0w = (w * T0).reshape(gh, gw, sh, sw).transpose(1, 2).reshape(gh * sh, gw * sw)
    t0wpad = torch.nn.functional.pad(
        t0w, (1, 1 + W - gw * sw, 1, 1 + H - gh * sh)
    )
    ustack = torch.stack([
        region_patches(t0wpad[1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W], grid)
        for dy, dx in _SHIFTS
    ])
    scores = torch.einsum("bghs,nghs->nbgh", V, tstack)
    scores = scores + torch.einsum("bghs,nghs->nbgh", CP, ustack)
    return (*scores, torch.sum(V * CP, dim=-1), torch.sum(w * T0 * T0, dim=-1))


def _windowed_mean(x: torch.Tensor, grid, window_frac: float) -> torch.Tensor:
    """Per-region mean of (B, H, W) under the measurement's window."""
    H, W = x.shape[-2:]
    gh, gw = grid
    w = region_window(H // gh, W // gw, window_frac, device=x.device)
    return torch.sum(w * region_patches(x, grid), dim=-1)


def polish_transforms(
    corrected: torch.Tensor,
    template: torch.Tensor,
    transforms: torch.Tensor,
    model_name: str,
    grid=(4, 4),
    window_frac: float = 0.25,
    valid_hw: torch.Tensor | None = None,
) -> torch.Tensor:
    """One photometric polish pass of (B, 3, 3) ref -> frame maps
    (polish.py:264). Frames with fewer than 2 * min_samples significant,
    covered regions keep their transform. `valid_hw`: the true (h, w)
    extent of frames bucket-padded to (H, W); a region is then covered
    only where the output pixel lies in the valid rectangle and its
    source sample in the valid extent (polish.py:307-318), so the pad
    edge, which correlates perfectly at zero shift, drops out of the
    fit."""
    model = get_model(model_name)
    B, H, W = corrected.shape
    d, sig = measure_shifts(corrected, template, grid, window_frac)
    if valid_hw is None:
        cov = coverage_mask((H, W), transforms)
    else:
        vhw = valid_hw.to(corrected.device)
        cov = valid_rect_mask((H, W), vhw)[None] & coverage_mask((H, W), transforms, vhw)
    covw = _windowed_mean(cov.to(torch.float32), grid, window_frac)
    sig = sig & (covw >= 0.98)
    centers = region_centers(grid, (H, W), device=corrected.device).reshape(1, -1, 2)
    wts = sig.reshape(B, -1).to(torch.float32)
    A = model.resolved_refine_solve(
        centers.expand(B, -1, -1), centers - d.reshape(B, -1, 2), wts
    )
    ok = wts.sum(dim=-1) >= 2.0 * float(model.min_samples)
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand_as(A)
    A = torch.where(ok[:, None, None], A, eye)
    return torch.matmul(transforms, A)
