"""Single-interpolation matrix warp, the XLA form.

Counterpart of `kcmc_tpu/ops/warp_field.py::warp_batch_matrix`
(warp_field.py:269): affine/projective frames corrected with ONE
bilinear interpolation and no gather of the residual:

1. the analytic source map s(p) = M p, projective divide guarded;
2. an exact integer centre translation (tcx, tcy) onto a canvas haloed
   by P = max_px + 1 (the reference's one-hot clamped-shift matmuls,
   here the same function as clamped integer indexing);
3. a two-pass 1D resample of the bounded residual: the x-pass phase of
   canvas row i is taken at its consumer row, found by two fixed-point
   iterations, then the y-pass phase at the output pixel; both passes
   are sums of 2 (2 max_px + 2) masked shifted views.

Frames whose in-coverage residual exceeds max_px - 0.5 are zeroed and
flagged. This form has no +-PAD translation window and no degenerate
M[2, 2] flag (kernel K7, `cuda_warp_matrix`, adds both); it is the
independent oracle K7's plain version is held against.
"""

from __future__ import annotations

import torch


def smap(m: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Source coordinates of (x, y) under the M[2, 2]-normalized maps m
    (B, 3, 3), broadcast against x and y of shape (B or 1, ...): the
    reference's evaluation order, divisor clamped to |w| >= 1e-6."""
    shape = (m.shape[0],) + (1,) * (x.dim() - 1)

    def c(i, j):
        return m[:, i, j].reshape(shape)

    wq = c(2, 0) * x + c(2, 1) * y + 1.0
    eps = torch.full_like(wq, 1e-6)
    wq = torch.where(wq.abs() < 1e-6, torch.where(wq < 0, -eps, eps), wq)
    return (
        (c(0, 0) * x + c(0, 1) * y + c(0, 2)) / wq,
        (c(1, 0) * x + c(1, 1) * y + c(1, 2)) / wq,
    )


def normalize(transforms: torch.Tensor):
    """(m, okm): M / M[2, 2] where |M[2, 2]| > 1e-6 (else M itself), and
    that condition."""
    m22 = transforms[:, 2, 2]
    okm = m22.abs() > 1e-6
    den = torch.where(okm, m22, torch.ones_like(m22))
    return transforms / den[:, None, None], okm


def center_shift(m: torch.Tensor, shape):
    """(tcx, tcy), (B,) each: the source map of the frame centre minus
    the centre, rounded half to even (the exact integer part of the
    warp)."""
    H, W = shape
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    g, h = m[:, 2, 0], m[:, 2, 1]
    w0 = g * cx + h * cy + 1.0
    w0 = torch.where(w0.abs() < 1e-6, torch.ones_like(w0), w0)
    sx0 = (m[:, 0, 0] * cx + m[:, 0, 1] * cy + m[:, 0, 2]) / w0
    sy0 = (m[:, 1, 0] * cx + m[:, 1, 1] * cy + m[:, 1, 2]) / w0
    return torch.round(sx0 - cx), torch.round(sy0 - cy)


def _tap_weight(mi: torch.Tensor, f: torch.Tensor, k: int) -> torch.Tensor:
    one = torch.ones_like(f)
    zero = torch.zeros_like(f)
    return torch.where(mi == k, one - f, zero) + torch.where(mi == k - 1, f, zero)


def floor_int(v: torch.Tensor, bound: int):
    """(floor(v) as int64, v - floor(v)); the integer is clamped to
    +-(bound + 2) (NaN to the upper end), which keeps every value
    outside the tap window outside it."""
    fl = torch.floor(v)
    lim = float(bound + 2)
    fi = torch.nan_to_num(fl, nan=lim).clamp(-lim, lim).to(torch.int64)
    return fi, v - fl


def warp_batch_matrix(frames: torch.Tensor, transforms: torch.Tensor, max_px: int = 16):
    """Correct (B, H, W) float32 frames through (B, 3, 3) ref -> frame
    maps: (corrected, ok (B,) bool)."""
    B, H, W = frames.shape
    dev = frames.device
    P = max_px + 1
    m, _ = normalize(transforms.to(torch.float32))
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    tcx, tcy = center_shift(m, (H, W))
    tcx3, tcy3 = tcx[:, None, None], tcy[:, None, None]
    sx, sy = smap(m, xs, ys)  # (B, H, W)
    ux = sx - xs - tcx3
    uy = sy - ys - tcy3
    inb = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    resid = torch.maximum(ux.abs(), uy.abs())
    ok = torch.where(inb, resid, torch.zeros_like(resid)).amax(dim=(1, 2)) <= max_px - 0.5

    # exact integer translation onto the haloed canvas (clamped taps)
    def shift_index(n_in, n_out, t):
        off = torch.nan_to_num(t).clamp(-n_in - 2 * P, n_in + 2 * P).to(torch.int64)
        ar = torch.arange(n_out, device=dev)
        return torch.clamp(ar[None, :] + off[:, None] - P, 0, n_in - 1)

    ri = shift_index(H, H + 2 * P, tcy)  # (B, H + 2P)
    ci = shift_index(W, W + 2 * P, tcx)
    bidx = torch.arange(B, device=dev)[:, None, None]
    hp = frames[bidx, ri[:, :, None], ci[:, None, :]]  # (B, H + 2P, W + 2P)

    # pass 1 (x) over canvas rows, phases at the consumer position
    ih = torch.arange(H + 2 * P, dtype=torch.float32, device=dev)[None, :, None]
    yc = (ih - P).expand(B, H + 2 * P, W)
    for _ in range(2):
        _, sy_c = smap(m, xs, yc)
        yc = ih - P - (sy_c - yc - tcy3)
    sx_c, _ = smap(m, xs, yc)
    mxi, fx = floor_int(sx_c - xs - tcx3, max_px)
    r1 = torch.zeros((B, H + 2 * P, W), dtype=torch.float32, device=dev)
    for k in range(-max_px, max_px + 2):
        r1 = r1 + _tap_weight(mxi, fx, k) * hp[:, :, P + k: P + k + W]

    # pass 2 (y): phases exact at the output pixel
    myi, fy = floor_int(uy, max_px)
    out = torch.zeros((B, H, W), dtype=torch.float32, device=dev)
    for k in range(-max_px, max_px + 2):
        out = out + _tap_weight(myi, fy, k) * r1[:, P + k: P + k + H, :]
    keep = ok[:, None, None] & inb
    return torch.where(keep, out, torch.zeros_like(out)), ok
