"""Bounded warps without a gather of the residual, the XLA forms: the
single-interpolation matrix warp, the dense-flow warp, the separable
homography route and the rigid3d volume warp.

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

`warp_batch_flow` (warp_field.py:108), `warp_batch_homography` (:416)
and `warp_batch_rigid3d` (:163) have no Pallas kernel in the reference
either: they are plain torch on both devices. The flow warp is the
piecewise route where K8 does not fit (more than 6144 cells); the
homography route is warp="separable": the separable affine chain for
the first-order part, then the small-field resample of the projective
residual. Their one-hot clamped-shift matrices (`_clamped_shift_matrix`,
:36) are integer indexing here (`_shift_index`): one-hot rows copy
exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kcmc_tpu_torch.ops.warp import source_coords_3d
from kcmc_tpu_torch.ops.warp_separable import warp_batch_affine


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


def _shift_index(n_in: int, P: int, t: torch.Tensor) -> torch.Tensor:
    """(B, n_in + 2P) source indices of the canvas translated by the
    integer shifts t (B,) and haloed by P: in[clip(i + t - P, 0, n_in -
    1)], the reference's one-hot clamped-shift matrix as an index."""
    off = torch.nan_to_num(t).clamp(-n_in - 2 * P, n_in + 2 * P).to(torch.int64)
    ar = torch.arange(n_in + 2 * P, device=t.device)
    return torch.clamp(ar[None, :] + off[:, None] - P, 0, n_in - 1)


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
    ri = _shift_index(H, P, tcy)  # (B, H + 2P)
    ci = _shift_index(W, P, tcx)
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


def warp_batch_rigid3d(vols: torch.Tensor, transforms: torch.Tensor, max_px: int = 6):
    """Correct (B, D, H, W) float32 volumes through (B, 4, 4) rigid maps
    with no gather of the residual (warp_field.py:163): the integer
    centre translation onto a canvas haloed by P = max_px + 1, then three
    sequential per-axis 1D resamples (x, y, z) of the bounded residual
    u(p) = M p - p - t, each component read at the ORIGINAL voxel (an
    O(|u| * rotation) approximation, ~0.03 px at 1 degree). A volume
    whose residual exceeds max_px anywhere, or whose map is not affine,
    is zeroed and flagged. Returns (corrected, ok (B,) bool)."""
    B, D, H, W = vols.shape
    dev = vols.device
    P = max_px + 1
    M = transforms.to(torch.float32)
    ok = (
        (M[:, 3, 0].abs() < 1e-12) & (M[:, 3, 1].abs() < 1e-12)
        & (M[:, 3, 2].abs() < 1e-12) & ((M[:, 3, 3] - 1.0).abs() < 1e-6)
    )
    sx, sy, sz = source_coords_3d((D, H, W), M)
    cz, cy, cx = (D - 1) / 2.0, (H - 1) / 2.0, (W - 1) / 2.0

    def centre(i, c):
        return torch.round(M[:, i, 0] * cx + M[:, i, 1] * cy + M[:, i, 2] * cz + M[:, i, 3] - c)

    tcx, tcy, tcz = centre(0, cx), centre(1, cy), centre(2, cz)
    zs = torch.arange(D, dtype=torch.float32, device=dev)[None, :, None, None]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None, :]
    ux = sx - xs - tcx[:, None, None, None]
    uy = sy - ys - tcy[:, None, None, None]
    uz = sz - zs - tcz[:, None, None, None]
    resid = torch.maximum(
        ux.abs().amax(dim=(1, 2, 3)),
        torch.maximum(uy.abs().amax(dim=(1, 2, 3)), uz.abs().amax(dim=(1, 2, 3))),
    )
    ok = ok & (resid <= max_px)

    zi = _shift_index(D, P, tcz)
    yi = _shift_index(H, P, tcy)
    xi = _shift_index(W, P, tcx)
    bidx = torch.arange(B, device=dev)[:, None, None, None]
    hp = vols[bidx, zi[:, :, None, None], yi[:, None, :, None], xi[:, None, None, :]]

    def pass_axis(arr, u, dim, n):
        mi, f = floor_int(u, max_px)
        out = torch.zeros(u.shape, dtype=torch.float32, device=dev)
        for k in range(-max_px, max_px + 2):
            out = out + _tap_weight(mi, f, k) * arr.narrow(dim, P + k, n)
        return out

    uxh = F.pad(ux[:, None], (0, 0, P, P, P, P), mode="replicate")[:, 0]
    r1 = pass_axis(hp, uxh, 3, W)  # (B, D + 2P, H + 2P, W)
    uyh = F.pad(uy[:, None], (0, 0, 0, 0, P, P), mode="replicate")[:, 0]
    r2 = pass_axis(r1, uyh, 2, H)  # (B, D + 2P, H, W)
    r3 = pass_axis(r2, uz, 1, D)  # (B, D, H, W)
    inb = (
        (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
        & (sz >= 0) & (sz <= D - 1)
    )
    keep = ok[:, None, None, None] & inb
    return torch.where(keep, r3, torch.zeros_like(r3)), ok


def _field_resample_small(padded: torch.Tensor, flow: torch.Tensor, R: int) -> torch.Tensor:
    """out[p] = padded[p + R+1 + flow[p]] for |flow| <= R (warp_field.py:
    48): (B, H + 2R + 2, W + 2R + 2) sources whose halo carries the
    border content, (B, H, W, 2) flows of (ux, uy). Two sequential 1D
    passes (x over the still-haloed rows, then y), each component read
    at the ORIGINAL pixel; the caller masks out-of-frame samples."""
    B, H, W = flow.shape[:3]
    mxi, fx = floor_int(flow[..., 0], R)
    myi, fy = floor_int(flow[..., 1], R)
    # the x phases, edge-replicated over the y halo
    rows = torch.clamp(torch.arange(H + 2 * (R + 1), device=flow.device) - (R + 1), 0, H - 1)
    mxi_h, fx_h = mxi[:, rows], fx[:, rows]
    r1 = torch.zeros((B, H + 2 * (R + 1), W), dtype=torch.float32, device=flow.device)
    for k in range(-R, R + 2):
        r1 = r1 + _tap_weight(mxi_h, fx_h, k) * padded[:, :, R + 1 + k: R + 1 + k + W]
    out = torch.zeros((B, H, W), dtype=torch.float32, device=flow.device)
    for k in range(-R, R + 2):
        out = out + _tap_weight(myi, fy, k) * r1[:, R + 1 + k: R + 1 + k + H, :]
    return out


def warp_batch_flow(frames: torch.Tensor, flows: torch.Tensor, max_px: int = 6):
    """Correct (B, H, W) frames through (B, H, W, 2) forward displacement
    fields, corrected(p) = frame(p + u(p)), with no gather of the
    residual (warp_field.py:108): the mean displacement rounded to whole
    pixels is an exact integer translation onto a canvas haloed by
    max_px + 1 (taps edge-clamped like the gather warp's), the residual
    is resampled by `_field_resample_small`. A frame whose residual
    exceeds max_px is zeroed and flagged; pixels whose true sample leaves
    the frame are 0. Returns (corrected, ok (B,) bool)."""
    B, H, W = frames.shape
    dev = frames.device
    frames = frames.to(torch.float32)
    flows = flows.to(torch.float32)
    t = torch.round(flows.mean(dim=(1, 2)))  # (B, 2) integer (tx, ty)
    P = max_px + 1
    ri = _shift_index(H, P, t[:, 1])
    ci = _shift_index(W, P, t[:, 0])
    bidx = torch.arange(B, device=dev)[:, None, None]
    halos = frames[bidx, ri[:, :, None], ci[:, None, :]]  # (B, H + 2P, W + 2P)
    resid = flows - t[:, None, None, :]
    ok = resid.abs().amax(dim=(1, 2, 3)) <= max_px
    out = _field_resample_small(halos, resid, max_px)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    sx = xs + flows[..., 0]
    sy = ys + flows[..., 1]
    inb = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    return torch.where(ok[:, None, None], out * inb, torch.zeros_like(out)), ok


def _affine_about_center(M: torch.Tensor, cx: float, cy: float):
    """First-order Taylor expansion of (B, 3, 3) projective maps at the
    centre (warp_field.py:387): (A (B, 3, 3) affine, ok (B,)), A(p) ~
    M(p) near (cx, cy)."""
    m = M / M[:, 2:3, 2:3]
    g, h = m[:, 2, 0], m[:, 2, 1]
    w0 = g * cx + h * cy + 1.0
    ok = w0.abs() > 1e-3
    w0 = torch.where(ok, w0, torch.ones_like(w0))
    sx0 = (m[:, 0, 0] * cx + m[:, 0, 1] * cy + m[:, 0, 2]) / w0
    sy0 = (m[:, 1, 0] * cx + m[:, 1, 1] * cy + m[:, 1, 2]) / w0
    a00 = (m[:, 0, 0] - g * sx0) / w0
    a01 = (m[:, 0, 1] - h * sx0) / w0
    a10 = (m[:, 1, 0] - g * sy0) / w0
    a11 = (m[:, 1, 1] - h * sy0) / w0
    zero, one = torch.zeros_like(a00), torch.ones_like(a00)
    A = torch.stack([
        torch.stack([a00, a01, sx0 - a00 * cx - a01 * cy], -1),
        torch.stack([a10, a11, sy0 - a10 * cx - a11 * cy], -1),
        torch.stack([zero, zero, one], -1),
    ], dim=1)
    return A, ok


def warp_batch_homography(frames: torch.Tensor, transforms: torch.Tensor,
                          shear_px: int = 8, max_px: int = 4):
    """Correct (B, H, W) frames through (B, 3, 3) homographies with no
    gather (warp_field.py:416): H = A N with A the first-order part about
    the centre, warped by the separable affine chain (bound shear_px),
    and N = A^-1 H / H[2, 2] a near-identity residual resampled by
    `_field_resample_small` (bound max_px). Coverage from the true
    homography. Returns (corrected, ok (B,) bool)."""
    B, H, W = frames.shape
    dev = frames.device
    frames = frames.to(torch.float32)
    Ms = transforms.to(torch.float32)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    As, oks = _affine_about_center(Ms, cx, cy)
    Ns = torch.linalg.solve(As, Ms / Ms[:, 2:3, 2:3])
    oks = oks & (Ms[:, 2, 2].abs() > 1e-6)
    base, affine_ok = warp_batch_affine(frames, As, shear_px=shear_px, with_ok=True)
    oks = oks & affine_ok
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]

    def source(m):  # (B, H, W) sample positions of (B, 3, 3) maps
        def c(i, j):
            return m[:, i, j, None, None]

        w = c(2, 0) * xs + c(2, 1) * ys + c(2, 2)
        w = torch.where(w.abs() < 1e-8, torch.full_like(w, 1e-8), w)
        return (c(0, 0) * xs + c(0, 1) * ys + c(0, 2)) / w, (c(1, 0) * xs + c(1, 1) * ys + c(1, 2)) / w

    sx, sy = source(Ns)
    flows = torch.stack([sx - xs, sy - ys], dim=-1)  # N(p) - p
    ok = oks & (flows.abs().amax(dim=(1, 2, 3)) <= max_px)
    padded = F.pad(base[:, None], (max_px + 1,) * 4, mode="replicate")[:, 0]
    out = _field_resample_small(padded, flows, max_px)
    sx, sy = source(Ms)
    inb = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    return torch.where(ok[:, None, None], out * inb, torch.zeros_like(out)), ok
