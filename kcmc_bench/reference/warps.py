"""The warps the program says it applied, in plain PyTorch (CPU).

Frozen copies of the program's plain versions of its two bounded warp
kernels and of its gather warps, so that the correctness check can warp
a frame by the transform or field the program reported and compare the
result with the program's corrected frame:

* `warp_matrix`: K7's function (`ops/cuda_warp_matrix.py`
  `warp_batch_matrix_plain` with `ops/warp_field.py`'s `smap`,
  `normalize`, `center_shift`, `floor_int`): one interpolation, a
  fixed-point x-phase per canvas row, taps inside the kernel's window;
* `warp_field`: K8's function (`ops/cuda_warp_field.py`
  `warp_batch_field_plain`);
* `warp_gather` and `warp_flow`: the exact bilinear gather warps
  (`ops/warp.py`), the route of rescued and escalated frames;
* `matrix_resid_px`: K7's residual bound of a frame shape
  (`TorchBackend._matrix_resid_px`).

Imports torch only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PAD = 128  # max |centre shift| the bounded warps handle exactly, pixels


def matrix_resid_px(settings, shape) -> int:
    """K7's residual bound: the rotation, projective and scale
    allowances, at least 12."""
    if settings.max_rotation_deg is None:
        shear = settings.max_shear_px
    else:
        shear = int(math.ceil(math.tan(math.radians(settings.max_rotation_deg)) * max(shape) / 2.0))
    scale_margin = max(4, int(settings.max_scale_dev * max(shape) / 2) + 1)
    return max(12, shear + settings.max_projective_px + scale_margin)


# -- helpers of the bounded warps (ops/warp_field.py) ------------------------


def smap(m: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
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
    m22 = transforms[:, 2, 2]
    okm = m22.abs() > 1e-6
    den = torch.where(okm, m22, torch.ones_like(m22))
    return transforms / den[:, None, None], okm


def center_shift(m: torch.Tensor, shape):
    H, W = shape
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    g, h = m[:, 2, 0], m[:, 2, 1]
    w0 = g * cx + h * cy + 1.0
    w0 = torch.where(w0.abs() < 1e-6, torch.ones_like(w0), w0)
    sx0 = (m[:, 0, 0] * cx + m[:, 0, 1] * cy + m[:, 0, 2]) / w0
    sy0 = (m[:, 1, 0] * cx + m[:, 1, 1] * cy + m[:, 1, 2]) / w0
    return torch.round(sx0 - cx), torch.round(sy0 - cy)


def floor_int(v: torch.Tensor, bound: int):
    fl = torch.floor(v)
    lim = float(bound + 2)
    fi = torch.nan_to_num(fl, nan=lim).clamp(-lim, lim).to(torch.int64)
    return fi, v - fl


def window_lerp(i: torch.Tensor, f: torch.Tensor, v0, v1, max_px: int) -> torch.Tensor:
    zero = torch.zeros_like(f)
    a = torch.where((i >= -max_px) & (i <= max_px + 1), (1.0 - f) * v0, zero)
    return a + torch.where((i >= -max_px - 1) & (i <= max_px), f * v1, zero)


# -- K7's function ------------------------------------------------------------


def warp_matrix(frames: torch.Tensor, transforms: torch.Tensor, max_px: int):
    """(corrected (B, H, W), ok (B,)) of K7 for (B, 3, 3) ref -> frame maps."""
    B, H, W = frames.shape
    dev = frames.device
    m, okm = normalize(transforms)
    tcx, tcy = center_shift(m, (H, W))
    exact = (tcy >= -PAD) & (tcy <= PAD) & (tcx >= -PAD) & (tcx <= PAD)
    tcx3, tcy3 = tcx[:, None, None], tcy[:, None, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    lim = float(PAD + 1)
    ty = torch.nan_to_num(tcy).clamp(-lim, lim).to(torch.int64)[:, None, None]
    tx = torch.nan_to_num(tcx).clamp(-lim, lim).to(torch.int64)[:, None, None]
    flat = frames.reshape(B, H * W)
    xi = torch.arange(W, device=dev)[None, None, :]

    def source(row, k):
        r = torch.clamp(row + ty, 0, H - 1)
        c = torch.clamp(xi + k + tx, 0, W - 1)
        idx = (r * W + c).expand(B, H, W).reshape(B, -1)
        return torch.gather(flat, 1, idx).reshape(B, H, W)

    sx_o, sy_o = smap(m, xs, ys)
    ux = sx_o - xs - tcx3
    uy = sy_o - ys - tcy3
    myi, fy = floor_int(uy, max_px)
    rows = []
    for j in (0, 1):
        yb = ys.to(torch.int64) + myi + j
        ybf = yb.to(torch.float32)
        yc = ybf
        for _ in range(2):
            _, sy_c = smap(m, xs, yc)
            yc = ybf - (sy_c - yc - tcy3)
        sx_c, _ = smap(m, xs, yc)
        mxi, fx = floor_int(sx_c - xs - tcx3, max_px)
        rows.append(window_lerp(mxi, fx, source(yb, mxi), source(yb, mxi + 1), max_px))
    acc = window_lerp(myi, fy, rows[0], rows[1], max_px)
    inb = (sx_o >= 0.0) & (sx_o <= W - 1.0) & (sy_o >= 0.0) & (sy_o <= H - 1.0)
    resid = torch.maximum(ux.abs(), uy.abs())
    maxr = torch.where(inb, resid, torch.zeros_like(resid)).amax(dim=(1, 2))
    ok = okm & exact & (maxr <= max_px - 0.5)
    keep = inb & ok[:, None, None]
    return torch.where(keep, acc, torch.zeros_like(acc)), ok


# -- K8's function ------------------------------------------------------------


def _hat(u: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - (u - c.to(torch.float32)).abs(), min=0.0)


def warp_field(frames: torch.Tensor, fields: torch.Tensor, max_px: int):
    """(corrected (B, H, W), ok (B,)) of K8 for (B, gh, gw, 2) fields."""
    B, H, W = frames.shape
    _, gh, gw, _ = fields.shape
    dev = frames.device
    s = torch.zeros((B, 2), dtype=torch.float32, device=dev)
    for c in range(gh):
        for d in range(gw):
            s = s + fields[:, c, d]
    t = torch.round(s / float(gh * gw))
    maxr = (fields - t[:, None, None, :]).abs().amax(dim=(1, 2, 3))
    exact = (t.abs() <= PAD).all(dim=1) & (maxr <= max_px - 0.5)
    res = fields - t[:, None, None, :]
    rh, rw = float(np.float32(gh / H)), float(np.float32(gw / W))
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    ucol = torch.clamp((xs + 0.5) * rw - 0.5, 0.0, gw - 1.0)[0, 0]
    d0 = torch.floor(ucol).to(torch.int64)
    d1 = torch.clamp(d0 + 1, max=gw - 1)
    h0, h1 = _hat(ucol, d0), _hat(ucol, d0 + 1)
    has1 = d0 + 1 < gw

    def inner(ch):
        r = res[..., ch]
        a = r[:, :, d0] * h0
        return torch.where(has1, a + r[:, :, d1] * h1, a)

    inner_x, inner_y = inner(0), inner(1)

    def urow_of(y):
        return torch.clamp((y + 0.5) * rh - 0.5, 0.0, gh - 1.0)

    def interp(u, inn):
        u = u.expand(B, H, W)
        c0 = torch.floor(u).to(torch.int64)
        c1 = torch.clamp(c0 + 1, max=gh - 1)
        a = _hat(u, c0) * torch.gather(inn, 1, c0)
        b = _hat(u, c0 + 1) * torch.gather(inn, 1, c1)
        return torch.where(c0 + 1 < gh, a + b, a)

    lim = float(PAD + 1)
    tx = torch.nan_to_num(t[:, 0]).clamp(-lim, lim).to(torch.int64)[:, None, None]
    ty = torch.nan_to_num(t[:, 1]).clamp(-lim, lim).to(torch.int64)[:, None, None]
    flat = frames.reshape(B, H * W)
    xi = torch.arange(W, device=dev)[None, None, :]

    def source(row, k):
        r = torch.clamp(row + ty, 0, H - 1)
        c = torch.clamp(xi + k + tx, 0, W - 1)
        return torch.gather(flat, 1, (r * W + c).expand(B, H, W).reshape(B, -1)).reshape(B, H, W)

    uro = urow_of(ys).expand(1, H, W)
    ry = interp(uro, inner_y)
    rx = interp(uro, inner_x)
    myi, fy = floor_int(ry, max_px)
    rows = []
    for j in (0, 1):
        yb = ys.to(torch.int64) + myi + j
        ybf = yb.to(torch.float32)
        yc = ybf
        for _ in range(2):
            yc = ybf - interp(urow_of(yc), inner_y)
        mxi, fx = floor_int(interp(urow_of(yc), inner_x), max_px)
        rows.append(window_lerp(mxi, fx, source(yb, mxi), source(yb, mxi + 1), max_px))
    acc = window_lerp(myi, fy, rows[0], rows[1], max_px)
    sy = (ys + t[:, 1, None, None]) + ry
    sx = (xs + t[:, 0, None, None]) + rx
    inb = (sy >= 0.0) & (sy <= H - 1.0) & (sx >= 0.0) & (sx <= W - 1.0)
    keep = inb & exact[:, None, None]
    return torch.where(keep, acc, torch.zeros_like(acc)), exact


# -- the gather warps (ops/warp.py, ops/piecewise.upsample_field) -------------


def _grid(shape, device):
    H, W = shape
    ys = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    return xs.expand(H, W), ys.expand(H, W)


def bilinear_sample(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor):
    B, H, W = img.shape
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = torch.clamp(x0, -1, W).to(torch.int64).clamp(0, W - 1)
    y0i = torch.clamp(y0, -1, H).to(torch.int64).clamp(0, H - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    flat = img.reshape(B, -1)

    def tap(yi, xi):
        return torch.gather(flat, 1, (yi * W + xi).reshape(B, -1)).reshape(B, H, W)

    out = (
        tap(y0i, x0i) * (1 - fx) * (1 - fy)
        + tap(y0i, x1i) * fx * (1 - fy)
        + tap(y1i, x0i) * (1 - fx) * fy
        + tap(y1i, x1i) * fx * fy
    )
    inb = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    return out * inb


def warp_gather(frames: torch.Tensor, transforms: torch.Tensor) -> torch.Tensor:
    """corrected(p) = frame(M p), 0 where the sample leaves the frame."""
    xs, ys = _grid(frames.shape[1:], transforms.device)

    def m(i, j):
        return transforms[:, i, j, None, None]

    w = m(2, 0) * xs + m(2, 1) * ys + m(2, 2)
    w = torch.where(w.abs() < 1e-8, torch.full_like(w, 1e-8), w)
    sx = (m(0, 0) * xs + m(0, 1) * ys + m(0, 2)) / w
    sy = (m(1, 0) * xs + m(1, 1) * ys + m(1, 2)) / w
    return bilinear_sample(frames, sx, sy)


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


def warp_flow(frames: torch.Tensor, fields: torch.Tensor) -> torch.Tensor:
    """corrected(p) = frame(p + u(p)), u the upsampled (B, gh, gw, 2) field."""
    flows = upsample_field(fields, tuple(frames.shape[1:]))
    xs, ys = _grid(frames.shape[1:], frames.device)
    return bilinear_sample(frames, xs + flows[..., 0], ys + flows[..., 1])
