"""Frame warping by inverse-map bilinear resampling (gather form).

Counterpart of `kcmc_tpu/ops/warp.py`: corrected(p) = frame(M p), 0
where the sample leaves the frame. This gather warp handles every
transform, so it is the exact oracle of kernel K3 and the route of the
host-side rescue of frames K3 and K7 flag. Functions take batched
tensors: frames (B, H, W), transforms (B, 3, 3). `warp_frame_flow`
warps through dense flows instead (the piecewise model's gather route,
its rescue and K8's accuracy oracle). `warp_volume` is the 3D gather
warp of (B, D, H, W) volumes under (B, 4, 4) maps (the rigid3d rescue
and `warp="jnp"` route).
"""

from __future__ import annotations

import torch


def _grid(shape, device):
    H, W = shape
    ys = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    return xs.expand(H, W), ys.expand(H, W)


def bilinear_sample(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor):
    """Sample (B, H, W) images at float coordinates (B, H, W); edge-
    clamped taps, 0 outside the frame."""
    B, H, W = img.shape
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    # clamp in float first: the int conversion of far-out coordinates
    # is undefined, and the clip below would map them to the edge anyway
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


def _source_coords(shape, M: torch.Tensor):
    """Per-pixel source coordinates (sx, sy), (B, H, W) each, of the
    homogeneous maps M (B, 3, 3)."""
    xs, ys = _grid(shape, M.device)

    def m(i, j):
        return M[:, i, j, None, None]

    w = m(2, 0) * xs + m(2, 1) * ys + m(2, 2)
    w = torch.where(w.abs() < 1e-8, torch.full_like(w, 1e-8), w)
    sx = (m(0, 0) * xs + m(0, 1) * ys + m(0, 2)) / w
    sy = (m(1, 0) * xs + m(1, 1) * ys + m(1, 2)) / w
    return sx, sy


def warp_batch(frames: torch.Tensor, transforms: torch.Tensor) -> torch.Tensor:
    """Correct (B, H, W) frames with (B, 3, 3) ref -> frame maps."""
    sx, sy = _source_coords(frames.shape[1:], transforms)
    return bilinear_sample(frames, sx, sy)


def warp_frame(frame: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Correct one (H, W) frame with a (3, 3) map."""
    return warp_batch(frame[None], M[None])[0]


def warp_batch_with_ok(frames: torch.Tensor, transforms: torch.Tensor):
    """warp_batch plus an all-True (B,) ok flag (the gather warp is
    unbounded), matching the kernel warp's (corrected, ok) interface."""
    return (
        warp_batch(frames, transforms),
        torch.ones(frames.shape[0], dtype=torch.bool, device=frames.device),
    )


def warp_frame_flow(frames: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """Correct (B, H, W) frames with dense (B, H, W, 2) forward
    displacement fields u: corrected(p) = frame(p + u(p))."""
    xs, ys = _grid(frames.shape[1:], frames.device)
    return bilinear_sample(frames, xs + flows[..., 0], ys + flows[..., 1])


def coverage_mask(shape, transforms: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool: output pixels whose source sample is in bounds."""
    H, W = shape
    sx, sy = _source_coords(shape, transforms)
    return (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)


def trilinear_sample(vols: torch.Tensor, sx, sy, sz) -> torch.Tensor:
    """Sample (B, D, H, W) volumes at float (x, y, z) coordinates of
    shape (B, D, H, W) each; edge-clamped taps, 0 outside the volume."""
    B, D, H, W = vols.shape

    def split(v, n):
        f = torch.floor(v)
        # clamp in float first: far-out coordinates map to the edge
        i0 = torch.clamp(f, -1, n).to(torch.int64).clamp(0, n - 1)
        return i0, torch.clamp(i0 + 1, 0, n - 1), v - f

    x0, x1, fx = split(sx, W)
    y0, y1, fy = split(sy, H)
    z0, z1, fz = split(sz, D)
    flat = vols.reshape(B, -1)

    def tap(zi, yi, xi):
        idx = ((zi * H + yi) * W + xi).reshape(B, -1)
        return torch.gather(flat, 1, idx).reshape(B, D, H, W)

    out = (
        tap(z0, y0, x0) * (1 - fx) * (1 - fy) * (1 - fz)
        + tap(z0, y0, x1) * fx * (1 - fy) * (1 - fz)
        + tap(z0, y1, x0) * (1 - fx) * fy * (1 - fz)
        + tap(z0, y1, x1) * fx * fy * (1 - fz)
        + tap(z1, y0, x0) * (1 - fx) * (1 - fy) * fz
        + tap(z1, y0, x1) * fx * (1 - fy) * fz
        + tap(z1, y1, x0) * (1 - fx) * fy * fz
        + tap(z1, y1, x1) * fx * fy * fz
    )
    inb = (
        (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
        & (sz >= 0) & (sz <= D - 1)
    )
    return out * inb


def source_coords_3d(shape, M: torch.Tensor):
    """Per-voxel source coordinates (sx, sy, sz) of (B, 4, 4) maps acting
    on (x, y, z) points, (B, D, H, W) each, in the reference's order."""
    D, H, W = shape
    dev = M.device
    zs = torch.arange(D, dtype=torch.float32, device=dev)[None, :, None, None]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None, :]

    def row(i):
        m = M[:, i, :, None, None, None]
        return m[:, 0] * xs + m[:, 1] * ys + m[:, 2] * zs + m[:, 3]

    return row(0), row(1), row(2)


def warp_volume(vols: torch.Tensor, transforms: torch.Tensor) -> torch.Tensor:
    """Correct (B, D, H, W) volumes with (B, 4, 4) ref -> frame maps."""
    return trilinear_sample(vols, *source_coords_3d(vols.shape[1:], transforms))
