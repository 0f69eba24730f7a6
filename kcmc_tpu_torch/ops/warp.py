"""Frame warping by inverse-map bilinear resampling (gather form).

Counterpart of `kcmc_tpu/ops/warp.py`: corrected(p) = frame(M p), 0
where the sample leaves the frame. This gather warp handles every
transform, so it is the exact oracle of kernel K3 and the route of the
host-side rescue of frames K3 and K7 flag. Functions take batched
tensors: frames (B, H, W), transforms (B, 3, 3). `warp_frame_flow`
warps through dense flows instead (the piecewise model's gather route,
its rescue and K8's accuracy oracle). `warp_volume` is the 3D gather
warp of (B, D, H, W) volumes under (B, 4, 4) maps (the rigid3d rescue
and `warp="jnp"` route). The coverage masks (matrix, flow and volume)
feed the `quality_metrics` diagnostics. `fast_apply_matrix` and
`fast_apply_fields` are `apply_correction`'s batch warps
(warp.py:217-330): on the card the bounded kernels K7 and K8 with an
exact per-frame gather for each frame they flag, on the CPU the gather
(or, with `force_kernel`, the kernels' plain versions).
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


def coverage_mask(shape, transforms: torch.Tensor,
                  valid_hw: torch.Tensor | None = None) -> torch.Tensor:
    """(B, H, W) bool: output pixels whose source sample is in bounds.
    `valid_hw` (a (2,) int tensor) bounds the source check by the
    top-left (h, w) valid extent of a bucket-padded canvas instead of
    the whole canvas (warp.py:92-117): the one source-bounds test of the
    plain coverage, the valid-extent masking of the bucketed batch
    program and the polish's coverage gate."""
    H, W = shape
    sx, sy = _source_coords(shape, transforms)
    if valid_hw is None:
        wmax, hmax = float(W - 1), float(H - 1)
    else:
        vhw = valid_hw.to(device=sx.device, dtype=torch.float32)
        wmax, hmax = vhw[1] - 1.0, vhw[0] - 1.0
    return (sx >= 0) & (sx <= wmax) & (sy >= 0) & (sy <= hmax)


def valid_rect_mask(shape, valid_hw: torch.Tensor) -> torch.Tensor:
    """(H, W) bool: the top-left (h, w) valid extent of a bucket-padded
    canvas (warp.py:120-133), shared by the batch program's sanitize
    statistics and the polish's coverage gate."""
    H, W = shape
    ys = torch.arange(H, dtype=torch.int32, device=valid_hw.device)[:, None]
    xs = torch.arange(W, dtype=torch.int32, device=valid_hw.device)[None, :]
    return (ys < valid_hw[0]) & (xs < valid_hw[1])


def coverage_mask_flow(flows: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool coverage of the dense-flow warp under (B, H, W, 2)
    flows: pixels whose sample p + u(p) is in bounds (warp.py:123)."""
    H, W = flows.shape[1:3]
    xs, ys = _grid((H, W), flows.device)
    sx = xs + flows[..., 0]
    sy = ys + flows[..., 1]
    return (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)


def coverage_mask_3d(shape, transforms: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W) bool coverage of the volume warp under (B, 4, 4)
    maps (warp.py:133)."""
    D, H, W = shape
    sx, sy, sz = source_coords_3d(shape, transforms)
    return ((sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
            & (sz >= 0) & (sz <= D - 1))


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


def _refill(out: torch.Tensor, ok: torch.Tensor, exact) -> torch.Tensor:
    """The bounded warp's output with each flagged frame i replaced by
    exact(i), one frame at a time."""
    bad = torch.nonzero(~ok).flatten().tolist()
    if bad:
        out = out.clone()
        for i in bad:
            out[i] = exact(i)
    return out


def fast_apply_matrix(frames: torch.Tensor, transforms: torch.Tensor,
                      force_kernel: bool = False) -> torch.Tensor:
    """Correct (B, H, W) float32 frames through (B, 3, 3) maps with
    gather-warp semantics (warp.py:217): on the card K7 at max_px = 16,
    then the exact gather for each frame it flags; on the CPU the
    gather, or with `force_kernel` K7's plain version and the same
    fallback."""
    # imported here: cuda_warp_matrix imports warp_field, which imports this module
    from kcmc_tpu_torch.ops import cuda_warp_matrix

    if frames.is_cuda or force_kernel:
        out, ok = cuda_warp_matrix.warp_batch_matrix(frames, transforms, max_px=16)
        return _refill(out, ok, lambda i: warp_frame(frames[i], transforms[i]))
    return warp_batch(frames, transforms)


def fast_apply_fields(frames: torch.Tensor, fields: torch.Tensor,
                      force_kernel: bool = False) -> torch.Tensor:
    """Correct (B, H, W) float32 frames through (B, gh, gw, 2) piecewise
    fields with gather-warp semantics (warp.py:277): on the card K8 at
    max_px = 6 where it takes the grid (`cuda_warp_field.supports`),
    then the exact gather of the upsampled flow for each frame it flags;
    on the CPU (and beyond K8's grid) the gather, or with `force_kernel`
    K8's plain version and the same fallback."""
    # imported here: both import modules that import this one
    from kcmc_tpu_torch.ops import cuda_warp_field
    from kcmc_tpu_torch.ops.piecewise import upsample_field

    shape = tuple(frames.shape[1:])
    if (frames.is_cuda or force_kernel) and cuda_warp_field.supports(fields.shape[1:3], 6):
        out, ok = cuda_warp_field.warp_batch_field(frames, fields, max_px=6)
        return _refill(out, ok, lambda i: warp_frame_flow(
            frames[i:i + 1], upsample_field(fields[i:i + 1], shape))[0])
    return warp_frame_flow(frames, upsample_field(fields, shape))
