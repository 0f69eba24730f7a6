"""K8: piecewise warp through cell-centred displacement fields, and its
plain version.

Counterpart of `kcmc_tpu/ops/pallas_warp_field.py::warp_batch_field`
(one kernel for every frame size: the TPU's row strips are not part of
the function). `warp_batch_field(frames, fields, max_px)` corrects (B, H,
W) float32 frames through (B, gh, gw, 2) fields (corrected(p) =
frame(p + u(p)), u the cell-centred bilinear upsample of the field,
(ux, uy) last) and returns (corrected, ok):

* the per-frame prologue (`field_scalars`, pallas_warp_field.py:226):
  t = the field's mean over its cells (a row-major sequential float32
  sum) rounded half to even, exact = |t| <= PAD = 128 and every
  |field - t| <= max_px - 0.5;
* output pixel (x, y): the residual field (field - t) upsampled with the
  TPU kernel's hat weights (column interpolation, then rows in cell
  order) at the output pixel gives the y-phase; each of the two canvas
  rows y + floor(ry) + {0, 1} takes its x-phase at its consumer row (two
  fixed-point iterations) and is the two-tap x-lerp of the edge-clamped
  source shifted by t; the y-lerp combines them. Taps count only inside
  the TPU kernel's window, as in K7 (`cuda_warp_matrix.window_lerp`);
* pixels whose true sample (x + tx + rx, y + ty + ry) leaves the frame
  are 0, and frames that are not exact are zeroed and flagged.

Matches the gather warp `warp.warp_frame_flow(upsample_field(field))` to
O(|grad u|^2). The plain version follows the kernel's float32 operations
and order; kernel on CUDA tensors, plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.ops.cuda_warp_matrix import PAD, window_lerp
from kcmc_tpu_torch.ops.warp_field import floor_int
from kcmc_tpu_torch.utils.device import kernel_route, require_tensor


def field_scalars(fields: torch.Tensor, max_px: int):
    """The TPU wrapper's per-frame prologue: (t (B, 2) = (tx, ty), exact
    (B,) bool). The mean's sum runs over the cells in row-major order,
    as in the kernel."""
    B, gh, gw, _ = fields.shape
    s = torch.zeros((B, 2), dtype=torch.float32, device=fields.device)
    for c in range(gh):
        for d in range(gw):
            s = s + fields[:, c, d]
    t = torch.round(s / float(gh * gw))
    maxr = (fields - t[:, None, None, :]).abs().amax(dim=(1, 2, 3))
    exact = (t.abs() <= PAD).all(dim=1) & (maxr <= max_px - 0.5)
    return t, exact


def _hat(u: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - (u - c.to(torch.float32)).abs(), min=0.0)


def warp_batch_field_plain(frames: torch.Tensor, fields: torch.Tensor, max_px: int):
    """Plain PyTorch version of K8: (corrected, ok)."""
    B, H, W = frames.shape
    _, gh, gw, _ = fields.shape
    dev = frames.device
    t, exact = field_scalars(fields, max_px)
    res = fields - t[:, None, None, :]  # (B, gh, gw, 2)
    rh, rw = float(np.float32(gh / H)), float(np.float32(gw / W))
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]

    # column interpolation: each column's two live cells and hat weights
    ucol = torch.clamp((xs + 0.5) * rw - 0.5, 0.0, gw - 1.0)[0, 0]  # (W,)
    d0 = torch.floor(ucol).to(torch.int64)
    d1 = torch.clamp(d0 + 1, max=gw - 1)
    h0, h1 = _hat(ucol, d0), _hat(ucol, d0 + 1)
    has1 = d0 + 1 < gw

    def inner(ch):  # (B, gh, W) column-interpolated residual
        r = res[..., ch]
        a = r[:, :, d0] * h0
        return torch.where(has1, a + r[:, :, d1] * h1, a)

    inner_x, inner_y = inner(0), inner(1)

    def urow_of(y):
        return torch.clamp((y + 0.5) * rh - 0.5, 0.0, gh - 1.0)

    def interp(u, inn):  # u (B or 1, H, W) -> (B, H, W)
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
        yb = ys.to(torch.int64) + myi + j  # canvas row = its frame row
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


def _lib():
    fn = cuda_build.load("warp_field").kcmc_warp_batch_field
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        f = ctypes.c_float
        fn.argtypes = [p, p, p, p, i, i, i, i, i, f, f, i, p]
        fn.restype = ctypes.c_int
    return fn


MAX_CELLS = 6144  # csrc/warp_field.cu's MAX_CELLS
MAX_PX = 1024


def supports(grid, max_px: int) -> bool:
    """Whether K8 takes a (gh, gw) field grid at this residual bound:
    at most 6144 cells (the prologue's staged cells) and 0 <= max_px <=
    1024. The backend takes the flow route (`warp_field.warp_batch_flow`
    of the upsampled field) beyond, as the reference takes it where its
    Pallas kernel does not fit."""
    gh, gw = grid
    return gh * gw <= MAX_CELLS and 0 <= max_px <= MAX_PX


def warp_batch_field(frames: torch.Tensor, fields: torch.Tensor, max_px: int = 6):
    """(corrected (B, H, W) float32, ok (B,) bool) for (B, gh, gw, 2)
    cell-centred displacement fields; raises beyond `supports`."""
    require_tensor(frames, "frames", torch.float32, 3)
    require_tensor(fields, "fields", torch.float32, 4)
    B, H, W = frames.shape
    if fields.shape[0] != B or fields.shape[3] != 2:
        raise ValueError(f"fields must be (B, gh, gw, 2) for B={B}, got {tuple(fields.shape)}")
    gh, gw = fields.shape[1:3]
    if gh * gw > MAX_CELLS:
        raise ValueError(f"field grid {gh}x{gw} exceeds {MAX_CELLS} cells")
    if not 0 <= max_px <= MAX_PX:
        raise ValueError(f"max_px must be in [0, {MAX_PX}], got {max_px}")
    if not kernel_route(frames, fields):
        return warp_batch_field_plain(frames, fields, max_px)
    out = torch.empty_like(frames)
    ok = torch.empty((B,), dtype=torch.bool, device=frames.device)
    rc = _lib()(
        frames.data_ptr(), fields.data_ptr(), out.data_ptr(), ok.data_ptr(),
        B, H, W, gh, gw, float(np.float32(gh / H)),
        float(np.float32(gw / W)), max_px, torch.cuda.current_stream().cuda_stream,
    )
    cuda_build.check(rc, "warp_batch_field")
    cuda_build.LAUNCHES["warp_batch_field"] += 1
    return out, ok
