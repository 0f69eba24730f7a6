"""K7: single-interpolation affine/projective warp, and its plain version.

Counterpart of `kcmc_tpu/ops/pallas_warp_field.py::
warp_batch_matrix_pallas` (one kernel for every frame size: the TPU's
row strips are not part of the function). `warp_batch_matrix(frames,
transforms, max_px)` corrects (B, H, W) float32 frames through (B, 3, 3)
ref -> frame maps and returns (corrected, ok):

* the per-frame prologue (`matrix_scalars`, the TPU wrapper's `prep`):
  M normalized by M[2, 2], the centre shift (tcx, tcy) rounded half to
  even, `exact` = both within +-PAD = 128, `okm` = |M[2, 2]| > 1e-6;
* output pixel (x, y): its residual (ux, uy) = s(x, y) - (x, y) - tc
  splits into the row pair y + floor(uy) + {0, 1} of the canvas. Each
  canvas row's x-phase is taken at its consumer row (two fixed-point
  iterations), and the row is the two-tap x-lerp of the edge-clamped
  source at the integer shift (tcx, tcy). The y-lerp combines the two
  rows. A tap counts only inside the TPU kernel's window of masked
  views (floor in [-max_px, max_px + 1] for the 1 - f tap, [-max_px - 1,
  max_px] for the f tap), so pixels whose residual leaves it agree too;
* pixels whose source leaves the frame are 0; a frame is zeroed and
  flagged unless okm, exact and its largest in-frame residual is at most
  max_px - 0.5.

Every value is computed per output pixel, with no canvas in memory. The
plain version follows the kernel's float32 operations and order; kernel
on CUDA tensors, plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.ops.warp_field import center_shift, floor_int, normalize, smap
from kcmc_tpu_torch.utils.device import kernel_route, require_tensor

PAD = 128  # max |centre shift| handled exactly, pixels


def matrix_scalars(transforms: torch.Tensor, shape):
    """The TPU wrapper's per-frame prologue (pallas_warp_field.py:462):
    (m normalized (B, 3, 3), tcx, tcy, exact, okm), (B,) each."""
    m, okm = normalize(transforms)
    tcx, tcy = center_shift(m, shape)
    exact = (tcy >= -PAD) & (tcy <= PAD) & (tcx >= -PAD) & (tcx <= PAD)
    return m, tcx, tcy, exact, okm


def window_lerp(i: torch.Tensor, f: torch.Tensor, v0, v1, max_px: int) -> torch.Tensor:
    """The masked-view sum of the TPU kernels: 0 + (1 - f) v0 + f v1,
    the (1 - f) tap only for i in [-max_px, max_px + 1], the f tap only
    for i in [-max_px - 1, max_px] (csrc/warp_taps.cuh)."""
    zero = torch.zeros_like(f)
    a = torch.where((i >= -max_px) & (i <= max_px + 1), (1.0 - f) * v0, zero)
    return a + torch.where((i >= -max_px - 1) & (i <= max_px), f * v1, zero)


def warp_batch_matrix_plain(frames: torch.Tensor, transforms: torch.Tensor, max_px: int):
    """Plain PyTorch version of K7: (corrected, ok)."""
    B, H, W = frames.shape
    dev = frames.device
    m, tcx, tcy, exact, okm = matrix_scalars(transforms, (H, W))
    tcx3, tcy3 = tcx[:, None, None], tcy[:, None, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    # integer centre shift for indexing (its value only matters when exact)
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
        yb = ys.to(torch.int64) + myi + j  # canvas row = its frame row
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


def _lib():
    lib = cuda_build.load("warp_matrix")
    fn, words = lib.kcmc_warp_batch_matrix, lib.kcmc_warp_batch_matrix_scratch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        words.argtypes = [i, i, i]
        words.restype = ctypes.c_longlong
    return fn, words


def warp_batch_matrix(frames: torch.Tensor, transforms: torch.Tensor, max_px: int = 16):
    """(corrected (B, H, W) float32, ok (B,) bool) for (B, 3, 3)
    affine or projective ref -> frame maps."""
    require_tensor(frames, "frames", torch.float32, 3)
    require_tensor(transforms, "transforms", torch.float32, 3)
    if transforms.shape != (frames.shape[0], 3, 3):
        raise ValueError(f"transforms must be (B, 3, 3), got {tuple(transforms.shape)}")
    if not 0 <= max_px <= 1024:
        raise ValueError(f"max_px must be in [0, 1024], got {max_px}")
    if not kernel_route(frames, transforms):
        return warp_batch_matrix_plain(frames, transforms, max_px)
    B, H, W = frames.shape
    out = torch.empty_like(frames)
    ok = torch.empty((B,), dtype=torch.bool, device=frames.device)
    fn, words = _lib()
    # per frame: its flags and one residual maximum per kernel block
    scratch = torch.empty((words(B, H, W),), dtype=torch.int32, device=frames.device)
    rc = fn(
        frames.data_ptr(), transforms.data_ptr(), out.data_ptr(), ok.data_ptr(),
        scratch.data_ptr(), B, H, W, max_px, torch.cuda.current_stream().cuda_stream,
    )
    cuda_build.check(rc, "warp_batch_matrix")
    cuda_build.LAUNCHES["warp_batch_matrix"] += 1
    return out, ok
