"""K3: gather-free translation warp, its prologue and plain version.

Counterpart of `kcmc_tpu/ops/pallas_warp.py::warp_batch_translation`
(and of its row-strip variant, which K3 needs no separate route for).
`warp_translation(frames, transforms)` corrects (B, H, W) float32
frames under pure translations and returns (corrected, ok): frames
whose shift leaves the +-PAD window are zeroed and flagged ok=False, for
the caller's exact rescue. The per-frame scalars are the TPU wrapper's
prologue (pallas_warp._shift_scalars): `shift_scalars` in the plain
version, the same arithmetic at the top of the kernel on the card.
Kernel on CUDA tensors, plain version on CPU tensors; bit-identical.
"""

from __future__ import annotations

import ctypes

import torch

from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.utils.device import kernel_route, require_tensor

PAD = 128  # max |shift| handled exactly, pixels


def shift_scalars(transforms: torch.Tensor):
    """Split each frame's shift into window origin + bilinear fraction
    and apply the +-PAD exactness rule. Returns (iscal (B, 2) int32
    [oy, ox] into the PAD-padded frame, fscal (B, 8) float32 [fy, fx,
    ty, tx, exact, 0, 0, 0], exact (B,) float32)."""
    tx = transforms[:, 0, 2]
    ty = transforms[:, 1, 2]
    y0 = torch.floor(ty)
    x0 = torch.floor(tx)
    fy = ty - y0
    fx = tx - x0
    exact = (
        (y0 >= -PAD) & (y0 <= PAD - 1) & (x0 >= -PAD) & (x0 <= PAD - 1)
    ).to(torch.float32)

    def origin(v):
        # clamp in float (NaN -> 0) before the int conversion, which is
        # undefined out of range; the result only matters when exact
        v = torch.nan_to_num(v).clamp(-PAD - 1, PAD)
        return torch.clamp(v.to(torch.int32) + PAD, 0, 2 * PAD - 1)

    iscal = torch.stack([origin(y0), origin(x0)], dim=-1).contiguous()
    z = torch.zeros_like(fy)
    fscal = torch.stack([fy, fx, ty, tx, exact, z, z, z], dim=-1).contiguous()
    return iscal, fscal, exact


def warp_translation_plain(frames: torch.Tensor, transforms: torch.Tensor):
    """Plain PyTorch version of K3 (same float32 operations and order):
    (corrected, ok)."""
    iscal, fscal, exact = shift_scalars(transforms)
    B, H, W = frames.shape
    dev = frames.device
    oy, ox = iscal[:, 0].long(), iscal[:, 1].long()
    fy, fx = fscal[:, 0, None, None], fscal[:, 1, None, None]
    ty, tx = fscal[:, 2, None, None], fscal[:, 3, None, None]
    ok = fscal[:, 4, None, None] > 0.5
    ri = torch.clamp(oy[:, None] + torch.arange(H + 1, device=dev) - PAD, 0, H - 1)
    ci = torch.clamp(ox[:, None] + torch.arange(W + 1, device=dev) - PAD, 0, W - 1)
    bidx = torch.arange(B, device=dev)[:, None, None]
    win = frames[bidx, ri[:, :, None], ci[:, None, :]]  # (B, H+1, W+1)
    w00 = (1.0 - fy) * (1.0 - fx)
    w01 = (1.0 - fy) * fx
    w10 = fy * (1.0 - fx)
    w11 = fy * fx
    blend = (
        w00 * win[:, :-1, :-1]
        + w01 * win[:, :-1, 1:]
        + w10 * win[:, 1:, :-1]
        + w11 * win[:, 1:, 1:]
    )
    rows = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None] + ty
    cols = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :] + tx
    inb = (
        (rows >= 0.0) & (rows <= H - 1.0) & (cols >= 0.0) & (cols <= W - 1.0)
        & ok
    )
    return torch.where(inb, blend, torch.zeros_like(blend)), exact > 0.5


def _lib():
    fn = cuda_build.load("warp").kcmc_warp_translation
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, p]  # frames, mats, out, ok, B, H, W
        fn.restype = ctypes.c_int
    return fn


def warp_translation(frames: torch.Tensor, transforms: torch.Tensor):
    """(corrected (B, H, W) float32, ok (B,) bool) for (B, 3, 3)
    translation matrices [[1, 0, tx], [0, 1, ty], [0, 0, 1]]."""
    require_tensor(frames, "frames", torch.float32, 3)
    require_tensor(transforms, "transforms", torch.float32, 3)
    if transforms.shape != (frames.shape[0], 3, 3):
        raise ValueError(f"transforms must be (B, 3, 3), got {tuple(transforms.shape)}")
    if not kernel_route(frames, transforms):
        return warp_translation_plain(frames, transforms)
    B, H, W = frames.shape
    out = torch.empty_like(frames)
    ok = torch.empty((B,), dtype=torch.bool, device=frames.device)
    rc = _lib()(
        frames.data_ptr(), transforms.data_ptr(), out.data_ptr(), ok.data_ptr(),
        B, H, W, torch.cuda.current_stream().cuda_stream,
    )
    cuda_build.check(rc, "warp_translation")
    cuda_build.LAUNCHES["warp_translation"] += 1
    return out, ok
