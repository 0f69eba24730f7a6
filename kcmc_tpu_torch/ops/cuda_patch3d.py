"""K10: per-keypoint trilinear 3D patches, and the plain version.

Counterpart of `kcmc_tpu/ops/pallas_patch.py::extract_blended_3d`.
`extract_blended_3d(padded, xyz, Pz, Pxy)` takes (B, Dp, Hp, Wp) float32
volumes edge-padded by (Pz/2, Pxy/2, Pxy/2) (the describe3d convention)
and (B, K, 3) float32 (x, y, z) keypoints, and returns the (B, K, Pz-1,
Pxy-1, Pxy-1) float32 trilinear resample of each keypoint's slab at
origin floor(xyz) + 1: a y-lerp, an x-lerp and a z-lerp, each one fused
multiply-add as the reference's CPU evaluation contracts them
(csrc/patch3d.cu). Reads past the padded volume clamp to its edge.
Kernel on CUDA tensors, plain version on CPU tensors; the two, and
interpret mode, are bit-identical.
"""

from __future__ import annotations

import ctypes

import torch

from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.ops.cuda_patch import _fma
from kcmc_tpu_torch.utils.device import kernel_route, require_tensor


def extract_blended_3d_plain(padded: torch.Tensor, xyz: torch.Tensor, Pz: int, Pxy: int):
    """Plain PyTorch version of K10 (same float32 operations, FMAs
    emulated in float64 as `cuda_patch._fma` does)."""
    B, Dp, Hp, Wp = padded.shape
    dev = padded.device
    fl = torch.floor(xyz)
    frac = xyz - fl
    org = fl.to(torch.int32) + 1  # (B, K, 3) x, y, z

    def index(axis, n, size):
        ar = torch.arange(n, device=dev, dtype=torch.int32)
        return torch.clamp(org[..., axis, None] + ar, 0, size - 1).long()

    zi, yi, xi = index(2, Pz, Dp), index(1, Pxy, Hp), index(0, Pxy, Wp)
    bidx = torch.arange(B, device=dev)[:, None, None, None, None]
    slab = padded[bidx, zi[..., :, None, None], yi[..., None, :, None], xi[..., None, None, :]]
    fx, fy, fz = (frac[..., i, None, None, None] for i in range(3))
    yb = _fma(fy, slab[..., 1:, :], (1.0 - fy) * slab[..., :-1, :])
    xb = _fma(1.0 - fx, yb[..., :-1], fx * yb[..., 1:])
    return _fma(1.0 - fz, xb[:, :, :-1], fz * xb[:, :, 1:])


def _lib():
    fn = cuda_build.load("patch3d").kcmc_extract_blended_3d
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def extract_blended_3d(padded: torch.Tensor, xyz: torch.Tensor, Pz: int, Pxy: int):
    """Keypoint-first (B, K, Pz-1, Pxy-1, Pxy-1) float32 trilinear patches."""
    require_tensor(padded, "padded", torch.float32, 4)
    require_tensor(xyz, "xyz", torch.float32, 3)
    if xyz.shape[0] != padded.shape[0] or xyz.shape[2] != 3:
        raise ValueError(
            f"xyz must be (B, K, 3) for B={padded.shape[0]}, got {tuple(xyz.shape)}"
        )
    if not (2 <= Pz <= 64 and 2 <= Pxy <= 64):
        raise ValueError(f"patch sides must be in [2, 64], got Pz={Pz}, Pxy={Pxy}")
    if not kernel_route(padded, xyz):
        return extract_blended_3d_plain(padded, xyz, Pz, Pxy)
    B, Dp, Hp, Wp = padded.shape
    K = xyz.shape[1]
    out = torch.empty((B, K, Pz - 1, Pxy - 1, Pxy - 1), dtype=torch.float32,
                      device=padded.device)
    rc = _lib()(
        padded.data_ptr(), xyz.data_ptr(), out.data_ptr(), B, K, Dp, Hp, Wp, Pz, Pxy,
        torch.cuda.current_stream().cuda_stream,
    )
    cuda_build.check(rc, "extract_blended_3d")
    cuda_build.LAUNCHES["extract_blended_3d"] += 1
    return out
