"""K2: per-keypoint patch cut + bilinear blend, and its plain version.

Counterpart of `kcmc_tpu/ops/pallas_patch.py::extract_blended` (and of
its banded and slab layouts, which the kernel needs no separate route
for). `extract_blended(padded, xy, P)` takes (B, Hp, Wp) bf16 frames
edge-padded by (P - 2) // 2 + 1 and (B, K, 2) float32 keypoints and
returns (B, K, P-1, P-1) bf16 blended patches: the window at
floor(xy) + 1 blended at the fractional part, rows first, then columns,
in float32 with the two fused multiply-adds the reference's CPU
evaluation contracts the blend into (csrc/patch.cu). Reads past the
padded frame clamp to its edge. Kernel on a CUDA tensor, plain version
on a CPU tensor; the two are bit-identical.
"""

from __future__ import annotations

import ctypes

import torch

from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.utils.device import kernel_route, require_tensor


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fma(a, b, c), rounded once: the float64 product of two
    float32 values is exact, so only the sum rounds before the float32
    cast (a double rounding would need the float64 sum to land exactly
    on a float32 midpoint)."""
    return (a.double() * b.double() + c.double()).float()


def _origins(xy: torch.Tensor):
    fl = torch.floor(xy)
    frac = xy - fl
    org = fl.to(torch.int32) + 1
    return org[..., 0], org[..., 1], frac[..., 0], frac[..., 1]


def extract_blended_plain(padded: torch.Tensor, xy: torch.Tensor, P: int):
    """Plain PyTorch version of K2 (same float32 operations and order)."""
    B, Hp, Wp = padded.shape
    ox, oy, fx, fy = _origins(xy)
    ar = torch.arange(P, device=padded.device, dtype=torch.int32)
    rows = torch.clamp(oy[..., None] + ar, 0, Hp - 1).long()  # (B, K, P)
    cols = torch.clamp(ox[..., None] + ar, 0, Wp - 1).long()
    bidx = torch.arange(B, device=padded.device)[:, None, None, None]
    patch = padded[bidx, rows[..., :, None], cols[..., None, :]].float()
    fx = fx[..., None, None]
    fy = fy[..., None, None]
    yb = _fma(fy, patch[..., 1:, :], (1.0 - fy) * patch[..., :-1, :])
    xb = _fma(1.0 - fx, yb[..., :-1], fx * yb[..., 1:])
    return xb.to(torch.bfloat16)


def _lib():
    fn = cuda_build.load("patch").kcmc_extract_blended
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def extract_blended(padded: torch.Tensor, xy: torch.Tensor, P: int):
    """Keypoint-first blended (B, K, P-1, P-1) bf16 patches."""
    require_tensor(padded, "padded", torch.bfloat16, 3)
    require_tensor(xy, "xy", torch.float32, 3)
    if xy.shape[0] != padded.shape[0] or xy.shape[2] != 2:
        raise ValueError(
            f"xy must be (B, K, 2) for B={padded.shape[0]}, got {tuple(xy.shape)}"
        )
    if not 2 <= P <= 64:
        raise ValueError(f"patch side P must be in [2, 64], got {P}")
    if not kernel_route(padded, xy):
        return extract_blended_plain(padded, xy, P)
    B, Hp, Wp = padded.shape
    K = xy.shape[1]
    out = torch.empty((B, K, P - 1, P - 1), dtype=torch.bfloat16, device=padded.device)
    rc = _lib()(
        padded.data_ptr(), xy.data_ptr(), out.data_ptr(), B, K, Hp, Wp, P,
        torch.cuda.current_stream().cuda_stream,
    )
    cuda_build.check(rc, "extract_blended")
    cuda_build.LAUNCHES["extract_blended"] += 1
    return out
