"""K2 and K6: per-keypoint patch cut + bilinear blend (+ ORB moments);
K11: the raw patch cut at integer origins; and their plain versions.

Counterpart of `kcmc_tpu/ops/pallas_patch.py::extract_blended` (and of
its banded and slab layouts, which the kernel needs no separate route
for). `extract_blended(padded, xy, P)` takes (B, Hp, Wp) bf16 frames
edge-padded by (P - 2) // 2 + 1 and (B, K, 2) float32 keypoints and
returns (B, K, P-1, P-1) bf16 blended patches: the window at
floor(xy) + 1 blended at the fractional part, rows first, then columns,
in float32 with the two fused multiply-adds the reference's CPU
evaluation contracts the blend into (csrc/patch.cu). Reads past the
padded frame clamp to its edge. With `with_moments` (K6, the small-K
oriented route) it also returns the ORB moments (m10, m01), (B, K)
float32 each: the radius-7 disc of the RAW window centred at window
index (P - 2) // 2 + (frac >= 0.5), in float64 (every product is
exact): each disc column summed in row order, the column sums added by a
fixed pairwise tree, rounded once (`_moments_plain`). Kernel on a CUDA
tensor, plain version on a CPU tensor; the two are bit-identical.

Counterpart of `kcmc_tpu/ops/pallas_patch.py::extract_patches` (K11,
csrc/patches.cu): `extract_patches(padded, oy, ox, P)` cuts (B, K, P, P)
float32 windows of (B, Hp, Wp) float32 frames at (B, K) int32 origins,
clamped to [0, Hp - P] x [0, Wp - P]. The unquantized describe route
(`match_precision="float32"`, ops/describe.py) cuts its raw windows with
it, where the JAX package slices them with `lax.dynamic_slice`
(describe.py:95-118).
"""

from __future__ import annotations

import ctypes

import torch

from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.ops.patterns import MOMENT_RADIUS
from kcmc_tpu_torch.utils.device import kernel_route, require_tensor

MOMENT_SLOTS = 16  # K6's disc columns (2 * MOMENT_RADIUS + 1), padded to a power of two


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


def _moments_plain(patch: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor):
    """(m10, m01) of raw (B, K, P, P) windows in K6's order: each column
    dx of the disc summed in float64 in row order into slot dx + r of
    MOMENT_SLOTS (the slots no column fills hold +0.0), the slots added
    pairwise, (i, i + h) for h = 8, 4, 2, 1, and rounded once to float32."""
    P = patch.shape[-1]
    mr = MOMENT_RADIUS
    c = (P - 2) // 2
    cy = c + (fy >= 0.5).long()
    cx = c + (fx >= 0.5).long()
    flat = patch.reshape(patch.shape[:-2] + (P * P,))
    slots = torch.zeros(fx.shape + (2, MOMENT_SLOTS), dtype=torch.float64,
                        device=patch.device)
    for dx in range(-mr, mr + 1):
        for dy in range(-mr, mr + 1):
            if dx * dx + dy * dy > mr * mr:
                continue
            idx = ((cy + dy) * P + cx + dx)[..., None]
            v = torch.gather(flat, -1, idx)[..., 0].double()
            slots[..., 0, dx + mr] += v * float(dx)
            slots[..., 1, dx + mr] += v * float(dy)
    h = MOMENT_SLOTS // 2
    while h:
        slots = slots[..., :h] + slots[..., h:2 * h]
        h //= 2
    m = slots[..., 0].float()
    return m[..., 0], m[..., 1]


def extract_blended_plain(padded: torch.Tensor, xy: torch.Tensor, P: int,
                          with_moments: bool = False):
    """Plain PyTorch version of K2 and K6 (same float32 operations and
    order; K6's moments as in `_moments_plain`)."""
    B, Hp, Wp = padded.shape
    ox, oy, fx, fy = _origins(xy)
    ar = torch.arange(P, device=padded.device, dtype=torch.int32)
    rows = torch.clamp(oy[..., None] + ar, 0, Hp - 1).long()  # (B, K, P)
    cols = torch.clamp(ox[..., None] + ar, 0, Wp - 1).long()
    bidx = torch.arange(B, device=padded.device)[:, None, None, None]
    patch = padded[bidx, rows[..., :, None], cols[..., None, :]].float()
    fxb = fx[..., None, None]
    fyb = fy[..., None, None]
    yb = _fma(fyb, patch[..., 1:, :], (1.0 - fyb) * patch[..., :-1, :])
    xb = _fma(1.0 - fxb, yb[..., :-1], fxb * yb[..., 1:])
    pb = xb.to(torch.bfloat16)
    if not with_moments:
        return pb
    return (pb, *_moments_plain(patch, fx, fy))


def _lib():
    fn = cuda_build.load("patch").kcmc_extract_blended
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def extract_blended(padded: torch.Tensor, xy: torch.Tensor, P: int,
                    with_moments: bool = False):
    """Keypoint-first blended (B, K, P-1, P-1) bf16 patches; with
    `with_moments` (K6), (patches, m10 (B, K), m01 (B, K))."""
    require_tensor(padded, "padded", torch.bfloat16, 3)
    require_tensor(xy, "xy", torch.float32, 3)
    if xy.shape[0] != padded.shape[0] or xy.shape[2] != 2:
        raise ValueError(
            f"xy must be (B, K, 2) for B={padded.shape[0]}, got {tuple(xy.shape)}"
        )
    if not 2 <= P <= 64:
        raise ValueError(f"patch side P must be in [2, 64], got {P}")
    if with_moments and P < 2 * MOMENT_RADIUS + 3:
        raise ValueError(f"moments need P >= {2 * MOMENT_RADIUS + 3}, got {P}")
    if not kernel_route(padded, xy):
        return extract_blended_plain(padded, xy, P, with_moments)
    B, Hp, Wp = padded.shape
    K = xy.shape[1]
    out = torch.empty((B, K, P - 1, P - 1), dtype=torch.bfloat16, device=padded.device)
    if with_moments:
        m10 = torch.empty((B, K), dtype=torch.float32, device=padded.device)
        m01 = torch.empty_like(m10)
        mp = (m10.data_ptr(), m01.data_ptr())
    else:
        mp = (None, None)
    name = "extract_blended_moments" if with_moments else "extract_blended"
    rc = _lib()(
        padded.data_ptr(), xy.data_ptr(), out.data_ptr(), *mp, B, K, Hp, Wp, P,
        torch.cuda.current_stream().cuda_stream,
    )
    cuda_build.check(rc, name)
    cuda_build.LAUNCHES[name] += 1
    return (out, m10, m01) if with_moments else out


def extract_patches_plain(padded: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                          P: int) -> torch.Tensor:
    """Plain PyTorch version of K11: an index gather of the same pixels."""
    B, Hp, Wp = padded.shape
    y0 = torch.clamp(oy.long(), 0, Hp - P)
    x0 = torch.clamp(ox.long(), 0, Wp - P)
    ar = torch.arange(P, device=padded.device)
    rows = (y0[..., None] + ar)[..., :, None]  # (B, K, P, 1)
    cols = (x0[..., None] + ar)[..., None, :]  # (B, K, 1, P)
    bidx = torch.arange(B, device=padded.device)[:, None, None, None]
    return padded[bidx, rows, cols]


def _patches_lib():
    fn = cuda_build.load("patches").kcmc_extract_patches
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def extract_patches(padded: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                    P: int) -> torch.Tensor:
    """Raw (B, K, P, P) float32 patches of (B, Hp, Wp) float32 frames at
    (B, K) int32 origins: patches[b, k, i, j] = padded[b, oy + i, ox + j]."""
    require_tensor(padded, "padded", torch.float32, 3)
    require_tensor(oy, "oy", torch.int32, 2)
    require_tensor(ox, "ox", torch.int32, 2)
    B, Hp, Wp = padded.shape
    if oy.shape != ox.shape or oy.shape[0] != B:
        raise ValueError(
            f"oy and ox must both be (B, K) for B={B}, got {tuple(oy.shape)}, "
            f"{tuple(ox.shape)}"
        )
    if not 1 <= P <= min(Hp, Wp):
        raise ValueError(f"patch side P must be in [1, {min(Hp, Wp)}], got {P}")
    if not kernel_route(padded, oy, ox):
        return extract_patches_plain(padded, oy, ox, P)
    K = oy.shape[1]
    out = torch.empty((B, K, P, P), dtype=torch.float32, device=padded.device)
    rc = _patches_lib()(
        padded.data_ptr(), oy.data_ptr(), ox.data_ptr(), out.data_ptr(),
        B, K, Hp, Wp, P, torch.cuda.current_stream().cuda_stream,
    )
    cuda_build.check(rc, "extract_patches")
    cuda_build.LAUNCHES["extract_patches"] += 1
    return out
