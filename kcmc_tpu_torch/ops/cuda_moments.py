"""K4: ORB disc moment maps, and their plain version.

Counterpart of `kcmc_tpu/ops/pallas_patch.py::moment_maps`.
`moment_maps(padded)` takes a (B, Hp, Wp) bf16 batch (the describe
stage's mean-removed, edge-padded frames) and returns the (m10, m01)
maps, (B, Hp - 14, Wp - 14) float32 each: map[i, j] is the moment of the
radius-7 disc centred on padded[i + 7, j + 7] (the VALID correlation
with the disc's dx- and dy-weight kernels). Both versions sum in the
TPU kernel's order (band rows of equal half-width; csrc/moments.cu), with
m01's multiply-adds fused as the reference's CPU evaluation fuses them,
so kernel, plain version and interpret mode agree bit for bit. Kernel on
a CUDA tensor, plain version on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.ops.patterns import MOMENT_RADIUS, MOMENTS
from kcmc_tpu_torch.utils.device import kernel_route, require_tensor


def band_structure() -> list[tuple[int, int]]:
    """The disc's rows as (half-width w, dy) pairs in summation order:
    ascending w, ascending dy within a width (the TPU kernel's
    `_moment_band_structure`; csrc/moments.cu's BANDS table)."""
    mr = MOMENT_RADIUS
    pairs = []
    for i in range(2 * mr + 1):
        inside = MOMENTS[i, :, 2] > 0
        if inside.any():
            pairs.append((int(abs(MOMENTS[i, inside, 0]).max()), i - mr))
    return sorted(pairs, key=lambda p: p[0])  # stable: dy order kept


def moment_maps_plain(padded: torch.Tensor):
    """Plain PyTorch version of K4 (same order; m01's multiply-adds as
    float32 FMAs, emulated in float64: the product of a float32 and a
    small integer is exact there, so only the sum rounds)."""
    mr = MOMENT_RADIUS
    B, Hp, Wp = padded.shape
    Hm, Wm = Hp - 2 * mr, Wp - 2 * mr
    p = padded.float()
    m10 = torch.zeros((B, Hm, Wm), dtype=torch.float32, device=p.device)
    m01 = torch.zeros_like(m10)
    by_w: dict[int, list[int]] = {}
    for w, dy in band_structure():
        by_w.setdefault(w, []).append(dy)
    for w, dys in by_w.items():
        hx = torch.zeros((B, Hp, Wm), dtype=torch.float32, device=p.device)
        sx = torch.zeros_like(hx)
        for dx in range(-w, w + 1):
            v = p[:, :, mr + dx: mr + dx + Wm]
            sx = sx + v
            if dx:
                hx = hx + float(dx) * v
        for dy in dys:
            m10 = m10 + hx[:, mr + dy: mr + dy + Hm]
            if dy:
                s = sx[:, mr + dy: mr + dy + Hm].double()
                m01 = (m01.double() + float(dy) * s).float()
    return m10, m01


def _lib():
    fn = cuda_build.load("moments").kcmc_moment_maps
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def moment_maps(padded: torch.Tensor):
    """(m10, m01) disc-moment maps of a (B, Hp, Wp) bf16 batch."""
    require_tensor(padded, "padded", torch.bfloat16, 3)
    B, Hp, Wp = padded.shape
    if min(Hp, Wp) <= 2 * MOMENT_RADIUS:
        raise ValueError(f"padded frames must exceed 14 px per side, got {(Hp, Wp)}")
    if not kernel_route(padded):
        return moment_maps_plain(padded)
    shape = (B, Hp - 2 * MOMENT_RADIUS, Wp - 2 * MOMENT_RADIUS)
    m10 = torch.empty(shape, dtype=torch.float32, device=padded.device)
    m01 = torch.empty_like(m10)
    rc = _lib()(
        padded.data_ptr(), m10.data_ptr(), m01.data_ptr(), B, Hp, Wp,
        torch.cuda.current_stream().cuda_stream,
    )
    cuda_build.check(rc, "moment_maps")
    cuda_build.LAUNCHES["moment_maps"] += 1
    return m10, m01
