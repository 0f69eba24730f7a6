"""K1: the fused detection-fields kernel and its plain PyTorch version.

Counterpart of `kcmc_tpu/ops/pallas_detect.py::response_fields`. For a
(B, H, W) float32 batch it returns (nms_resp, ox, oy[, smooth]): the
Harris response at NMS maxima (-inf elsewhere), the clipped quadratic
subpixel offsets, and optionally the blur the describe stage reads.
Semantics follow pallas_detect.py:23-42 (see csrc/detect.cu).

`detect_response` launches the CUDA kernel for a tensor on the card and
runs `detect_response_plain` for a tensor on the CPU; there is no other
route. The plain version performs the same float32 operations in the
same order as the kernel, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.ops.patterns import WINDOW_SIGMA
from kcmc_tpu_torch.utils.device import kernel_route, require_tensor

HALO = 16  # staged halo of the kernel's tiles; the filters' reach must fit
_SM = (0.25, 0.5, 0.25)  # Sobel smoothing taps (correlation form)
_DF = (0.5, 0.0, -0.5)  # Sobel difference taps (correlation form)


def _reach(nms_size: int, window_sigma: float, smooth_sigma: float | None) -> int:
    """Influence radius of the fused pass (pallas_detect._reach)."""
    blur_r = max(1, int(3.0 * window_sigma + 0.5))
    reach = 2 + blur_r + nms_size // 2 + 1
    if smooth_sigma is not None:
        reach = max(reach, max(1, int(3.0 * smooth_sigma + 0.5)))
    return reach


def gauss_taps(sigma: float) -> tuple[float, ...]:
    """Normalized Gaussian taps computed in float32 numpy, exactly as
    pallas_detect._gauss_taps computes them."""
    r = max(1, int(3.0 * sigma + 0.5))
    xs = np.arange(-r, r + 1, dtype=np.float32)
    g = np.exp(np.float32(-0.5) * (xs / np.float32(sigma)) ** 2)
    return tuple(float(v) for v in (g / g.sum()).astype(np.float32))


def corr1d(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """Zero-padded ("SAME") correlation of a (B, H, W) tensor along dim
    1 (rows) or 2 (columns), accumulated tap by tap in tap order."""
    r = len(taps) // 2
    pad = (0, 0, r, r) if dim == 1 else (r, r)
    xp = F.pad(x, pad)
    n = x.shape[dim]
    acc = None
    for i, w in enumerate(taps):
        term = w * xp.narrow(dim, i, n)
        acc = term if acc is None else acc + term
    return acc


def _check_reach(nms_size, window_sigma, smooth_sigma):
    if smooth_sigma is not None and smooth_sigma <= 0.0:
        raise ValueError(f"smooth_sigma must be positive, got {smooth_sigma}")
    reach = _reach(nms_size, window_sigma, smooth_sigma)
    if reach > HALO:
        raise ValueError(
            f"filter reach {reach} exceeds the detect kernel's halo ({HALO})"
        )


def detect_response_plain(
    frames: torch.Tensor,
    harris_k: float = 0.04,
    nms_size: int = 5,
    window_sigma: float = WINDOW_SIGMA,
    smooth_sigma: float | None = None,
):
    """Plain PyTorch version of K1 (same outputs, same operation order)."""
    _check_reach(nms_size, window_sigma, smooth_sigma)
    f = frames
    g = gauss_taps(window_sigma)
    gx = corr1d(corr1d(f, _SM, 1), _DF, 2)
    gy = corr1d(corr1d(f, _SM, 2), _DF, 1)
    ixx = corr1d(corr1d(gx * gx, g, 1), g, 2)
    ixy = corr1d(corr1d(gx * gy, g, 1), g, 2)
    iyy = corr1d(corr1d(gy * gy, g, 1), g, 2)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    resp = det - harris_k * tr * tr

    lo, hi = -((nms_size - 1) // 2), nms_size // 2
    H, W = resp.shape[1:]
    m = F.pad(resp, (0, 0, -lo, hi), value=-float("inf"))
    rmax = m.narrow(1, -lo, H)
    for d in range(lo, hi + 1):
        if d:
            rmax = torch.maximum(rmax, m.narrow(1, d - lo, H))
    m = F.pad(rmax, (-lo, hi), value=-float("inf"))
    cmax = rmax
    for d in range(lo, hi + 1):
        if d:
            cmax = torch.maximum(cmax, m.narrow(2, d - lo, W))
    nms = torch.where(resp >= cmax, resp, torch.full_like(resp, -float("inf")))

    rp = F.pad(resp, (1, 1, 1, 1))
    right, left = rp[:, 1:-1, 2:], rp[:, 1:-1, :-2]
    down, up = rp[:, 2:, 1:-1], rp[:, :-2, 1:-1]
    zero = torch.zeros_like(resp)

    def fit(p, q):
        d1 = 0.5 * (p - q)
        d2 = p - 2.0 * resp + q
        o = torch.where(d2.abs() > 1e-8, -d1 / d2, zero)
        return torch.clamp(o, -0.5, 0.5)

    out = (nms, fit(right, left), fit(down, up))
    if smooth_sigma is not None:
        s = gauss_taps(smooth_sigma)
        out = out + (corr1d(corr1d(f, s, 1), s, 2),)
    return out


def _lib():
    lib = cuda_build.load("detect")
    fn = lib.kcmc_detect_response
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [
            p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            p, ctypes.c_int, p, ctypes.c_int, ctypes.c_int, ctypes.c_float, p,
        ]
        fn.restype = ctypes.c_int
    return fn


def detect_response(
    frames: torch.Tensor,
    harris_k: float = 0.04,
    nms_size: int = 5,
    window_sigma: float = WINDOW_SIGMA,
    smooth_sigma: float | None = None,
):
    """Fused dense detection fields for a (B, H, W) float32 batch:
    (nms_resp, ox, oy) plus the smooth_sigma blur when asked. The kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    require_tensor(frames, "frames", torch.float32, 3)
    if not kernel_route(frames):
        return detect_response_plain(
            frames, harris_k, nms_size, window_sigma, smooth_sigma
        )
    _check_reach(nms_size, window_sigma, smooth_sigma)
    B, H, W = frames.shape
    outs = [torch.empty_like(frames) for _ in range(3 if smooth_sigma is None else 4)]
    g = gauss_taps(window_sigma)
    s = gauss_taps(smooth_sigma) if smooth_sigma is not None else (0.0,)
    g_arr = (ctypes.c_float * len(g))(*g)
    s_arr = (ctypes.c_float * len(s))(*s)
    rc = _lib()(
        frames.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
        outs[2].data_ptr(),
        outs[3].data_ptr() if smooth_sigma is not None else None,
        B, H, W, ctypes.cast(g_arr, ctypes.c_void_p), len(g) // 2,
        ctypes.cast(s_arr, ctypes.c_void_p),
        len(s) // 2 if smooth_sigma is not None else 0,
        nms_size, float(harris_k), torch.cuda.current_stream().cuda_stream,
    )
    cuda_build.check(rc, "detect_response")
    cuda_build.LAUNCHES["detect_response"] += 1
    return tuple(outs)
