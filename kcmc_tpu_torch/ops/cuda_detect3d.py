"""K9: the 3D structure-tensor / Harris-response kernel and its plain
PyTorch version.

Counterpart of `kcmc_tpu/ops/pallas_detect3d.py::response_fields_3d`.
For a (B, D, H, W) float32 batch `response_fields_3d` returns (resp,
smooth): the 3D Harris response det(S) - k tr(S)^3 of the six
Gaussian-windowed structure-tensor entries (gradients re-masked to the
volume, pallas_detect3d.py:14-24) and, with `smooth_sigma`, the blurred
volume the describe stage reads (else None). The TPU kernel writes the
six entries and forms the response in XLA; K9 forms it in-kernel from
the same entries in the same operation order (csrc/detect3d.cu). The
3x3x3 NMS stays outside, in `ops/detect3d.py`, as in the reference.

`response_fields_3d` launches the CUDA kernel for a tensor on the card
and runs `response_fields_3d_plain` for a tensor on the CPU. The plain
version performs the kernel's float32 operations in the kernel's order
(each window pass accumulated tap by tap, z then y then x), so the two
agree bit for bit; against the reference's jnp route they agree up to
float32 summation order.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from kcmc_tpu_torch.config import K9_MAX_RADIUS
from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.ops.cuda_detect import corr1d, gauss_taps
from kcmc_tpu_torch.ops.patterns import WINDOW_SIGMA
from kcmc_tpu_torch.utils.device import kernel_route, require_tensor


def _radius(sigma: float) -> int:
    return max(1, int(3.0 * sigma + 0.5))


def supports(window_sigma: float, smooth_sigma: float | None = None) -> bool:
    """Whether K9 takes these Gaussian sigmas: every radius at most
    K9_MAX_RADIUS (pallas_detect3d.supports' radius rule; K9 has no
    width limit). Detection takes the plain route beyond, as the
    reference takes its jnp route."""
    sig = (window_sigma,) if smooth_sigma is None else (window_sigma, smooth_sigma)
    return all(_radius(s) <= K9_MAX_RADIUS for s in sig)


def _check_smooth(smooth_sigma: float | None) -> None:
    if smooth_sigma is not None and smooth_sigma <= 0.0:
        raise ValueError(f"smooth_sigma must be positive, got {smooth_sigma}")


def _central_diff(x: torch.Tensor, dim: int) -> torch.Tensor:
    """0.5 * (x[+1] - x[-1]) along `dim`, SAME zero padding."""
    n = x.shape[dim]
    xp = F.pad(x, (0, 0) * (x.dim() - 1 - dim) + (1, 1))
    return 0.5 * (xp.narrow(dim, 2, n) - xp.narrow(dim, 0, n))


def blur3(x: torch.Tensor, taps) -> torch.Tensor:
    """Separable zero-padded correlation of (B, D, H, W) along z, y, x."""
    return corr1d(corr1d(corr1d(x, taps, 1), taps, 2), taps, 3)


def _harris3(sxx, syy, szz, sxy, sxz, syz, k: float) -> torch.Tensor:
    """det(S) - k tr(S)^3 in the reference's operation order."""
    det = (
        sxx * (syy * szz - syz * syz)
        - sxy * (sxy * szz - syz * sxz)
        + sxz * (sxy * syz - syy * sxz)
    )
    tr = sxx + syy + szz
    return det - k * tr * tr * tr


def response_fields_3d_plain(
    vols: torch.Tensor,
    harris_k: float = 0.005,
    window_sigma: float = WINDOW_SIGMA,
    smooth_sigma: float | None = None,
):
    """Plain PyTorch version of K9: (resp, smooth or None), at any
    radius (the reference's jnp route beyond K9's)."""
    _check_smooth(smooth_sigma)
    g = gauss_taps(window_sigma)
    gz, gy, gx = (_central_diff(vols, d) for d in (1, 2, 3))
    resp = _harris3(
        blur3(gx * gx, g), blur3(gy * gy, g), blur3(gz * gz, g),
        blur3(gx * gy, g), blur3(gx * gz, g), blur3(gy * gz, g), harris_k,
    )
    smooth = None if smooth_sigma is None else blur3(vols, gauss_taps(smooth_sigma))
    return resp, smooth


def _lib():
    fn = cuda_build.load("detect3d").kcmc_response_fields_3d
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, p, i, p, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def response_fields_3d(
    vols: torch.Tensor,
    harris_k: float = 0.005,
    window_sigma: float = WINDOW_SIGMA,
    smooth_sigma: float | None = None,
):
    """(resp, smooth or None) of a (B, D, H, W) float32 batch: the kernel
    on a CUDA tensor (raising beyond `supports`), the plain version on a
    CPU tensor."""
    require_tensor(vols, "vols", torch.float32, 4)
    if not kernel_route(vols):
        return response_fields_3d_plain(vols, harris_k, window_sigma, smooth_sigma)
    _check_smooth(smooth_sigma)
    if not supports(window_sigma, smooth_sigma):
        raise ValueError(
            f"sigmas {window_sigma}, {smooth_sigma} give a radius above "
            f"{K9_MAX_RADIUS}, the 3D detection kernel's largest (the "
            "reference's supports())"
        )
    B, D, H, W = vols.shape
    resp = torch.empty_like(vols)
    smooth = None if smooth_sigma is None else torch.empty_like(vols)
    g = gauss_taps(window_sigma)
    s = gauss_taps(smooth_sigma) if smooth_sigma is not None else (0.0,)
    g_arr = (ctypes.c_float * len(g))(*g)
    s_arr = (ctypes.c_float * len(s))(*s)
    rc = _lib()(
        vols.data_ptr(), resp.data_ptr(),
        smooth.data_ptr() if smooth is not None else None,
        B, D, H, W, ctypes.cast(g_arr, ctypes.c_void_p), len(g) // 2,
        ctypes.cast(s_arr, ctypes.c_void_p), len(s) // 2,
        float(harris_k), torch.cuda.current_stream().cuda_stream,
    )
    cuda_build.check(rc, "response_fields_3d")
    cuda_build.LAUNCHES["response_fields_3d"] += 1
    return resp, smooth
