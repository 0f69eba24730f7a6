"""Gather-free batched warp for affine-family transforms: shear and
scale passes.

Counterpart of `kcmc_tpu/ops/warp_separable.py` (plain PyTorch; the
reference has no Pallas kernel here). The 2x2 linear part splits as

    M2 = Sx(alpha) @ Sy(beta) @ diag(u, v)

and the warp runs, in order, an x-shear pass (rows sampled at
x + alpha (y - cy)), a y-shear pass (columns at y + beta (x - cx)), and
two scale passes that also carry the whole translation, each a banded
bilinear-interpolation matrix applied as one batched float32 matmul
(TF32 is off on the card). The shear passes are 2 * shear_px + 1
shifted views of an edge-padded frame blended by per-row (per-column)
coefficients; a frame whose shear exceeds `shear_px`, whose map is
projective, or whose decomposition degenerates is zeroed and flagged.
Out-of-frame samples are 0, from the true 2D source positions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def decompose_affine(M: torch.Tensor) -> dict:
    """Shear and scale pass parameters of (B, 3, 3) affine maps, each
    (B,): alpha, beta (shears), u, v (strides), c and m12 (offsets), and
    `ok` (False where m11 ~ 0 or u ~ 0)."""
    m00, m01, m02 = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2]
    m10, m11, m12 = M[:, 1, 0], M[:, 1, 1], M[:, 1, 2]
    one = torch.ones_like(m11)
    ok1 = m11.abs() > 1e-3
    alpha = m01 / torch.where(ok1, m11, one)
    u = m00 - alpha * m10
    ok2 = u.abs() > 1e-3
    us = torch.where(ok2, u, one)
    return {
        "alpha": alpha, "beta": m10 / us, "u": us, "v": m11,
        "c": m02 - alpha * m12, "m12": m12, "ok": ok1 & ok2,
    }


def _shear_taps(shift: torch.Tensor, R: int):
    """Per-line bilinear coefficients of the 2R + 1 shifted views for
    line shifts (B, n): the view at offset k takes (1 - f) where
    floor(shift) == k and f where floor(shift) == k - 1."""
    m = torch.floor(shift)
    f = shift - m
    mi = m.to(torch.int32)
    zero = torch.zeros_like(f)
    for k in range(-R, R + 1):
        yield k, torch.where(mi == k, 1.0 - f, zero) + torch.where(mi == k - 1, f, zero)


def _shear_x(img: torch.Tensor, alpha: torch.Tensor, cy: float, R: int) -> torch.Tensor:
    """Resample the rows of (B, H, W) at x + alpha (y - cy);
    |alpha (y - cy)| must be <= R."""
    B, H, W = img.shape
    y = torch.arange(H, dtype=torch.float32, device=img.device) - cy
    padded = F.pad(img[:, None], (R + 1, R + 1, 0, 0), mode="replicate")[:, 0]
    out = torch.zeros_like(img)
    for k, coef in _shear_taps(alpha[:, None] * y[None, :], R):
        out = out + coef[:, :, None] * padded[:, :, R + 1 + k: R + 1 + k + W]
    return out


def _shear_y(img: torch.Tensor, beta: torch.Tensor, cx: float, R: int) -> torch.Tensor:
    """Resample the columns of (B, H, W) at y + beta (x - cx);
    |beta (x - cx)| must be <= R."""
    B, H, W = img.shape
    x = torch.arange(W, dtype=torch.float32, device=img.device) - cx
    padded = F.pad(img[:, None], (0, 0, R + 1, R + 1), mode="replicate")[:, 0]
    out = torch.zeros_like(img)
    for k, coef in _shear_taps(beta[:, None] * x[None, :], R):
        out = out + coef[:, None, :] * padded[:, R + 1 + k: R + 1 + k + H, :]
    return out


def _resample_matrix(n_in: int, n_out: int, stride: torch.Tensor,
                     offset: torch.Tensor) -> torch.Tensor:
    """(B, n_out, n_in) banded bilinear matrices: out[i] = in at
    stride * i + offset; rows whose source leaves [0, n_in - 1] are 0."""
    dev = stride.device
    pos = stride[:, None] * torch.arange(n_out, dtype=torch.float32, device=dev) \
        + offset[:, None]
    src = torch.arange(n_in, dtype=torch.float32, device=dev)
    K = torch.clamp(1.0 - (pos[:, :, None] - src[None, None, :]).abs(), min=0.0)
    inb = (pos >= 0.0) & (pos <= n_in - 1.0)
    return K * inb[:, :, None]


def warp_batch_affine(frames: torch.Tensor, transforms: torch.Tensor,
                      shear_px: int = 8, with_ok: bool = False):
    """Correct (B, H, W) frames through (B, 3, 3) affine ref -> frame
    maps without gathers; frames beyond `shear_px`, projective or
    degenerate are zeroed. `with_ok` also returns the (B,) bool flags
    (False = zeroed)."""
    B, H, W = frames.shape
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    img = frames.to(torch.float32)
    M = transforms.to(torch.float32)
    p = decompose_affine(M)
    ok = (
        (p["alpha"].abs() * max(cy, H - 1 - cy) <= shear_px)
        & (p["beta"].abs() * max(cx, W - 1 - cx) <= shear_px)
        & p["ok"]
        & (M[:, 2, 0].abs() < 1e-12) & (M[:, 2, 1].abs() < 1e-12)
        & ((M[:, 2, 2] - 1.0).abs() < 1e-6)
    )
    x2 = _shear_y(_shear_x(img, p["alpha"], cy, shear_px), p["beta"], cx, shear_px)
    # the shear offsets are centre-relative: cX absorbs the x-shear's
    # alpha * cy, and dY is solved from the row-1 offset given cX
    cX = p["c"] + p["alpha"] * cy
    dY = p["m12"] - p["beta"] * (cX - cx)
    Kx = _resample_matrix(W, W, p["u"], cX)
    Ky = _resample_matrix(H, H, p["v"], dY)
    x4 = torch.matmul(Ky, torch.matmul(x2, Kx.transpose(1, 2)))
    xs = torch.arange(W, dtype=torch.float32, device=img.device)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=img.device)[None, :, None]

    def m(i, j):
        return M[:, i, j, None, None]

    sx = m(0, 0) * xs + m(0, 1) * ys + m(0, 2)
    sy = m(1, 0) * xs + m(1, 1) * ys + m(1, 2)
    inb = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    out = torch.where(ok[:, None, None] & inb, x4, torch.zeros((), device=img.device))
    return (out, ok) if with_ok else out
