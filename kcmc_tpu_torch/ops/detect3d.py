"""3D keypoint detection for z-stack registration (config 5).

Counterpart of `kcmc_tpu/ops/detect3d.py`. The 3D Harris response is
det(S) - k tr(S)^3 of the Gaussian-windowed structure tensor S of the
volume gradients; NMS keeps 3x3x3 maxima; selection is the fixed-K
tile top-k of the 2D path with a per-axis parabola subpixel fit.

The batched entry `detect_keypoints_3d_batch` takes the response and the
describe-stage blur from kernel K9 (`cuda_detect3d.response_fields_3d`)
and runs NMS and selection here, as the JAX package runs them in XLA
after its Pallas kernel. K9's plain version sums in the order of the
reference's jnp route (its `_conv3d_axis` shift-and-add is
`cuda_detect.corr1d` along one axis, and numpy's float32 taps equal its
`_gauss1d`'s), so `harris_response_3d`, `gaussian_blur_3d` and
`detect_keypoints_3d`, the reference's jnp-route functions, are that
plain version; on the CPU the two routes agree bit for bit.

Selection rules that must match the reference exactly: one candidate
per (1, T, T) tile (T = 8, the tile's first maximum), z planes within
min(border, max(1, D // 8)) of a face and y/x within `border` excluded,
the threshold relative to the peak over that region, a stable
descending sort of the tile winners.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kcmc_tpu_torch.ops.cuda_detect import gauss_taps
from kcmc_tpu_torch.ops.cuda_detect3d import (
    blur3,
    response_fields_3d,
    response_fields_3d_plain,
    supports,
)
from kcmc_tpu_torch.ops.detect import Keypoints, sorted_top_k, tile_max_argmax
from kcmc_tpu_torch.ops.patterns import WINDOW_SIGMA

_NEG_INF = float("-inf")
_T = 8  # candidate tile side in y and x (z tiles are single planes)


def gaussian_blur_3d(vols: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of a (B, D, H, W) batch along z, y, x,
    SAME zero padding."""
    return blur3(vols, gauss_taps(sigma))


def harris_response_3d(
    vols: torch.Tensor, k: float = 0.005, window_sigma: float = WINDOW_SIGMA
) -> torch.Tensor:
    """3D Harris response det(S) - k tr(S)^3 of a (B, D, H, W) batch."""
    return response_fields_3d_plain(vols, harris_k=k, window_sigma=window_sigma)[0]


def _maxpool3_same(x: torch.Tensor) -> torch.Tensor:
    """3x3x3 max of a (B, D, H, W) batch, -inf outside."""
    return F.max_pool3d(x[:, None], 3, stride=1, padding=1)[:, 0]


def _nms(resp: torch.Tensor) -> torch.Tensor:
    return torch.where(resp >= _maxpool3_same(resp), resp, torch.full_like(resp, _NEG_INF))


def _select_keypoints_3d(
    resp: torch.Tensor,
    nms_resp: torch.Tensor,
    max_keypoints: int,
    threshold: float,
    border: int,
    _force_general: bool = False,
) -> Keypoints:
    """Fixed-K selection from (B, D, H, W) dense fields (detect3d.py:104):
    keypoints with xy = (B, K, 3) float (x, y, z). `_force_general` is
    the test seam that sends tile-aligned shapes down the general path."""
    B, D, H, W = resp.shape
    T = _T
    dev = resp.device
    neg_inf = torch.tensor(_NEG_INF, device=dev)
    bz = min(border, max(1, D // 8))
    if not _force_general and border % T == 0 and H % T == 0 and W % T == 0:
        tile_val, tile_arg = tile_max_argmax(nms_resp.reshape(B * D, H, W), T)
        th, tw = tile_val.shape[1:]
        tile_val = tile_val.reshape(B, D, th, tw)
        tile_arg = tile_arg.reshape(B, D, th, tw)
        tzs = torch.arange(D, device=dev)[:, None, None]
        tys = torch.arange(th, device=dev)[None, :, None]
        txs = torch.arange(tw, device=dev)[None, None, :]
        bt = border // T
        tile_inb = (
            (tzs >= bz) & (tzs < D - bz) & (tys >= bt) & (tys < th - bt)
            & (txs >= bt) & (txs < tw - bt)
        )
        peak = torch.where(tile_inb, tile_val, neg_inf).amax(dim=(1, 2, 3))
        peak = torch.clamp(peak, min=1e-12)[:, None, None, None]
        tile_val = torch.where(tile_inb & (tile_val > threshold * peak), tile_val, neg_inf)
    else:
        zs = torch.arange(D, device=dev)[:, None, None]
        ys = torch.arange(H, device=dev)[None, :, None]
        xs = torch.arange(W, device=dev)[None, None, :]
        inb = (
            (zs >= bz) & (zs < D - bz) & (ys >= border) & (ys < H - border)
            & (xs >= border) & (xs < W - border)
        )
        peak = torch.where(inb, nms_resp, neg_inf).amax(dim=(1, 2, 3))
        peak = torch.clamp(peak, min=1e-12)[:, None, None, None]
        masked = torch.where(inb & (nms_resp > threshold * peak), nms_resp, neg_inf)
        Hp, Wp = -(-H // T) * T, -(-W // T) * T
        m = F.pad(masked, (0, Wp - W, 0, Hp - H), value=_NEG_INF)
        tile_val, tile_arg = tile_max_argmax(m.reshape(B * D, Hp, Wp), T)
        th, tw = tile_val.shape[1:]
        tile_val = tile_val.reshape(B, D, th, tw)
        tile_arg = tile_arg.reshape(B, D, th, tw)

    n_tiles = D * th * tw
    k = min(max_keypoints, n_tiles)
    scores, cand = sorted_top_k(tile_val.reshape(B, -1), k)
    if k < max_keypoints:
        pad = max_keypoints - k
        scores = torch.cat([scores, torch.full((B, pad), _NEG_INF, device=dev)], dim=1)
        cand = torch.cat([cand, torch.zeros((B, pad), dtype=cand.dtype, device=dev)], dim=1)
    within = torch.gather(tile_arg.reshape(B, -1), 1, cand)
    iz = torch.div(cand, th * tw, rounding_mode="floor")
    iy = (torch.div(cand, tw, rounding_mode="floor") % th) * T + torch.div(
        within, T, rounding_mode="floor"
    )
    ix = (cand % tw) * T + within % T
    iy = torch.clamp(iy, 0, H - 1)
    ix = torch.clamp(ix, 0, W - 1)
    valid = torch.isfinite(scores)

    if border >= 1:
        # per-axis parabolas through the peak's six axis neighbours; the
        # clamps move only invalid slots (border >= 1 and bz >= 1 keep
        # every selectable peak's neighbours inside)
        izc = torch.clamp(iz, 1, D - 2)
        iyc = torch.clamp(iy, 1, H - 2)
        ixc = torch.clamp(ix, 1, W - 2)
        rf = resp.reshape(B, -1)

        def at(z, y, x):
            return torch.gather(rf, 1, (z * H + y) * W + x)

        c0 = at(izc, iyc, ixc)

        def axis_off(plus, minus):
            d1 = 0.5 * (plus - minus)
            d2 = plus - 2.0 * c0 + minus
            o = torch.where(d2.abs() > 1e-8, -d1 / d2, torch.zeros_like(d2))
            return torch.clamp(o, -0.5, 0.5)

        ox = axis_off(at(izc, iyc, ixc + 1), at(izc, iyc, ixc - 1))
        oy = axis_off(at(izc, iyc + 1, ixc), at(izc, iyc - 1, ixc))
        oz = axis_off(at(izc + 1, iyc, ixc), at(izc - 1, iyc, ixc))
    else:
        # peaks may sit on the faces: dense fits on the edge-replicated
        # response
        r = F.pad(resp[:, None], (1, 1, 1, 1, 1, 1), mode="replicate")[:, 0]

        def axis_field(plus, minus):
            d1 = 0.5 * (plus - minus)
            d2 = plus - 2.0 * resp + minus
            o = torch.where(d2.abs() > 1e-8, -d1 / d2, torch.zeros_like(d2))
            return torch.clamp(o, -0.5, 0.5).reshape(B, -1)

        flat = (iz * H + iy) * W + ix
        ox = torch.gather(axis_field(r[:, 1:-1, 1:-1, 2:], r[:, 1:-1, 1:-1, :-2]), 1, flat)
        oy = torch.gather(axis_field(r[:, 1:-1, 2:, 1:-1], r[:, 1:-1, :-2, 1:-1]), 1, flat)
        oz = torch.gather(axis_field(r[:, 2:, 1:-1, 1:-1], r[:, :-2, 1:-1, 1:-1]), 1, flat)

    xyz = torch.stack(
        [ix.to(torch.float32) + ox, iy.to(torch.float32) + oy, iz.to(torch.float32) + oz],
        dim=-1,
    )
    zero = torch.zeros((), device=dev)
    xyz = torch.where(valid[..., None], xyz, zero)
    scores = torch.where(valid, scores, zero)
    return Keypoints(xy=xyz, score=scores, valid=valid)


def detect_keypoints_3d(
    vol: torch.Tensor,
    max_keypoints: int = 256,
    threshold: float = 1e-4,
    border: int = 6,
    harris_k: float = 0.005,
) -> Keypoints:
    """Fixed-K 3D corners of one (D, H, W) volume: xy = (K, 3) (x, y, z)."""
    kps = detect_keypoints_3d_batch(vol[None], max_keypoints, threshold, border, harris_k)
    return Keypoints(*(t[0] for t in kps))


def detect_keypoints_3d_batch(
    vols: torch.Tensor,
    max_keypoints: int = 256,
    threshold: float = 1e-4,
    border: int = 6,
    harris_k: float = 0.005,
    smooth_sigma: float | None = None,
):
    """Keypoints of a (B, D, H, W) float32 batch from K9's response.
    With `smooth_sigma` returns (keypoints, smooth), the blurred batch
    K9 computes on the side for the describe stage. Where K9 does not
    take the sigmas (`cuda_detect3d.supports`: a blur radius above 6),
    the plain route computes both on the batch's own device, as the
    reference takes its jnp route (detect3d.py:300-324)."""
    fields = response_fields_3d if supports(WINDOW_SIGMA, smooth_sigma) else response_fields_3d_plain
    resp, smooth = fields(
        vols, harris_k=harris_k, window_sigma=WINDOW_SIGMA, smooth_sigma=smooth_sigma
    )
    kps = _select_keypoints_3d(resp, _nms(resp), max_keypoints, threshold, border)
    return (kps, smooth) if smooth_sigma is not None else kps
