"""Keypoint detection: Harris response, NMS, fixed-K selection, subpixel.

Counterpart of `kcmc_tpu/ops/detect.py`. The batched entry
`detect_keypoints_batch` takes its dense fields from kernel K1
(`cuda_detect.detect_response`) and selects keypoints here, as the JAX
package selects in XLA after its Pallas kernel. `detect_keypoints`
mirrors the JAX single-frame jnp route (separate convolutions,
edge-replicated subpixel fields) and is a plain function.

Selection rules that must match the reference exactly:
* at most one keypoint per `cand_tile` x `cand_tile` tile, the tile's
  first maximum in row-major order (argmax ties take the first index);
* a stable descending sort of the tile winners, lowest index first on
  ties (`torch.sort(-vals, stable=True)`, never `torch.topk`);
* the threshold is relative to the peak over the border-excluded region.

`valid_hw` (a (2,) int tensor, optional) restricts selection to the
top-left (h, w) valid extent of a frame zero-padded to a shape bucket
(`valid_extent_mask`, the execution plans of plans/).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from kcmc_tpu_torch.ops.cuda_detect import corr1d, detect_response
from kcmc_tpu_torch.ops.patterns import CAND_TILE, WINDOW_SIGMA

_NEG_INF = float("-inf")


class Keypoints(NamedTuple):
    """Fixed-K keypoints, with any leading batch axes."""

    xy: torch.Tensor  # (..., K, 2) float32 (x, y)
    score: torch.Tensor  # (..., K) Harris response
    valid: torch.Tensor  # (..., K) bool


def _gaussian_kernel1d(sigma: float, radius: int) -> tuple[float, ...]:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return tuple(float(v) for v in k / torch.sum(k))


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) images, SAME zero padding:
    columns then rows, as kcmc_tpu's gaussian_blur convolves."""
    radius = max(1, int(3.0 * sigma + 0.5))
    k = _gaussian_kernel1d(sigma, radius)
    x = img.reshape((-1,) + tuple(img.shape[-2:]))
    return corr1d(corr1d(x, k, 2), k, 1).reshape(img.shape)


_SOBEL_SMOOTH = (0.25, 0.5, 0.25)
_SOBEL_DIFF = (-0.5, 0.0, 0.5)


def harris_response(
    img: torch.Tensor, k: float = 0.04, window_sigma: float = WINDOW_SIGMA
) -> torch.Tensor:
    """Harris response det(M) - k * trace(M)^2 of (..., H, W) images."""
    x = img.reshape((-1,) + tuple(img.shape[-2:]))
    gx = corr1d(corr1d(x, _SOBEL_SMOOTH, 1), _SOBEL_DIFF, 2)
    gy = corr1d(corr1d(x, _SOBEL_SMOOTH, 2), _SOBEL_DIFF, 1)
    ixx = gaussian_blur(gx * gx, window_sigma)
    iyy = gaussian_blur(gy * gy, window_sigma)
    ixy = gaussian_blur(gx * gy, window_sigma)
    det = ixx * iyy - ixy * ixy
    trace = ixx + iyy
    return (det - k * trace * trace).reshape(img.shape)


def valid_extent_mask(shape, border: int, valid_hw: torch.Tensor) -> torch.Tensor:
    """(H, W) bool: the selectable region [border, h-border) x [border,
    w-border) of a frame zero-padded to `shape` whose content is the
    top-left `valid_hw` = (h, w) extent (detect.py:159-185). Masking the
    NMS field to -inf outside it makes padded detection equal to
    detection on the unpadded frame: the zero pad and the SAME zero
    padding of the convolutions leave every response inside the valid
    region the same, and the pad boundary's response ridge never enters
    the selection or its peak."""
    H, W = shape
    h, w = valid_hw[0], valid_hw[1]
    ys = torch.arange(H, dtype=torch.int32, device=valid_hw.device)[:, None]
    xs = torch.arange(W, dtype=torch.int32, device=valid_hw.device)[None, :]
    return (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)


def _mask_extent(nms_resp: torch.Tensor, border: int, valid_hw) -> torch.Tensor:
    """nms_resp (B, H, W) at -inf outside the valid extent (a no-op
    without `valid_hw`)."""
    if valid_hw is None:
        return nms_resp
    keep = valid_extent_mask(tuple(nms_resp.shape[-2:]), border,
                             valid_hw.to(nms_resp.device))
    return torch.where(keep, nms_resp, torch.full_like(nms_resp, _NEG_INF))


def _maxpool_same(x: torch.Tensor, size: int) -> torch.Tensor:
    """Separable SAME max-pool of (B, H, W) with -inf padding."""
    lo, hi = (size - 1) // 2, size // 2
    H, W = x.shape[-2:]
    m = F.pad(x, (0, 0, lo, hi), value=_NEG_INF)
    r = m.narrow(-2, 0, H)
    for d in range(1, size):
        r = torch.maximum(r, m.narrow(-2, d, H))
    m = F.pad(r, (lo, hi), value=_NEG_INF)
    c = m.narrow(-1, 0, W)
    for d in range(1, size):
        c = torch.maximum(c, m.narrow(-1, d, W))
    return c


def _subpixel_fields(resp: torch.Tensor):
    """Dense clipped quadratic-fit offsets (ox, oy) of (B, H, W) with
    edge-replicated borders (the jnp route's convention)."""
    r = F.pad(resp[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    c = resp
    left, right = r[:, 1:-1, :-2], r[:, 1:-1, 2:]
    up, down = r[:, :-2, 1:-1], r[:, 2:, 1:-1]
    zero = torch.zeros_like(resp)
    dx = 0.5 * (right - left)
    dy = 0.5 * (down - up)
    dxx = right - 2.0 * c + left
    dyy = down - 2.0 * c + up
    ox = torch.where(dxx.abs() > 1e-8, -dx / dxx, zero)
    oy = torch.where(dyy.abs() > 1e-8, -dy / dyy, zero)
    return torch.clamp(ox, -0.5, 0.5), torch.clamp(oy, -0.5, 0.5)


def sorted_top_k(vals: torch.Tensor, k: int):
    """(top-k values descending, their indices) along the last axis: a
    stable sort of -vals, so ties keep the lowest index first."""
    neg, idx = torch.sort(-vals, dim=-1, stable=True)
    return -neg[..., :k], idx[..., :k]


def tile_max_argmax(resp: torch.Tensor, T: int):
    """Per-(T, T)-tile max and first-in-row-major argmax of (B, H, W)
    with H, W multiples of T. Returns (B, H/T, W/T) values and int64
    within-tile indices."""
    B, H, W = resp.shape
    tiles = resp.reshape(B, H // T, T, W // T, T).permute(0, 1, 3, 2, 4)
    tiles = tiles.reshape(B, H // T, W // T, T * T)
    return tiles.max(dim=-1).values, torch.argmax(tiles, dim=-1)


def _select_keypoints(
    nms_resp: torch.Tensor,
    ox_f: torch.Tensor,
    oy_f: torch.Tensor,
    max_keypoints: int,
    threshold: float,
    border: int,
    cand_tile: int = CAND_TILE,
    _force_general: bool = False,
) -> Keypoints:
    """Fixed-K selection from (B, H, W) dense fields (detect.py:221):
    strongest surviving pixel per tile, then a stable top-K over the
    tile winners, thresholded relative to the border-excluded peak."""
    B, H, W = nms_resp.shape
    T = cand_tile
    dev = nms_resp.device
    neg_inf = torch.tensor(_NEG_INF, device=dev)
    if not _force_general and border % T == 0 and H % T == 0 and W % T == 0:
        tile_val, tile_arg = tile_max_argmax(nms_resp, T)
        th, tw = tile_val.shape[1:]
        tys = torch.arange(th, device=dev)[:, None]
        txs = torch.arange(tw, device=dev)[None, :]
        bt = border // T
        tile_inb = (tys >= bt) & (tys < th - bt) & (txs >= bt) & (txs < tw - bt)
        peak = torch.where(tile_inb, tile_val, neg_inf).amax(dim=(1, 2))
        peak = torch.clamp(peak, min=1e-12)
        keep = tile_inb & (tile_val > threshold * peak[:, None, None])
        tile_val = torch.where(keep, tile_val, neg_inf)
    else:
        ys = torch.arange(H, device=dev)[:, None]
        xs = torch.arange(W, device=dev)[None, :]
        inb = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
        peak = torch.where(inb, nms_resp, neg_inf).amax(dim=(1, 2))
        peak = torch.clamp(peak, min=1e-12)
        keep = inb & (nms_resp > threshold * peak[:, None, None])
        masked = torch.where(keep, nms_resp, neg_inf)
        Hp, Wp = -(-H // T) * T, -(-W // T) * T
        m = F.pad(masked, (0, Wp - W, 0, Hp - H), value=_NEG_INF)
        tile_val, tile_arg = tile_max_argmax(m, T)

    th, tw = tile_val.shape[1:]
    n_tiles = th * tw
    k = min(max_keypoints, n_tiles)
    scores, cand = sorted_top_k(tile_val.reshape(B, -1), k)
    if k < max_keypoints:  # tiny frames: pad back up to the fixed K
        pad = max_keypoints - k
        scores = torch.cat(
            [scores, torch.full((B, pad), _NEG_INF, device=dev)], dim=1
        )
        cand = torch.cat(
            [cand, torch.zeros((B, pad), dtype=cand.dtype, device=dev)], dim=1
        )
    within = torch.gather(tile_arg.reshape(B, -1), 1, cand)
    iy = torch.div(cand, tw, rounding_mode="floor") * T + torch.div(
        within, T, rounding_mode="floor"
    )
    ix = (cand % tw) * T + within % T
    valid = torch.isfinite(scores)

    flat = torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)
    offsets = torch.stack(
        [
            torch.gather(ox_f.reshape(B, -1), 1, flat),
            torch.gather(oy_f.reshape(B, -1), 1, flat),
        ],
        dim=-1,
    )
    xy = torch.stack([ix.to(torch.float32), iy.to(torch.float32)], dim=-1)
    zero = torch.zeros((), device=dev)
    xy = xy + torch.where(valid[..., None], offsets, zero)
    scores = torch.where(valid, scores, zero)
    xy = torch.where(valid[..., None], xy, zero)
    return Keypoints(xy=xy, score=scores, valid=valid)


def detect_keypoints(
    img: torch.Tensor,
    max_keypoints: int = 512,
    threshold: float = 1e-6,
    nms_size: int = 5,
    border: int = 16,
    harris_k: float = 0.04,
    window_sigma: float = WINDOW_SIGMA,
    cand_tile: int = CAND_TILE,
    valid_hw: torch.Tensor | None = None,
) -> Keypoints:
    """Harris corners of one (H, W) frame through the plain separate
    passes (the JAX package's jnp route); `valid_hw` masks selection to
    the valid extent of a padded frame."""
    resp = harris_response(img[None], k=harris_k, window_sigma=window_sigma)
    is_max = resp >= _maxpool_same(resp, nms_size)
    nms_resp = torch.where(is_max, resp, torch.full_like(resp, _NEG_INF))
    nms_resp = _mask_extent(nms_resp, border, valid_hw)
    ox_f, oy_f = _subpixel_fields(resp)
    kps = _select_keypoints(
        nms_resp, ox_f, oy_f, max_keypoints, threshold, border, cand_tile
    )
    return Keypoints(*(t[0] for t in kps))


def detect_keypoints_batch(
    frames: torch.Tensor,
    max_keypoints: int = 512,
    threshold: float = 1e-6,
    nms_size: int = 5,
    border: int = 16,
    harris_k: float = 0.04,
    smooth_sigma: float | None = None,
    window_sigma: float = WINDOW_SIGMA,
    cand_tile: int = CAND_TILE,
    valid_hw: torch.Tensor | None = None,
):
    """Keypoints of a (B, H, W) float32 batch from the fused K1 fields.

    With `smooth_sigma` returns (keypoints, smooth), the blurred batch
    the kernel computes on the side for the describe stage. `border`
    must be >= 1: K1's subpixel fields zero-extend the response, so the
    1-px frame ring (where they differ from the jnp route's edge
    replication) must stay unselectable. `valid_hw` masks the NMS field
    to the valid extent of bucket-padded frames before selection
    (detect.py:450-454); K1 runs unchanged on the padded canvas."""
    if border < 1:
        raise ValueError(
            "border must be >= 1 for the fused detection fields (their "
            "subpixel fits zero-extend the response at the frame edge)"
        )
    out = detect_response(
        frames, harris_k=harris_k, nms_size=nms_size,
        window_sigma=window_sigma, smooth_sigma=smooth_sigma,
    )
    kps = _select_keypoints(
        _mask_extent(out[0], border, valid_hw), out[1], out[2], max_keypoints,
        threshold, border, cand_tile,
    )
    return (kps, out[3]) if smooth_sigma is not None else kps
