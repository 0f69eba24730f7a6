"""Spatially banded KNN matching: each query keypoint is matched only
against the reference keypoints within a window covering its +-R motion
envelope, instead of the dense (K, K) Hamming matrix.

Counterpart of `kcmc_tpu/ops/match_banded.py` (`match_radius`), batched
over frames where the reference maps one frame:

* `make_geometry` (match_banded.py:88): plain numpy, the static grid
  sizes, bucket capacities, each query tile's candidate window of
  reference sub-buckets and each sub-bucket's serving tiles;
* `build_banded_ref` (:244): the reference keypoints bucketed once per
  batch into fixed-capacity sub-buckets (overflow drops the last
  keypoints of a bucket in detection order: one stable argsort,
  `dispatch.segment_by_key`), gathered into each tile's candidates;
* `banded_match` (:278): queries bucketed per frame into tiles, one
  ±1 matmul per tile (exact in float32: integer sums <= 256), the
  first-index argmin over the window's candidate order, Lowe's ratio,
  and the reduce-first mutual pass on packed (distance, query) keys,
  each sub-bucket the min over its statically known serving
  (tile, window-slot) rows.

Returns the dense matcher's `Matches` in original query-slot order, with
the reference's indices and distances (masked slots carry 1 << 16).
The matcher is plain torch on both devices, as it is XLA in the
reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from kcmc_tpu_torch.ops.dispatch import segment_by_key
from kcmc_tpu_torch.ops.match import Matches, unpack_pm1
from kcmc_tpu_torch.ops.patterns import N_BITS

IBIG = 1 << 16  # the banded matcher's sentinel distance (> N_BITS)


class BandedGeometry(NamedTuple):
    """Static geometry for one (shape, radius, K) tuple (numpy)."""

    shape: tuple  # (H, W)
    tile: int  # query tile side, px
    sub: int  # reference sub-bucket side, px
    th: int  # query tile grid rows
    tw: int  # query tile grid cols
    gh: int  # ref sub-bucket grid rows
    gw: int  # ref sub-bucket grid cols
    cq: int  # query slots per tile
    csub: int  # ref slots per sub-bucket
    n_win: int  # candidate window side, in sub-buckets
    window_sub: np.ndarray  # (T, n_win²) int32 sub-bucket id per window slot
    window_ok: np.ndarray  # (T, n_win²) bool: window slot inside the grid
    rev_tile: np.ndarray  # (G, S) int32 serving tile ids per sub-bucket
    rev_wpos: np.ndarray  # (G, S) int32 window position of the sub-bucket
    rev_ok: np.ndarray  # (G, S) bool


def make_geometry(
    shape: tuple,
    radius: float,
    n_query: int,
    n_ref: int,
    tile: int = 64,
    slack: float = 2.0,
    nms_tile: int | None = None,
) -> BandedGeometry:
    """The static geometry: sub-buckets of tile // 4 px for radii up to
    that, else tile // 2; a window of tile // sub + 2 ceil(R / sub)
    sub-buckets per axis (every reference keypoint within R of any query
    of the tile is a candidate); capacities `slack` times the mean
    occupancy, at least 8, rounded up to 8, capped by the NMS occupancy
    bound (cell // nms_tile + 1)² when `nms_tile` is given."""
    H, W = int(shape[0]), int(shape[1])
    tile = int(tile)
    if tile < 16:
        raise ValueError(f"match_tile must be >= 16, got {tile}")
    if radius <= 0:
        raise ValueError(f"match_radius must be positive, got {radius}")
    if tile % 4:
        raise ValueError(f"match tile must be a multiple of 4, got {tile}")
    sub = tile // 4 if radius <= tile // 4 else tile // 2
    pad_subs = int(math.ceil(radius / sub))
    r = tile // sub  # sub-buckets per tile side
    n_win = r + 2 * pad_subs

    th, tw = -(-H // tile), -(-W // tile)
    gh, gw = -(-H // sub), -(-W // sub)
    T, G = th * tw, gh * gw

    def cap(n, cell):
        mean = n * cell * cell / (H * W)
        c = int(math.ceil(slack * mean))
        c = max(8, -(-c // 8) * 8)
        if nms_tile is not None and nms_tile >= 1:
            c = min(c, max((cell // nms_tile + 1) ** 2, 1))
        return c

    cq = cap(n_query, tile)
    csub = cap(n_ref, sub)

    # tile (ty, tx)'s window: the n_win x n_win sub-buckets from
    # (ty r - pad, tx r - pad)
    tys, txs = np.divmod(np.arange(T), tw)
    wy = tys[:, None] * r - pad_subs + np.arange(n_win)[None, :]
    wx = txs[:, None] * r - pad_subs + np.arange(n_win)[None, :]
    oky = (wy >= 0) & (wy < gh)
    okx = (wx >= 0) & (wx < gw)
    sub_id = np.clip(wy, 0, gh - 1)[:, :, None] * gw + np.clip(wx, 0, gw - 1)[:, None, :]
    window_sub = sub_id.reshape(T, n_win * n_win).astype(np.int32)
    window_ok = (oky[:, :, None] & okx[:, None, :]).reshape(T, n_win * n_win)

    # the tiles whose windows hold sub-bucket (sy, sx): at most
    # ceil(n_win / r) per axis
    S_axis = -(-n_win // r)
    sys_, sxs = np.divmod(np.arange(G), gw)

    def serving(s):
        lo = -(-(s + pad_subs - n_win + 1) // r)
        ids = lo[:, None] + np.arange(S_axis)[None, :]
        return ids, ids * r - pad_subs <= s[:, None]

    ty_ids, ty_ok = serving(sys_)
    tx_ids, tx_ok = serving(sxs)
    ty_ok &= (ty_ids >= 0) & (ty_ids < th)
    tx_ok &= (tx_ids >= 0) & (tx_ids < tw)
    rev_tile = (
        np.clip(ty_ids, 0, th - 1)[:, :, None] * tw + np.clip(tx_ids, 0, tw - 1)[:, None, :]
    ).reshape(G, S_axis * S_axis).astype(np.int32)
    rev_ok = (ty_ok[:, :, None] & tx_ok[:, None, :]).reshape(G, -1)
    wpy = sys_[:, None] - (np.clip(ty_ids, 0, th - 1) * r - pad_subs)
    wpx = sxs[:, None] - (np.clip(tx_ids, 0, tw - 1) * r - pad_subs)
    rev_wpos = (wpy[:, :, None] * n_win + wpx[:, None, :]).reshape(G, -1).astype(np.int32)
    rev_wpos = np.clip(rev_wpos, 0, n_win * n_win - 1)

    return BandedGeometry(
        shape=(H, W), tile=tile, sub=sub, th=th, tw=tw, gh=gh, gw=gw,
        cq=cq, csub=csub, n_win=n_win,
        window_sub=window_sub, window_ok=window_ok,
        rev_tile=rev_tile, rev_wpos=rev_wpos, rev_ok=rev_ok,
    )


def _bucketize(xy: torch.Tensor, valid: torch.Tensor, cell: int, gh: int, gw: int, cap: int):
    """(..., N, 2) keypoints into a (gh, gw) grid of `cell`-px buckets of
    `cap` slots (match_banded.py:202): (slot_idx (..., G, cap) int64,
    slot_ok (..., G, cap) bool). Invalid keypoints and keypoints outside
    the grid are dropped (never clamped into a border bucket)."""
    G = gh * gw
    cx = torch.div(xy[..., 0], cell, rounding_mode="floor").to(torch.int32)
    cy = torch.div(xy[..., 1], cell, rounding_mode="floor").to(torch.int32)
    in_grid = (cx >= 0) & (cx < gw) & (cy >= 0) & (cy < gh)
    cid = torch.where(
        valid & in_grid,
        torch.clamp(cy, 0, gh - 1) * gw + torch.clamp(cx, 0, gw - 1),
        torch.full_like(cx, G),
    )
    return segment_by_key(cid, G, cap)


class BandedRef(NamedTuple):
    """The reference keypoints bucketed for one batch."""

    cand_pm1: torch.Tensor  # (T, C, N_BITS) float32 ±1 candidate descriptors
    cand_idx: torch.Tensor  # (T, C) int64 reference keypoint per slot
    cand_ok: torch.Tensor  # (T, C) bool
    ref_sub: torch.Tensor  # (Kr,) int64 sub-bucket of each keypoint (G: dropped)
    ref_slot: torch.Tensor  # (Kr,) int64 slot within that sub-bucket


def build_banded_ref(geom: BandedGeometry, ref_xy, ref_desc, ref_valid) -> BandedRef:
    """Bucket the (Kr, 2) reference keypoints and gather each tile's
    candidates (match_banded.py:244). Zero descriptors are invalid."""
    dev = ref_xy.device
    Kr = ref_xy.shape[0]
    G = geom.gh * geom.gw
    ref_valid = ref_valid & torch.any(ref_desc != 0, dim=-1)
    slot_idx, slot_ok = _bucketize(ref_xy, ref_valid, geom.sub, geom.gh, geom.gw, geom.csub)
    # keypoint -> (sub-bucket, slot); overflow-dropped keypoints keep
    # (G, 0) and are never a candidate
    flat = torch.where(slot_ok, slot_idx, torch.full_like(slot_idx, Kr)).reshape(-1)
    subs = torch.arange(G, dtype=torch.int64, device=dev).repeat_interleave(geom.csub)
    slots = torch.arange(geom.csub, dtype=torch.int64, device=dev).repeat(G)
    ref_sub = torch.full((Kr + 1,), G, dtype=torch.int64, device=dev)
    ref_sub[flat] = subs
    ref_slot = torch.zeros((Kr + 1,), dtype=torch.int64, device=dev)
    ref_slot[flat] = slots
    wsub = torch.as_tensor(geom.window_sub, dtype=torch.int64, device=dev)  # (T, n_win²)
    wok = torch.as_tensor(geom.window_ok, device=dev)
    T = wsub.shape[0]
    cand_idx = slot_idx[wsub].reshape(T, -1)  # (T, n_win² csub)
    cand_ok = (slot_ok[wsub] & wok[:, :, None]).reshape(T, -1)
    return BandedRef(
        cand_pm1=unpack_pm1(ref_desc[cand_idx]), cand_idx=cand_idx, cand_ok=cand_ok,
        ref_sub=ref_sub[:Kr], ref_slot=ref_slot[:Kr],
    )


def banded_match(
    geom: BandedGeometry,
    bref: BandedRef,
    q_desc: torch.Tensor,
    q_xy: torch.Tensor,
    q_valid: torch.Tensor,
    ratio: float = 0.85,
    max_dist: int = 80,
    mutual: bool = True,
) -> Matches:
    """2-NN Hamming match of a batch's (B, K, W) descriptors at (B, K, 2)
    positions against the banded reference (match_banded.py:278): valid
    iff best < max_dist, best < ratio * second and, with `mutual`, the
    matched reference keypoint's best query over the tiles serving its
    sub-bucket is this one (lowest query index on ties)."""
    B, K = q_desc.shape[:2]
    dev = q_desc.device
    T, cq, csub = geom.th * geom.tw, geom.cq, geom.csub
    q_valid = q_valid & torch.any(q_desc != 0, dim=-1)
    q_slot_idx, q_slot_ok = _bucketize(q_xy, q_valid, geom.tile, geom.th, geom.tw, cq)
    qd = torch.gather(q_desc, 1, q_slot_idx.reshape(B, T * cq, 1).expand(-1, -1, q_desc.shape[-1]))
    qd = unpack_pm1(qd).reshape(B, T, cq, N_BITS)

    # one matmul per tile; the sum of ±1 products is an exact integer
    s = torch.matmul(qd, bref.cand_pm1.transpose(1, 2))  # (B, T, cq, C)
    del qd
    D = s.sub_(N_BITS).mul_(-0.5).to(torch.int32)  # (N_BITS - s) / 2
    del s
    D.masked_fill_(~q_slot_ok[..., None], IBIG)
    D.masked_fill_(~bref.cand_ok[None, :, None, :], IBIG)
    C = D.shape[-1]

    best = D.amin(dim=-1)  # (B, T, cq)
    arg = torch.argmin(D, dim=-1)  # first index among ties
    second = D.scatter(-1, arg[..., None], IBIG).amin(dim=-1)
    ridx = torch.gather(bref.cand_idx.expand(B, T, C), 2, arg)  # (B, T, cq) global
    r32 = torch.tensor(ratio, dtype=torch.float32, device=dev)
    ok = (best < max_dist) & (best.to(torch.float32) < r32 * second.to(torch.float32))
    ok = ok & q_slot_ok & (best < N_BITS + 1)

    if mutual:
        # reduce first, gather after: the best query of each (tile,
        # window slot) candidate, then each sub-bucket the min over its
        # serving rows; keys pack (distance capped at 2 N_BITS, query)
        G = geom.gh * geom.gw
        n_w2 = geom.n_win * geom.n_win
        mult = 1 << int(K + 1).bit_length()
        if (2 * N_BITS + 1) * mult + K >= 2**31:
            raise ValueError(f"banded mutual packing overflows int32 at K={K}")
        packed = torch.clamp(D.reshape(B, T, cq, n_w2, csub).to(torch.int64), max=2 * N_BITS)
        packed = packed * mult + q_slot_idx[..., None, None]
        tw_min = packed.amin(dim=2).reshape(B, T * n_w2, csub)
        del packed
        sentinel = (2 * N_BITS) * mult + mult - 1
        src = torch.as_tensor(geom.rev_tile * n_w2 + geom.rev_wpos, dtype=torch.int64, device=dev)
        rev_ok = torch.as_tensor(geom.rev_ok, device=dev)
        rev = torch.full((B, G, csub), sentinel, dtype=torch.int64, device=dev)
        for si in range(src.shape[1]):
            rows = torch.where(rev_ok[None, :, si, None], tw_min[:, src[:, si]],
                               torch.full_like(rev, sentinel))
            rev = torch.minimum(rev, rows)
        rev_q = (rev % mult).reshape(B, G * csub)
        rsub = torch.clamp(bref.ref_sub[ridx], max=G - 1)  # G only for dropped refs
        claimed = torch.gather(rev_q, 1, (rsub * csub + bref.ref_slot[ridx]).reshape(B, -1))
        ok = ok & (claimed.reshape(B, T, cq) == q_slot_idx)

    # back to the original query order; invalid slots go to a scratch
    # column past the end
    dest = torch.where(q_slot_ok, q_slot_idx, torch.full_like(q_slot_idx, K)).reshape(B, -1)

    def scatter(vals, fill, dtype):
        out = torch.full((B, K + 1), fill, dtype=dtype, device=dev)
        return out.scatter_(1, dest, vals.reshape(B, -1).to(dtype))[:, :K]

    return Matches(
        idx=scatter(ridx, 0, torch.int64),
        dist=scatter(best, IBIG, torch.int32),
        second=scatter(second, IBIG, torch.int32),
        valid=scatter(ok, False, torch.bool),
    )
