"""Binary keypoint descriptors: upright BRIEF and the two oriented
(ORB-style) routes.

Counterpart of `kcmc_tpu/ops/describe.py::describe_keypoints_batch`
(describe.py:298-440). Both routes start alike: the blurred frames lose
their finite-pixel mean, are quantized to bf16 and edge-padded by r + 1
(r = PATCH_RADIUS upright, ROT_RADIUS oriented; P = 2r + 2).

Upright (the translation model): kernel K2 cuts and blends each
keypoint's (P-1, P-1) patch and the 512 pattern samples are read out of
it. The reference does this as a one-hot (729, 512) matmul, which
selects exactly, so an index gather of the same rows is the same
function.

Oriented, small K (describe.py:421-431, below BINS_FIRST_MIN_K
keypoints): kernel K6 cuts and blends each keypoint's patch and sums the
ORB disc moments of its raw window; the moments give the orientation
bin, `_binned_select` groups keypoints by bin into fixed-capacity
segments (`dispatch.segment_by_key`; an overfull bin drops its weakest
keypoints, whose descriptors stay zero) and each segment reads its bin's
rotated pattern out of the patches.

Oriented, bins-first (describe.py:401-420 and :531, taken from
K >= BINS_FIRST_MIN_K keypoints): kernel K4 computes the ORB disc
moments at every pixel, the
moments at each keypoint's rounded position give its angle and its
orientation bin, a packed stable sort lays the keypoints out in
16-aligned runs of equal bin, K2 extracts the patches in that order, and
kernel K5 multiplies each 16-row block by its bin's one-hot selection
matrix of the rotated pattern. The words are packed in the sorted
layout and mapped back to keypoint order.

Bit i is `sample[2i] < sample[2i+1]`, packed into N_WORDS 32-bit words
(bit i at word i // 32, position i % 32); invalid slots are 0.
Descriptors are (..., N_WORDS) int64 tensors holding the uint32 bit
patterns of the reference's descriptors.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from kcmc_tpu_torch.config import BINS_FIRST_MIN_K
from kcmc_tpu_torch.ops.cuda_moments import moment_maps
from kcmc_tpu_torch.ops.cuda_patch import extract_blended
from kcmc_tpu_torch.ops.cuda_select import binned_select_rows
from kcmc_tpu_torch.ops.detect import Keypoints, gaussian_blur
from kcmc_tpu_torch.ops.dispatch import segment_by_key, stable_argsort_small_keys
from kcmc_tpu_torch.ops.patterns import (
    MOMENT_RADIUS,
    N_BITS,
    N_ORIENT_BINS,
    N_WORDS,
    PATCH_RADIUS,
    PATTERN,
    ROT_PATTERNS,
    ROT_RADIUS,
)

RUN_ALIGN = 16  # orientation-run alignment: K5's block of rows

def _selection_index(pattern: np.ndarray, radius: int) -> np.ndarray:
    """Flat index into a (2r+1)^2 patch of each of the 2*N_BITS pattern
    samples: the row each column of the reference's one-hot selection
    matrix `_selection_matrix` picks."""
    side = 2 * radius + 1
    offs = pattern.reshape(-1, 2).astype(np.int64)
    return (offs[:, 1] + radius) * side + (offs[:, 0] + radius)


_SEL_UPRIGHT = _selection_index(PATTERN, PATCH_RADIUS)  # (512,)
_SEL_ROT_INDEX = np.stack(
    [_selection_index(ROT_PATTERNS[b], ROT_RADIUS) for b in range(N_ORIENT_BINS)]
)  # (NB, 512)
def sel_rot(device) -> torch.Tensor:
    """The reference's `_SEL_ROT` as K5 consumes it: the dense
    (N_ORIENT_BINS, 31^2, 512) bf16 stack of one-hot selection matrices
    of the rotated patterns, built once per device."""
    return _sel_rot(str(torch.device(device)))


@functools.cache
def _sel_rot(device: str) -> torch.Tensor:
    side = 2 * ROT_RADIUS + 1
    sel = torch.zeros((N_ORIENT_BINS, side * side, 2 * N_BITS), dtype=torch.bfloat16)
    cols = torch.arange(2 * N_BITS)
    for b in range(N_ORIENT_BINS):
        sel[b, torch.as_tensor(_SEL_ROT_INDEX[b]), cols] = 1.0
    return sel.to(device)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., N_BITS) bool -> (..., N_WORDS) int64 words."""
    sh = torch.arange(32, device=bits.device, dtype=torch.int64)
    b = bits.reshape(bits.shape[:-1] + (N_WORDS, 32)).to(torch.int64)
    return torch.sum(b << sh, dim=-1)


def _finalize_descriptors(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., 2*N_BITS) selected samples -> packed words, zeroed where
    not valid. Tie rule: a bit is set iff the first sample is strictly
    less than the second."""
    v = vals.reshape(vals.shape[:-1] + (N_BITS, 2))
    desc = _pack_bits(v[..., 0] < v[..., 1])
    return torch.where(valid[..., None], desc, torch.zeros_like(desc))


def edge_pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-replicate the last two axes of x by r on every side (any
    dtype, bf16 included)."""
    H, W = x.shape[-2:]
    ry = torch.clamp(torch.arange(-r, H + r, device=x.device), 0, H - 1)
    rx = torch.clamp(torch.arange(-r, W + r, device=x.device), 0, W - 1)
    return x[..., ry, :][..., rx]


def _quantize_bins(angles: torch.Tensor) -> torch.Tensor:
    """Orientation angles -> N_ORIENT_BINS bin indices (int64): round
    half to even of angle * nb / 2pi, modulo nb (describe.py:195)."""
    nb = N_ORIENT_BINS
    scale = torch.tensor(nb / (2.0 * math.pi), dtype=torch.float32)
    return torch.remainder(torch.round(angles * scale).to(torch.int32), nb).long()


def _moments_at_keypoints(padded: torch.Tensor, xy: torch.Tensor, r: int):
    """(B, K) disc moments (m10, m01) at round-half-up(xy), read from the
    K4 maps of the (B, Hp, Wp) batch padded by r + 1 (describe.py:443)."""
    mr = MOMENT_RADIUS
    m10m, m01m = moment_maps(padded)
    B, Hm, Wm = m10m.shape
    fl = torch.floor(xy)
    frac = xy - fl
    c = fl.to(torch.int64) + (frac >= 0.5).to(torch.int64)
    iy = torch.clamp(c[..., 1] + (r + 1 - mr), 0, Hm - 1)
    ix = torch.clamp(c[..., 0] + (r + 1 - mr), 0, Wm - 1)
    flat = iy * Wm + ix
    return (
        torch.gather(m10m.reshape(B, -1), 1, flat),
        torch.gather(m01m.reshape(B, -1), 1, flat),
    )


def _aligned_runs(keys: torch.Tensor, n_groups: int, align: int):
    """Stable sort of (B, N) integer keys into `align`-aligned contiguous
    runs, one per group; keys >= n_groups are dropped (describe.py:495).

    Returns (src (B, Kp) — source item per sorted slot, N for padding
    slots — with Kp = ceil_align(N) + align * n_groups, and astarts,
    aends (B, n_groups): each group's aligned run [astarts, aends)),
    int64 each. Stability keeps detection-score order within a run."""
    B, N = keys.shape
    dev = keys.device
    Kp = -(-N // align) * align + align * n_groups
    order, sk = stable_argsort_small_keys(keys, n_groups)
    ids = torch.arange(n_groups, dtype=sk.dtype, device=dev).expand(B, n_groups)
    starts = torch.searchsorted(sk, ids.contiguous(), side="left")
    ends = torch.searchsorted(sk, ids.contiguous(), side="right")
    padded_counts = -torch.div(-(ends - starts), align, rounding_mode="floor") * align
    aends = torch.cumsum(padded_counts, dim=1)
    astarts = aends - padded_counts
    pos = torch.arange(N, device=dev)
    skc = torch.clamp(sk, 0, n_groups - 1)
    dest = torch.where(
        sk < n_groups,
        torch.gather(astarts, 1, skc) + pos - torch.gather(starts, 1, skc),
        torch.full_like(sk, Kp),
    )
    src = torch.full((B, Kp + 1), N, dtype=torch.int64, device=dev)
    src.scatter_(1, dest, order)
    return src[:, :Kp], astarts, aends


def _backmap_words(
    words: torch.Tensor, src: torch.Tensor, K: int, force_scatter: bool = False
) -> torch.Tensor:
    """Words (B, Kp, W) in sorted slot layout -> (B, K, W) in keypoint
    order; src (B, Kp) is the keypoint per slot, >= K for padding slots
    (describe.py:614). Every keypoint occupies exactly one slot, so a
    sort of (src << sh) | slot puts keypoint k's slot at position k: the
    inverse permutation, then one row gather. Packed in int64, which
    holds any K, so the reference's 32-bit overflow branch is not
    needed; `force_scatter` takes the reference's other route (each real
    slot writes its keypoint's row) for the equivalence tests."""
    B, Kp, W = words.shape
    if force_scatter:
        out = torch.zeros((B, K + 1, W), dtype=words.dtype, device=words.device)
        idx = torch.clamp(src, max=K)[..., None].expand(B, Kp, W)
        out.scatter_(1, idx, words)
        return out[:, :K]
    sh = max(1, int(Kp - 1).bit_length())
    slots = torch.arange(Kp, dtype=torch.int64, device=words.device)
    packed, _ = torch.sort((src.long() << sh) | slots, dim=-1)
    inv = packed[:, :K] & ((1 << sh) - 1)
    return torch.gather(words, 1, inv[..., None].expand(B, K, W))


def _describe_oriented_sorted(padded, kps: Keypoints, bins, P: int) -> torch.Tensor:
    """Bins-first oriented descriptors (describe.py:531): extraction and
    selection in orientation-run order. Invalid keypoints get a run of
    their own (group nb), so the slot -> keypoint map is a permutation."""
    B, K = kps.xy.shape[:2]
    nb = N_ORIENT_BINS
    align = RUN_ALIGN
    keys = torch.where(kps.valid, bins, torch.full_like(bins, nb))
    src, _astarts, aends = _aligned_runs(keys, nb + 1, align)
    Kp = src.shape[1]
    safe = torch.clamp(src, max=K - 1)
    xy_s = torch.gather(kps.xy, 1, safe[..., None].expand(B, Kp, 2))
    xy_s = torch.where((src < K)[..., None], xy_s, torch.zeros((), device=xy_s.device))
    pb = extract_blended(padded, xy_s.contiguous(), P)
    flat = pb.reshape(B, Kp, -1)  # (B, Kp, L), orientation-run order
    # block i starts at slot align * i; its bin is the run covering it
    # (the invalid run nb and padding tail blocks clamp to a real matrix
    # inside K5; their rows are masked below)
    s_blk = (torch.arange(Kp // align, device=src.device) * align).expand(B, -1)
    ibin = torch.searchsorted(aends, s_blk.contiguous(), side="right").to(torch.int32)
    vals = binned_select_rows(flat, ibin, sel_rot(flat.device), align)
    vals = vals.reshape(B, Kp, N_BITS, 2)
    words = _pack_bits(vals[..., 0] < vals[..., 1])  # (B, Kp, W)
    desc = _backmap_words(words, src, K)
    return torch.where(kps.valid[..., None], desc, torch.zeros_like(desc))


def _binned_select(flat: torch.Tensor, bins: torch.Tensor, valid: torch.Tensor):
    """Oriented selection dispatched by bin (describe.py:650, the bf16
    branch): (B, K, L) bf16 patch rows + (B, K) bins -> (B, K, 512)
    selected values. Each bin keeps `cap` slots in stable (score) order;
    keypoints past a full bin, and invalid ones, get zero values. The
    reference multiplies each segment by its bin's one-hot (L, 512)
    matrix, which selects exactly, so an index gather of the same
    columns is the same function (as on the upright route)."""
    B, K, L = flat.shape
    nb = N_ORIENT_BINS
    cap = min(K, max(32, -(-2 * K // (nb * 8)) * 8))
    keys = torch.where(valid, bins, torch.full_like(bins, nb))
    rows_idx, ok = segment_by_key(keys, nb, cap)  # (B, nb, cap)
    rows = torch.gather(flat, 1, rows_idx.reshape(B, nb * cap, 1).expand(B, nb * cap, L))
    cols = torch.as_tensor(_SEL_ROT_INDEX, device=flat.device)  # (nb, 512)
    cols = cols[None, :, None, :].expand(B, nb, cap, cols.shape[-1])
    out = torch.gather(rows.reshape(B, nb, cap, L), 3, cols)  # (B, nb, cap, 512)
    vals = torch.zeros((B, K + 1, out.shape[-1]), dtype=flat.dtype, device=flat.device)
    dest = torch.where(ok, rows_idx, torch.full_like(rows_idx, K)).reshape(B, nb * cap)
    vals.scatter_(1, dest[..., None].expand(B, nb * cap, out.shape[-1]),
                  out.reshape(B, nb * cap, -1))
    return vals[:, :K]


def describe_keypoints_batch(
    frames: torch.Tensor,
    kps: Keypoints,
    blur_sigma: float = 2.0,
    smooth: torch.Tensor | None = None,
    oriented: bool = False,
) -> torch.Tensor:
    """(B, K, N_WORDS) descriptors of a (B, H, W) batch.

    `smooth` optionally supplies the blur_sigma-blurred batch (K1's
    free-ride output) so the blur is not recomputed. `oriented` takes
    the small-K route below BINS_FIRST_MIN_K keypoints, the bins-first
    route from there on."""
    B, K = kps.xy.shape[:2]
    r = ROT_RADIUS if oriented else PATCH_RADIUS
    P = 2 * r + 2
    if smooth is None:
        smooth = gaussian_blur(frames, blur_sigma)
    # finite-pixel mean off before the bf16 cast (describe.py:362-387):
    # large DC backgrounds would otherwise eat the bf16 mantissa
    finite = torch.isfinite(smooth)
    n_fin = torch.clamp(finite.sum(dim=(1, 2), keepdim=True), min=1)
    mu = torch.where(finite, smooth, torch.zeros((), device=smooth.device)).sum(
        dim=(1, 2), keepdim=True
    ) / n_fin
    padded = edge_pad((smooth - mu).to(torch.bfloat16), r + 1).contiguous()
    if oriented and K >= BINS_FIRST_MIN_K:
        m10, m01 = _moments_at_keypoints(padded, kps.xy, r)
        bins = _quantize_bins(torch.atan2(m01, m10))
        return _describe_oriented_sorted(padded, kps, bins, P)
    if oriented:
        pb, m10, m01 = extract_blended(padded, kps.xy.contiguous(), P, with_moments=True)
        bins = _quantize_bins(torch.atan2(m01, m10))
        vals = _binned_select(pb.reshape(B, K, -1), bins, kps.valid)
        return _finalize_descriptors(vals, kps.valid)
    pb = extract_blended(padded, kps.xy.contiguous(), P)
    sel = torch.as_tensor(_SEL_UPRIGHT, device=pb.device)
    vals = pb.reshape(B, K, -1)[..., sel]
    return _finalize_descriptors(vals, kps.valid)


def describe_keypoints(
    img: torch.Tensor,
    kps: Keypoints,
    blur_sigma: float = 2.0,
    smooth: torch.Tensor | None = None,
    oriented: bool = False,
) -> torch.Tensor:
    """(K, N_WORDS) descriptors of one (H, W) frame (the batched route on
    a batch of one)."""
    kb = Keypoints(*(t[None] for t in kps))
    return describe_keypoints_batch(
        img[None], kb, blur_sigma=blur_sigma,
        smooth=None if smooth is None else smooth[None], oriented=oriented,
    )[0]
