"""Pure-NumPy kernels of the reference registration.

A frozen copy of the 2D parts of `kcmc_tpu_torch/backends/_np_kernels.py`
(the program's host oracle, itself a copy of the JAX package's): Harris
response, BRIEF descriptors, Hamming matching, weighted solvers, RANSAC
and the gather warps, with its imports made local. One change: the
Hamming distances come from one float32 product of the 0/1 bits
(`_hamming`), exact and far faster than the popcount of the XOR at
4096 keypoints; tests/test_kcmc_bench_reference.py holds the two equal.
"""

from __future__ import annotations

import functools

import numpy as np

from kcmc_bench.reference.patterns import (
    CAND_TILE,
    MOMENT_RADIUS as _MOMENT_RADIUS,
    MOMENTS as _MOMENTS,
    N_BITS,
    N_ORIENT_BINS,
    N_WORDS,
    PATCH_RADIUS,
    PATTERN,
    PATTERN_3D,
    ROT_PATTERNS,
    WINDOW_SIGMA,
)

# ---------------------------------------------------------------------------
# bfloat16 rounding (the descriptor precision)
# ---------------------------------------------------------------------------


def bf16_round(x) -> np.ndarray:
    """float32 -> bfloat16 -> float32 on the bit pattern: round to
    nearest, ties to even, on the upper 16 bits (subnormals rounded, not
    flushed; overflow to +-Inf), NaN to the sign's quiet NaN — bit for
    bit what `x.astype(ml_dtypes.bfloat16).astype(np.float32)` gives."""
    x = np.asarray(x, np.float32)
    u = x.view(np.uint32)
    rounded = (u + (np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))) & np.uint32(
        0xFFFF0000
    )
    quiet = (u & np.uint32(0x80000000)) | np.uint32(0x7FC00000)
    return np.where(np.isnan(x), quiet, rounded).astype(np.uint32).view(np.float32)


# ---------------------------------------------------------------------------
# the polish family's region layout (kcmc_tpu/ops/polish.py:48-97, numpy)
# ---------------------------------------------------------------------------


def region_window(sh: int, sw: int, window_frac: float, ring: bool = True) -> np.ndarray:
    """Flattened, normalized center-weighted Gaussian window of an
    (sh, sw) region in float64; with `ring` the outer 1-px ring is
    zeroed (the index-shifted measurement's exactness condition)."""
    yy = (np.arange(sh, dtype=np.float64) - (sh - 1) / 2) / (window_frac * sh)
    xx = (np.arange(sw, dtype=np.float64) - (sw - 1) / 2) / (window_frac * sw)
    w2 = np.exp(-0.5 * (yy[:, None] ** 2 + xx[None, :] ** 2))
    if ring and sh > 2 and sw > 2:
        mask = np.zeros((sh, sw))
        mask[1:-1, 1:-1] = 1.0
        w2 = w2 * mask
    return (w2 / w2.sum()).reshape(-1)


def region_patches(x: np.ndarray, grid: tuple[int, int]) -> np.ndarray:
    """(..., H, W) -> (..., gh, gw, sh*sw): crop to whole regions and
    flatten each region's pixels."""
    gh, gw = grid
    H, W = x.shape[-2], x.shape[-1]
    sh, sw = H // gh, W // gw
    p = x[..., : gh * sh, : gw * sw].reshape(x.shape[:-2] + (gh, sh, gw, sw))
    return p.swapaxes(-3, -2).reshape(x.shape[:-2] + (gh, gw, sh * sw))


# ---------------------------------------------------------------------------
# the scale pyramid's constants (kcmc_tpu/ops/pyramid.py:48-107, :160)
# ---------------------------------------------------------------------------


def octave_sizes(shape: tuple, n_octaves: int, scale: float) -> list[tuple[int, int]]:
    """Per-octave (H_o, W_o), octave 0 = full size; rounded up to
    multiples of 8, floored at 32 px."""
    H, W = int(shape[0]), int(shape[1])
    out = []
    for o in range(n_octaves):
        f = scale**o
        ho = max(32, -(-int(round(H / f)) // 8) * 8)
        wo = max(32, -(-int(round(W / f)) // 8) * 8)
        out.append((min(ho, H), min(wo, W)))
    return out


def per_octave_k(max_keypoints: int, n_octaves: int) -> list[int]:
    """Fixed K per octave: an even split rounded up to 8."""
    k = max(8, -(-max_keypoints // (n_octaves * 8)) * 8)
    return [k] * n_octaves


@functools.lru_cache(maxsize=64)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) antialiased-linear (triangle) resampling matrix in
    the pixel-center convention, built in float64 and cast; each
    interior row is projected onto {sum = 1, centroid = center} so the
    resize has no phase bias (clipped border rows keep the edge clamp)."""
    s = n_in / n_out
    w = max(s, 1.0)
    centers = (np.arange(n_out, dtype=np.float64) + 0.5) * s - 0.5
    x = np.arange(n_in, dtype=np.float64)
    d = np.abs(x[None, :] - centers[:, None]) / w
    k = np.clip(1.0 - d, 0.0, None)
    k /= k.sum(axis=1, keepdims=True)
    for i in range(n_out):
        c = centers[i]
        row = k[i]
        m = float(row @ (x - c))
        v = float(row @ (x - c) ** 2)
        if v > 1e-8 and abs(m) < 0.45 * w:
            g = np.stack([row, row * (x - c)])
            A = np.array([[g[0].sum(), g[1].sum()],
                          [g[0] @ (x - c), g[1] @ (x - c)]])
            rhs = np.array([1.0 - row.sum(), -m])
            try:
                ab = np.linalg.solve(A, rhs)
                k[i] = row + ab[0] * g[0] + ab[1] * g[1]
            except np.linalg.LinAlgError:
                pass
    return k.astype(np.float32)


# ---------------------------------------------------------------------------
# image ops
# ---------------------------------------------------------------------------


def conv2d_same(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Same-padded 2D correlation (matches lax.conv's flip-free semantics
    for the symmetric kernels we use)."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    padded = np.pad(img, ((ph, kh - 1 - ph), (pw, kw - 1 - pw)))
    win = np.lib.stride_tricks.sliding_window_view(padded, (kh, kw))
    return np.einsum("ijkl,kl->ij", win, kernel, optimize=True).astype(np.float32)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    img = conv2d_same(img, k[None, :])
    img = conv2d_same(img, k[:, None])
    return img


_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float32) / 8.0
_SOBEL_Y = _SOBEL_X.T


def harris_response(img: np.ndarray, k: float = 0.04, window_sigma: float = WINDOW_SIGMA) -> np.ndarray:
    gx = conv2d_same(img, _SOBEL_X)
    gy = conv2d_same(img, _SOBEL_Y)
    ixx = gaussian_blur(gx * gx, window_sigma)
    iyy = gaussian_blur(gy * gy, window_sigma)
    ixy = gaussian_blur(gx * gy, window_sigma)
    det = ixx * iyy - ixy * ixy
    trace = ixx + iyy
    return det - k * trace * trace


def detect_keypoints(
    img: np.ndarray,
    max_keypoints: int = 512,
    threshold: float = 1e-4,
    nms_size: int = 5,
    border: int = 16,
    harris_k: float = 0.04,
    window_sigma: float = WINDOW_SIGMA,
    cand_tile: int = CAND_TILE,
):
    """Returns (xy (K,2), score (K,), valid (K,)) with K = max_keypoints."""
    H, W = img.shape
    resp = harris_response(img, k=harris_k, window_sigma=window_sigma)
    r = nms_size // 2
    padded = np.pad(resp, r, constant_values=-np.inf)
    win = np.lib.stride_tricks.sliding_window_view(padded, (nms_size, nms_size))
    local_max = win.max(axis=(2, 3))
    is_max = resp >= local_max
    ys, xs = np.mgrid[0:H, 0:W]
    inb = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    # Peak over the selectable region only — mirrors ops/detect.py's
    # border-excluded peak (background offsets spike the border ring).
    sel = np.where(is_max & inb, resp, -np.inf)
    peak = max(sel.max(), 1e-12)
    cand = is_max & inb & (resp > threshold * peak)
    masked = np.where(cand, resp, -np.inf)
    # Tile-bucketed candidate reduction — same rule as ops/detect.py
    # (strongest surviving pixel per tile, then global top-k), so the
    # two backends select the same keypoint set.
    T = cand_tile
    Hp, Wp = -(-H // T) * T, -(-W // T) * T
    m = np.full((Hp, Wp), -np.inf, np.float32)
    m[:H, :W] = masked
    tiles = m.reshape(Hp // T, T, Wp // T, T).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(Hp // T, Wp // T, T * T)
    tile_val = tiles.max(-1)
    tile_arg = tiles.argmax(-1)
    k = min(max_keypoints, tile_val.size)
    order = np.argsort(-tile_val.ravel(), kind="stable")[:k]
    scores = tile_val.ravel()[order]
    if k < max_keypoints:
        pad = max_keypoints - k
        scores = np.concatenate([scores, np.full(pad, -np.inf, np.float32)])
        order = np.concatenate([order, np.zeros(pad, order.dtype)])
    valid = np.isfinite(scores)
    within = tile_arg.ravel()[order]
    tw = tile_val.shape[1]
    iy = (order // tw) * T + within // T
    ix = (order % tw) * T + within % T
    iy = np.clip(iy, 0, H - 1)
    ix = np.clip(ix, 0, W - 1)

    # quadratic subpixel refinement (same formula as ops/detect.py)
    xy = np.stack([ix, iy], axis=-1).astype(np.float32)
    cy = np.clip(iy, 1, H - 2)
    cx = np.clip(ix, 1, W - 2)
    c = resp[cy, cx]
    dx = 0.5 * (resp[cy, cx + 1] - resp[cy, cx - 1])
    dy = 0.5 * (resp[cy + 1, cx] - resp[cy - 1, cx])
    dxx = resp[cy, cx + 1] - 2 * c + resp[cy, cx - 1]
    dyy = resp[cy + 1, cx] - 2 * c + resp[cy - 1, cx]
    with np.errstate(divide="ignore", invalid="ignore"):
        ox = np.where(np.abs(dxx) > 1e-8, -dx / dxx, 0.0)
        oy = np.where(np.abs(dyy) > 1e-8, -dy / dyy, 0.0)
    off = np.clip(np.stack([ox, oy], -1), -0.5, 0.5)
    xy = np.where(valid[:, None], xy + off, 0.0).astype(np.float32)
    scores = np.where(valid, scores, 0.0).astype(np.float32)
    return xy, scores, valid


def bilinear_sample(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Edge-clamped bilinear sampling (interior only — callers keep pts inside)."""
    H, W = img.shape
    x = np.clip(x, 0.0, W - 1.0)
    y = np.clip(y, 0.0, H - 1.0)
    x0 = np.floor(x).astype(np.int32)
    y0 = np.floor(y).astype(np.int32)
    fx = x - x0
    fy = y - y0
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x1] * fx * (1 - fy)
        + img[y1, x0] * (1 - fx) * fy
        + img[y1, x1] * fx * fy
    ).astype(np.float32)


def describe_keypoints(
    img: np.ndarray, xy: np.ndarray, valid: np.ndarray, oriented: bool, blur_sigma: float = 2.0
) -> np.ndarray:
    smooth = gaussian_blur(img, blur_sigma)
    # pixels at descriptor precision — mirror of the jax paths' round-5
    # bf16 quantization point incl. the per-frame mean removal
    # (ops/describe.py: large DC backgrounds would otherwise exceed
    # bf16's relative step and wipe the content)
    fin = np.isfinite(smooth)
    mu = np.float32(smooth[fin].mean()) if fin.any() else np.float32(0.0)
    smooth = bf16_round((smooth - mu).astype(np.float32))
    K = xy.shape[0]
    if oriented:
        r = _MOMENT_RADIUS
        H, W = img.shape
        cx = np.clip(np.round(xy[:, 0]).astype(np.int32), r, W - r - 1)
        cy = np.clip(np.round(xy[:, 1]).astype(np.int32), r, H - r - 1)
        angles = np.empty(K, np.float32)
        moms = _MOMENTS
        for i in range(K):
            patch = smooth[cy[i] - r : cy[i] + r + 1, cx[i] - r : cx[i] + r + 1]
            w = patch * moms[..., 2]
            angles[i] = np.arctan2((w * moms[..., 1]).sum(), (w * moms[..., 0]).sum())
        # Quantized orientation bins with precomputed rotated integer
        # patterns — same definition as ops/describe.py (ORB-style).
        nb = N_ORIENT_BINS
        bins = np.mod(np.rint(angles * (nb / (2.0 * np.pi))).astype(np.int64), nb)
        offs = ROT_PATTERNS[bins]  # (K, N_BITS, 2, 2)
    else:
        offs = np.broadcast_to(PATTERN[None], (K,) + PATTERN.shape)
    pos = xy[:, None, None, :] + offs  # (K,B,2,2)
    vals = bilinear_sample(smooth, pos[..., 0], pos[..., 1])
    # Descriptor values are bf16-quantized framework-wide (round 5 —
    # the jax paths' bandwidth precision; see ops/describe.py): the
    # oracle quantizes at the same point so comparison ties fall the
    # same way.
    vals = bf16_round(vals)
    bits = (vals[..., 0] < vals[..., 1]).astype(np.uint32)  # (K, B)
    b = bits.reshape(K, N_WORDS, 32)
    desc = (b << np.arange(32, dtype=np.uint32)[None, None, :]).sum(-1).astype(np.uint32)
    desc[~valid] = 0
    return desc


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------

def _bits(desc: np.ndarray) -> np.ndarray:
    """(K, N_WORDS) uint32 words -> (K, N_BITS) float32 0/1 bits."""
    shifts = np.arange(32, dtype=np.uint32)
    return ((desc[..., None] >> shifts) & np.uint32(1)).reshape(len(desc), -1).astype(np.float32)


def _hamming(q_desc: np.ndarray, r_desc: np.ndarray) -> np.ndarray:
    """(Kq, Kr) int64 Hamming distances: |a| + |b| - 2 a.b on 0/1 bits,
    one float32 product (exact: every sum is an integer of at most
    N_BITS). The same numbers as the popcount of the XOR, in a fraction
    of its time at K = 4096."""
    bq, br = _bits(q_desc), _bits(r_desc)
    dot = bq @ br.T
    return (bq.sum(1)[:, None] + br.sum(1)[None, :] - 2.0 * dot).round().astype(np.int64)


def knn_match(
    q_desc, r_desc, q_valid, r_valid, ratio=0.85, max_dist=80, mutual=True
):
    """Same rules as ops/match.py; returns (idx, dist, second, valid)."""
    BIG = (1 << 16) - 1  # matches ops/match.py _BIG (uint16-compatible sentinel)
    # Zero descriptors are the invalid sentinel — same rule as
    # ops/match.py's knn_match (flat patches / masked slots never match).
    q_valid = q_valid & (q_desc != 0).any(-1)
    r_valid = r_valid & (r_desc != 0).any(-1)
    D = _hamming(q_desc, r_desc)
    mask = q_valid[:, None] & r_valid[None, :]
    D = np.where(mask, D, BIG)
    part = np.argpartition(D, 1, axis=1)[:, :2]
    d2 = np.take_along_axis(D, part, axis=1)
    swap = d2[:, 0] > d2[:, 1]
    part[swap] = part[swap][:, ::-1]
    d2[swap] = d2[swap][:, ::-1]
    idx, best, second = part[:, 0], d2[:, 0], d2[:, 1]
    ok = (best < max_dist) & (best < ratio * second)
    if mutual:
        rev = np.argmin(D, axis=0)
        ok &= rev[idx] == np.arange(D.shape[0])
    ok &= q_valid & (best <= N_BITS)
    return idx.astype(np.int32), best, second, ok


# ---------------------------------------------------------------------------
# solvers (mirror kcmc_tpu/models/transforms.py in float64 for stability)
# ---------------------------------------------------------------------------


def _wmean(x, w):
    return (x * w[:, None]).sum(0) / max(w.sum(), 1e-8)


def apply_np(M, pts):
    d = pts.shape[-1]
    lin = pts @ M[:d, :d].T + M[:d, d]
    w = pts @ M[d, :d] + M[d, d]
    w = np.where(np.abs(w) < 1e-8, np.where(w < 0, -1e-8, 1e-8), w)
    return lin / w[..., None]


def solve_translation(src, dst, w):
    if w.sum() < 1e-3:
        return np.eye(3, dtype=np.float32)
    M = np.eye(3, dtype=np.float32)
    M[:2, 2] = _wmean(dst - src, w)
    return M


def solve_rigid(src, dst, w):
    if w.sum() < 1e-3:
        return np.eye(3, dtype=np.float32)
    cs, cd = _wmean(src, w), _wmean(dst, w)
    s, d = src - cs, dst - cd
    a = (w * (s[:, 0] * d[:, 0] + s[:, 1] * d[:, 1])).sum()
    b = (w * (s[:, 0] * d[:, 1] - s[:, 1] * d[:, 0])).sum()
    n = np.hypot(a, b)
    if n < 1e-6:
        return np.eye(3, dtype=np.float32)
    c, sn = a / n, b / n
    R = np.array([[c, -sn], [sn, c]], dtype=np.float64)
    t = cd - R @ cs
    M = np.eye(3, dtype=np.float32)
    M[:2, :2] = R
    M[:2, 2] = t
    return M


def solve_similarity(src, dst, w):
    """Weighted 2D similarity (Umeyama) — mirror of
    models/transforms.solve_similarity."""
    if w.sum() < 1e-3:
        return np.eye(3, dtype=np.float32)
    cs, cd = _wmean(src, w), _wmean(dst, w)
    s, d = src - cs, dst - cd
    a = (w * (s[:, 0] * d[:, 0] + s[:, 1] * d[:, 1])).sum()
    b = (w * (s[:, 0] * d[:, 1] - s[:, 1] * d[:, 0])).sum()
    var_s = max((w * (s[:, 0] ** 2 + s[:, 1] ** 2)).sum(), 1e-8)
    n = np.hypot(a, b)
    if n < 1e-6:
        return np.eye(3, dtype=np.float32)
    scale = n / var_s
    c, sn = a / n, b / n
    R = scale * np.array([[c, -sn], [sn, c]], dtype=np.float64)
    t = cd - R @ cs
    M = np.eye(3, dtype=np.float32)
    M[:2, :2] = R
    M[:2, 2] = t
    return M


def _norm_T(pts, w):
    c = _wmean(pts, w)
    rms = np.sqrt(max(_wmean(((pts - c) ** 2).sum(-1, keepdims=True), w)[0], 1e-16))
    s = np.sqrt(pts.shape[1]) / rms
    T = np.eye(pts.shape[1] + 1)
    T[:-1, :-1] *= s
    T[:-1, -1] = -s * c
    Ti = np.eye(pts.shape[1] + 1)
    Ti[:-1, :-1] /= s
    Ti[:-1, -1] = c
    return T, Ti


def solve_affine(src, dst, w):
    if w.sum() < 1e-3:
        return np.eye(3, dtype=np.float32)
    src = src.astype(np.float64)
    dst = dst.astype(np.float64)
    Ts, _ = _norm_T(src, w)
    Td, Tdi = _norm_T(dst, w)
    sn = apply_np(Ts, src)
    dn = apply_np(Td, dst)
    A = np.concatenate([sn, np.ones((len(sn), 1))], axis=1)
    Aw = A * w[:, None]
    M33 = A.T @ Aw + 1e-8 * np.eye(3)
    P = np.linalg.solve(M33, Aw.T @ dn).T
    Mn = np.eye(3)
    Mn[:2, :] = P
    M = Tdi @ Mn @ Ts
    return (M / M[2, 2]).astype(np.float32)


def solve_homography(src, dst, w):
    if w.sum() < 1e-3:
        return np.eye(3, dtype=np.float32)
    src = src.astype(np.float64)
    dst = dst.astype(np.float64)
    Ts, _ = _norm_T(src, w)
    Td, Tdi = _norm_T(dst, w)
    sn = apply_np(Ts, src)
    dn = apply_np(Td, dst)
    x, y = sn[:, 0], sn[:, 1]
    u, v = dn[:, 0], dn[:, 1]
    z = np.zeros_like(x)
    o = np.ones_like(x)
    r1 = np.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1)
    r2 = np.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    rows = np.concatenate([r1, r2], 0)
    rw = np.concatenate([w, w], 0)
    ATA = rows.T @ (rows * rw[:, None])
    _, vecs = np.linalg.eigh(ATA)
    Hn = vecs[:, 0].reshape(3, 3)
    Hm = Tdi @ Hn @ Ts
    Hm /= np.linalg.norm(Hm)
    if Hm[2, 2] < 0:
        Hm = -Hm
    if abs(Hm[2, 2]) > 1e-6:
        Hm = Hm / Hm[2, 2]
    if not np.isfinite(Hm).all():
        return np.eye(3, dtype=np.float32)
    return Hm.astype(np.float32)


def solve_rigid3d(src, dst, w):
    if w.sum() < 1e-3:
        return np.eye(4, dtype=np.float32)
    src = src.astype(np.float64)
    dst = dst.astype(np.float64)
    cs, cd = _wmean(src, w), _wmean(dst, w)
    Hm = ((src - cs) * w[:, None]).T @ (dst - cd)
    U, _, Vt = np.linalg.svd(Hm)
    D = np.diag([1.0, 1.0, np.linalg.det(Vt.T @ U.T)])
    R = Vt.T @ D @ U.T
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = cd - R @ cs
    return M.astype(np.float32)


SOLVERS = {
    "translation": (solve_translation, 1, 2),
    "rigid": (solve_rigid, 2, 2),
    "similarity": (solve_similarity, 2, 2),
    "affine": (solve_affine, 3, 2),
    "homography": (solve_homography, 4, 2),
    "rigid3d": (solve_rigid3d, 3, 3),
}


# ---------------------------------------------------------------------------
# RANSAC
# ---------------------------------------------------------------------------


def ransac_estimate(
    model_name: str,
    src: np.ndarray,
    dst: np.ndarray,
    valid: np.ndarray,
    rng: np.random.Generator,
    n_hypotheses: int = 128,
    threshold: float = 2.0,
    refine_iters: int = 2,
):
    """Same structure as ops/ransac.py (fixed H, argmax consensus, IRLS)."""
    solve, m, d = SOLVERS[model_name]
    eye = np.eye(d + 1, dtype=np.float32)
    idx_valid = np.flatnonzero(valid)
    thr2 = threshold * threshold
    if len(idx_valid) < m:
        return eye, 0, np.zeros(len(src), bool), 0.0

    best_M, best_n = eye, -1
    for _ in range(n_hypotheses):
        pick = rng.choice(idx_valid, size=m, replace=False)
        w = np.zeros(len(src), np.float32)
        w[pick] = 1.0
        M = solve(src, dst, w)
        r = ((apply_np(M, src) - dst) ** 2).sum(-1)
        n = int(((r < thr2) & valid).sum())
        if n > best_n:
            best_M, best_n = M, n

    M, n_in = best_M, best_n
    for _ in range(refine_iters):
        r = ((apply_np(M, src) - dst) ** 2).sum(-1)
        w = ((r < thr2) & valid).astype(np.float32)
        M2 = solve(src, dst, w)
        r2 = ((apply_np(M2, src) - dst) ** 2).sum(-1)
        n2 = int(((r2 < thr2) & valid).sum())
        if n2 >= n_in:
            M, n_in = M2, n2

    # Final polish on the consensus set, bounded rollback — mirrors
    # ops/ransac.py (this backend's f64 solvers are already the
    # "accurate" variant for every model).
    r = ((apply_np(M, src) - dst) ** 2).sum(-1)
    wf = ((r < thr2) & valid).astype(np.float32)
    nf = int(wf.sum())
    Mp = solve(src, dst, wf)
    rp = ((apply_np(Mp, src) - dst) ** 2).sum(-1)
    np_ = int(((rp < thr2) & valid).sum())
    if np_ >= max(m, int(np.ceil(0.8 * nf))):
        M = Mp

    r = ((apply_np(M, src) - dst) ** 2).sum(-1)
    inl = (r < thr2) & valid
    n = int(inl.sum())
    rms = float(np.sqrt(r[inl].mean())) if n else 0.0
    return M, n, inl, rms


# ---------------------------------------------------------------------------
# warping
# ---------------------------------------------------------------------------


def warp_frame(frame: np.ndarray, M: np.ndarray) -> np.ndarray:
    H, W = frame.shape
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32), indexing="ij")
    w = M[2, 0] * xs + M[2, 1] * ys + M[2, 2]
    w = np.where(np.abs(w) < 1e-8, 1e-8, w)
    sx = (M[0, 0] * xs + M[0, 1] * ys + M[0, 2]) / w
    sy = (M[1, 0] * xs + M[1, 1] * ys + M[1, 2]) / w
    out = bilinear_sample(frame, sx, sy)
    inb = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    return (out * inb).astype(np.float32)


def warp_frame_flow(frame: np.ndarray, flow: np.ndarray) -> np.ndarray:
    H, W = frame.shape
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32), indexing="ij")
    sx = xs + flow[..., 0]
    sy = ys + flow[..., 1]
    out = bilinear_sample(frame, sx, sy)
    inb = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    return (out * inb).astype(np.float32)
