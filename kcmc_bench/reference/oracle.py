"""The reference registration of one frame (numpy only).

Follows `kcmc_tpu_torch/backends/numpy_backend.py` (the program's host
oracle, a copy of the JAX package's NumPy backend) for the 2D
single-scale models: detect and describe, Hamming matching, RANSAC
consensus (matrix models) or the per-patch field estimate (piecewise),
the gather warp and the photometric polish. Its own copy of every
step; it imports nothing of the program.

`lowp=True` is the control of the correctness check: the same
registration with every array it stores (frames, keypoint coordinates,
transforms, fields, warped frames) rounded to bfloat16, the precision
below the configuration's float32, as a program that kept them in
bfloat16 would. The arithmetic between stores stays float32 or float64.
"""

from __future__ import annotations

import numpy as np

from kcmc_bench.reference import np_kernels as K
from kcmc_bench.gen import upsample_field


class Settings:
    """The algorithm settings of a configuration file's `settings` block
    as attributes (the names of the program's CorrectorConfig)."""

    def __init__(self, settings: dict):
        self.__dict__.update(settings)
        self.patch_grid = tuple(self.patch_grid)
        self.polish_grid = tuple(self.polish_grid)

    def resolved_oriented(self) -> bool:
        if self.oriented is None:
            return self.model not in ("translation", "piecewise")
        return bool(self.oriented)


def _store(x, lowp: bool):
    """An array as the registration stores it: float32, or bfloat16
    rounded to nearest even in the control."""
    x = np.asarray(x, np.float32)
    return K.bf16_round(x) if lowp else x


def detect_describe(frame: np.ndarray, cfg: Settings, lowp: bool = False):
    """(xy (K, 2), valid (K,), desc (K, 8) uint32) of one frame."""
    xy, _score, valid = K.detect_keypoints(
        frame, max_keypoints=cfg.max_keypoints, threshold=cfg.detect_threshold,
        nms_size=cfg.nms_size, border=cfg.border, harris_k=cfg.harris_k,
        window_sigma=cfg.harris_window_sigma, cand_tile=cfg.cand_tile,
    )
    xy = _store(xy, lowp)
    desc = K.describe_keypoints(frame, xy, valid, oriented=cfg.resolved_oriented(),
                                blur_sigma=cfg.blur_sigma)
    return xy, valid, desc


def prepare_reference(ref_frame: np.ndarray, cfg: Settings, lowp: bool = False) -> dict:
    frame = _store(ref_frame, lowp)
    xy, valid, desc = detect_describe(frame, cfg, lowp)
    return {"xy": xy, "valid": valid, "desc": desc, "frame": frame}


def register(frame: np.ndarray, gidx: int, ref: dict, cfg: Settings,
             lowp: bool = False) -> dict:
    """{"transform" (3, 3) or "field" (gh, gw, 2), "corrected" (H, W),
    "n_matches", "n_inliers"} of the frame with global index `gidx`.
    RANSAC draws from a Philox stream seeded by (cfg.seed, gidx), as the
    program's host oracle does."""
    frame = _store(frame, lowp)
    xy, valid, desc = detect_describe(frame, cfg, lowp)
    idx, _dist, _second, ok = K.knn_match(
        desc, ref["desc"], valid, ref["valid"], ratio=cfg.ratio,
        max_dist=cfg.max_hamming, mutual=cfg.mutual,
    )
    src, dst = ref["xy"][idx], xy
    rng = np.random.default_rng([cfg.seed, gidx])
    out = {"n_matches": int(ok.sum())}
    if cfg.model == "piecewise":
        field, n_in = estimate_field(src, dst, ok, rng, frame.shape, cfg)
        field = _store(field, lowp)
        corrected = _store(K.warp_frame_flow(frame, upsample_field(field, frame.shape)), lowp)
        for _ in range(int(cfg.field_polish)):
            field = _store(field + corr_polish(corrected, ref["frame"], cfg.patch_grid), lowp)
            corrected = _store(
                K.warp_frame_flow(frame, upsample_field(field, frame.shape)), lowp)
        out.update(field=field, corrected=corrected, n_inliers=int(n_in))
        return out
    M, n_in, _inl, _rms = K.ransac_estimate(
        cfg.model, src, dst, ok, rng, n_hypotheses=cfg.n_hypotheses,
        threshold=cfg.inlier_threshold, refine_iters=cfg.refine_iters,
    )
    M = _store(M, lowp)
    corrected = _store(K.warp_frame(frame, M), lowp)
    for _ in range(int(cfg.transform_polish)):
        M = _store(polish_transform(corrected, ref["frame"], M, cfg.model, cfg.polish_grid),
                   lowp)
        corrected = _store(K.warp_frame(frame, M), lowp)
    out.update(transform=M, corrected=corrected, n_inliers=int(n_in))
    return out


# ---------------------------------------------------------------------------
# the photometric polish (numpy_backend.py's _measure_shifts_np,
# _corr_polish_np, _polish_transform_np, _coverage_mask_np)
# ---------------------------------------------------------------------------


def coverage_mask(shape, M: np.ndarray) -> np.ndarray:
    """In-bounds source-sample mask of the 2D matrix warp."""
    H, W = shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    w = M[2, 0] * xs + M[2, 1] * ys + M[2, 2]
    w = np.where(np.abs(w) < 1e-8, 1e-8, w)
    sx = (M[0, 0] * xs + M[0, 1] * ys + M[0, 2]) / w
    sy = (M[1, 0] * xs + M[1, 1] * ys + M[1, 2]) / w
    return (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)


def measure_shifts(corrected: np.ndarray, template: np.ndarray, grid, exact: bool = False):
    """(d (gh, gw, 2), significant (gh, gw)): per-region residual shifts
    of one warped frame against the template, by the centre-weighted
    two-way cross-correlation at the 3x3 integer shifts and a separable
    quadratic peak fit, clamped to +-1 px. `exact`: the per-region
    estimator of the field polish; else the index-shifted ring-window
    form of the matrix polish."""
    H, W = corrected.shape
    gh, gw = grid
    sh, sw = H // gh, W // gw
    window_frac = 0.25

    def patches(x):
        return K.region_patches(x, grid)

    if exact:
        w = K.region_window(sh, sw, window_frac, ring=False).astype(np.float64)

        def zero_mean(p):
            return p - np.sum(w * p, axis=-1, keepdims=True)

        C = zero_mean(patches(corrected))
        T0 = zero_mean(patches(template))
        tpad = np.pad(template, 1, mode="edge")
        cpad = np.pad(corrected, 1, mode="edge")

        def score(dy, dx):
            t = zero_mean(patches(tpad[1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W]))
            c = zero_mean(patches(cpad[1 - dy: 1 - dy + H, 1 - dx: 1 - dx + W]))
            return np.sum(w * (C * t + c * T0), axis=-1)

        s_c = score(0, 0)
        s_xm, s_xp = score(0, -1), score(0, 1)
        s_ym, s_yp = score(-1, 0), score(1, 0)
        e_c = np.sum(w * C * C, axis=-1)
        e_t = np.sum(w * T0 * T0, axis=-1)
    else:
        w = K.region_window(sh, sw, window_frac).astype(np.float64)

        def zero_mean(p):
            return p - np.sum(w * p, axis=-1, keepdims=True)

        CP = patches(corrected).astype(np.float64)
        V = w * zero_mean(CP)
        T0 = zero_mean(patches(template).astype(np.float64))
        shifts = [(0, 0), (0, -1), (0, 1), (-1, 0), (1, 0)]
        tpad = np.pad(template.astype(np.float64), 1, mode="edge")
        t0w = (w * T0).reshape(gh, gw, sh, sw)
        t0w = t0w.swapaxes(1, 2).reshape(gh * sh, gw * sw)
        t0wpad = np.pad(t0w, ((1, 1 + H - gh * sh), (1, 1 + W - gw * sw)))
        s_c, s_xm, s_xp, s_ym, s_yp = [
            np.sum(V * patches(tpad[1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W]), axis=-1)
            + np.sum(CP * patches(t0wpad[1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W]), axis=-1)
            for dy, dx in shifts
        ]
        e_c = np.sum(V * CP, axis=-1)
        e_t = np.sum(w * T0 * T0, axis=-1)
    significant = s_c > 0.2 * np.sqrt(e_c * e_t * 4.0) + 1e-12

    def subpixel(sm, sp):
        denom = sm - 2.0 * s_c + sp
        with np.errstate(divide="ignore", invalid="ignore"):
            off = np.where(denom < -1e-12, 0.5 * (sm - sp) / denom, np.sign(sp - sm))
        return np.clip(np.where(significant, off, 0.0), -1.0, 1.0)

    d = np.stack([subpixel(s_xm, s_xp), subpixel(s_ym, s_yp)], axis=-1).astype(np.float32)
    return d, significant


def corr_polish(corrected: np.ndarray, template: np.ndarray, grid) -> np.ndarray:
    """Field corrections (gh, gw, 2): the negated measured shifts."""
    d, _ = measure_shifts(corrected, template, grid, exact=True)
    return -d


def polish_transform(corrected: np.ndarray, template: np.ndarray, M: np.ndarray,
                     model_name: str, grid) -> np.ndarray:
    """One photometric polish of M: region shifts of the warped frame,
    the model's weighted fit to the region correspondences (c -> c - d,
    significant regions whose window lies in the warp's coverage), and
    M' = M @ A."""
    H, W = corrected.shape
    gh, gw = grid
    d, sig = measure_shifts(corrected, template, grid)
    cov = coverage_mask((H, W), M).astype(np.float64)
    w = K.region_window(H // gh, W // gw, 0.25)
    sig = sig & ((K.region_patches(cov, grid) * w).sum(-1) >= 0.98)
    cy = (np.arange(gh, dtype=np.float64) + 0.5) * H / gh - 0.5
    cx = (np.arange(gw, dtype=np.float64) + 0.5) * W / gw - 0.5
    centers = np.stack(np.meshgrid(cx, cy, indexing="xy"), axis=-1).reshape(-1, 2)
    wts = sig.reshape(-1).astype(np.float64)
    solve, min_samples, _d = K.SOLVERS[model_name]
    if wts.sum() < 2.0 * min_samples:
        return M
    A = solve(centers, centers - d.reshape(-1, 2), wts)
    if not np.all(np.isfinite(A)):
        return M
    return (M.astype(np.float64) @ A).astype(np.float32)


# ---------------------------------------------------------------------------
# the per-patch field estimate (numpy_backend.py's _estimate_field,
# _sample_field_at, _smooth_field)
# ---------------------------------------------------------------------------


def estimate_field(src, dst, ok, rng, shape, cfg: Settings):
    """(field (gh, gw, 2), global inliers): a global translation by
    RANSAC, per-patch fits of the inliers within reach of each cell
    centre shrunk toward it by the patch prior, smoothed, then
    `field_passes - 1` residual refinement passes."""
    gh, gw = cfg.patch_grid
    H, W = shape
    Mg, n_g, inl_g, _rms = K.ransac_estimate(
        "translation", src, dst, ok, rng,
        n_hypotheses=cfg.n_hypotheses, threshold=cfg.global_threshold,
    )
    g_t = Mg[:2, 2]
    cy = (np.arange(gh, dtype=np.float32) + 0.5) * H / gh - 0.5
    cx = (np.arange(gw, dtype=np.float32) + 0.5) * W / gw - 0.5
    reach = 1.5 * max(H / gh, W / gw)
    thr = cfg.inlier_threshold
    pmodel = cfg.patch_model

    def center_disp(Mp, c):
        return Mp[:2, :2] @ c + Mp[:2, 2] - c

    def clamp(delta, cap):
        nrm = float(np.sqrt((delta ** 2).sum()) + 1e-12)
        return delta * min(1.0, cap / nrm)

    field = np.zeros((gh, gw, 2), np.float32)
    for i in range(gh):
        for j in range(gw):
            c = np.array([cx[j], cy[i]], np.float32)
            member = inl_g & (((src - c) ** 2).sum(-1) < reach * reach)
            Mp, n_p, _, _ = K.ransac_estimate(
                pmodel, src, dst, member, rng, n_hypotheses=cfg.patch_hypotheses, threshold=thr,
            )
            disp = g_t + clamp(center_disp(Mp, c) - g_t, 2.0 * cfg.global_threshold)
            lam = n_p / (n_p + cfg.patch_prior)
            field[i, j] = lam * disp + (1 - lam) * g_t
    field = smooth_field(field, cfg.field_smooth_sigma)

    pitch = max(H / gh, W / gw)
    for it in range(cfg.field_passes - 1):
        reach_r = max(reach * cfg.refine_reach_scale ** (it + 1), 0.75 * pitch)
        pred = sample_field_at(field, src, shape)
        resid = dst - src - pred
        gate = inl_g & ((resid ** 2).sum(-1) < (2.0 * thr) ** 2)
        dst_resid = dst - pred
        r = np.zeros((gh, gw, 2), np.float32)
        for i in range(gh):
            for j in range(gw):
                c = np.array([cx[j], cy[i]], np.float32)
                member = gate & (((src - c) ** 2).sum(-1) < reach_r * reach_r)
                Mp, n_p, _, _ = K.ransac_estimate(
                    pmodel, src, dst_resid, member, rng,
                    n_hypotheses=(cfg.refine_hypotheses or cfg.patch_hypotheses), threshold=thr,
                )
                lam = n_p / (n_p + cfg.patch_prior)
                r[i, j] = lam * clamp(center_disp(Mp, c), 2.0 * thr)
        field = smooth_field(field + r, cfg.field_smooth_sigma)
    return field, n_g


def sample_field_at(field, pts, shape):
    """Bilinear samples of a cell-centred (gh, gw, 2) field at (N, 2) points."""
    gh, gw, _ = field.shape
    H, W = shape
    gx = np.clip((pts[:, 0] + 0.5) * gw / W - 0.5, 0, gw - 1)
    gy = np.clip((pts[:, 1] + 0.5) * gh / H - 0.5, 0, gh - 1)
    x0 = np.floor(gx).astype(np.int32)
    y0 = np.floor(gy).astype(np.int32)
    x1 = np.minimum(x0 + 1, gw - 1)
    y1 = np.minimum(y0 + 1, gh - 1)
    fx = (gx - x0)[:, None]
    fy = (gy - y0)[:, None]
    flat = field.reshape(-1, 2)
    return (
        flat[y0 * gw + x0] * (1 - fx) * (1 - fy)
        + flat[y0 * gw + x1] * fx * (1 - fy)
        + flat[y1 * gw + x0] * (1 - fx) * fy
        + flat[y1 * gw + x1] * fx * fy
    ).astype(np.float32)


def smooth_field(field, sigma):
    """Normalized Gaussian blur of a (gh, gw, 2) field over the grid."""
    if sigma <= 0:
        return field
    radius = max(1, int(2.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    k /= k.sum()
    ones = np.ones(field.shape[:2], np.float32)

    def blur(c):
        p = np.pad(c, radius)
        win = np.lib.stride_tricks.sliding_window_view(p, (2 * radius + 1, 2 * radius + 1))
        return np.einsum("ijkl,kl->ij", win, np.outer(k, k), optimize=True)

    num = np.stack([blur(field[..., i]) for i in range(2)], -1)
    den = blur(ones)[..., None]
    return (num / np.maximum(den, 1e-6)).astype(np.float32)
