"""Pure-NumPy host backend of the port — the parity oracle.

The port's copy of `kcmc_tpu/backends/numpy_backend.py`: the backend
protocol (`prepare_reference`, `process_batch`, `update_reference`,
`runtime_info`) over the kernels of `_np_kernels`, registered as
``"numpy"``. It is the CPU side of the judged accuracy metric
(transform-RMSE parity vs CPU): the same algorithm as the torch
backend, in code that shares none of it, so the two agree to
registration accuracy, and it gives the JAX package's NumPy backend's
bytes. Imports numpy and the port's torch-free modules only: no torch.
"""

from __future__ import annotations

import numpy as np

from kcmc_tpu_torch.backends import _np_kernels as K
from kcmc_tpu_torch.backends import register_backend
from kcmc_tpu_torch.config import CorrectorConfig
from kcmc_tpu_torch.utils.synthetic import upsample_field


def template_corr_np(
    corrected: np.ndarray, ref_frame: np.ndarray, mask: np.ndarray | None = None
) -> np.ndarray:
    """Per-frame Pearson correlation against the reference, over the
    warp-coverage mask (NumPy mirror of the torch backend's quality
    metric; also used by the corrector to refresh rescued frames)."""
    axes = tuple(range(1, corrected.ndim))
    if mask is None:
        mask = np.ones(corrected.shape, bool)
    m = mask.astype(corrected.dtype)
    n = np.maximum(m.sum(axis=axes, keepdims=True), 1.0)
    cm = (corrected * m).sum(axis=axes, keepdims=True) / n
    rm = (ref_frame * m).sum(axis=axes, keepdims=True) / n
    c = (corrected - cm) * m
    r = (ref_frame - rm) * m
    num = (c * r).sum(axis=axes)
    den = np.sqrt((c * c).sum(axis=axes) * (r * r).sum(axis=axes))
    return (num / np.maximum(den, 1e-12)).astype(np.float32)


def _coverage_mask_np(shape, M: np.ndarray) -> np.ndarray:
    """In-bounds source-sample mask of the 2D matrix warp (NumPy mirror
    of ops/warp.coverage_mask)."""
    H, W = shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    w = M[2, 0] * xs + M[2, 1] * ys + M[2, 2]
    w = np.where(np.abs(w) < 1e-8, 1e-8, w)
    sx = (M[0, 0] * xs + M[0, 1] * ys + M[0, 2]) / w
    sy = (M[1, 0] * xs + M[1, 1] * ys + M[1, 2]) / w
    return (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)


def _coverage_mask_3d_np(shape, M: np.ndarray) -> np.ndarray:
    D, H, W = shape
    zs, ys, xs = np.mgrid[0:D, 0:H, 0:W].astype(np.float32)
    sx = M[0, 0] * xs + M[0, 1] * ys + M[0, 2] * zs + M[0, 3]
    sy = M[1, 0] * xs + M[1, 1] * ys + M[1, 2] * zs + M[1, 3]
    sz = M[2, 0] * xs + M[2, 1] * ys + M[2, 2] * zs + M[2, 3]
    return (
        (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
        & (sz >= 0) & (sz <= D - 1)
    )


def coverage_masks_np(shape, out: dict) -> np.ndarray:
    """Per-frame warp-coverage masks from a batch's transform/field
    outputs (host side): (n, *shape) bool. Dispatches on the model
    family — dense flow for piecewise fields, 4x4 volumetric or 3x3
    planar matrices otherwise."""
    if "field" in out:
        masks = []
        for f in np.asarray(out["field"], np.float32):
            flow = upsample_field(f, shape)
            ys, xs = np.mgrid[0 : shape[0], 0 : shape[1]].astype(np.float32)
            sx = xs + flow[..., 0]
            sy = ys + flow[..., 1]
            masks.append(
                (sx >= 0) & (sx <= shape[1] - 1)
                & (sy >= 0) & (sy <= shape[0] - 1)
            )
        return np.stack(masks)
    Ms = np.asarray(out["transform"], np.float32)
    fn = _coverage_mask_3d_np if Ms.shape[-1] == 4 else _coverage_mask_np
    return np.stack([fn(shape, M) for M in Ms])


def _measure_shifts_np(
    corrected: np.ndarray, template: np.ndarray, grid, exact: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """NumPy mirror of ops/polish.measure_shifts (one frame):
    center-weighted two-way symmetric cross-correlation at the 3x3
    integer shifts, separable quadratic peak fit, clamped to ±1 px,
    plus the normalized-correlation significance gate. Returns
    (d (gh, gw, 2), significant (gh, gw)). `exact` mirrors the torch
    path's split: the per-region estimator (piecewise field polish)
    vs the index-shifted ring-window formulation (matrix polish)."""
    region_patches, region_window = K.region_patches, K.region_window
    H, W = corrected.shape
    gh, gw = grid
    sh, sw = H // gh, W // gw
    window_frac = 0.25

    def patches(x):
        return region_patches(x, grid)

    if exact:
        w = region_window(sh, sw, window_frac, ring=False).astype(np.float64)

        def zero_mean(p):
            return p - np.sum(w * p, axis=-1, keepdims=True)

        C = zero_mean(patches(corrected))
        T0 = zero_mean(patches(template))
        tpad = np.pad(template, 1, mode="edge")
        cpad = np.pad(corrected, 1, mode="edge")

        def score(dy, dx):
            t = zero_mean(
                patches(tpad[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W])
            )
            c = zero_mean(
                patches(cpad[1 - dy : 1 - dy + H, 1 - dx : 1 - dx + W])
            )
            return np.sum(w * (C * t + c * T0), axis=-1)

        s_c = score(0, 0)
        s_xm, s_xp = score(0, -1), score(0, 1)
        s_ym, s_yp = score(-1, 0), score(1, 0)
        e_c = np.sum(w * C * C, axis=-1)
        e_t = np.sum(w * T0 * T0, axis=-1)
    else:
        w = region_window(sh, sw, window_frac).astype(np.float64)

        def zero_mean(p):
            return p - np.sum(w * p, axis=-1, keepdims=True)

        # index-shifted two-term structure — mirror of the round-5
        # measure_shifts rewrite (template-side arrays shift; the
        # batch side is read once per term)
        CP = patches(corrected).astype(np.float64)
        V = w * zero_mean(CP)
        T0 = zero_mean(patches(template).astype(np.float64))
        shifts = [(0, 0), (0, -1), (0, 1), (-1, 0), (1, 0)]
        tpad = np.pad(template.astype(np.float64), 1, mode="edge")
        t0w = (w * T0).reshape(gh, gw, sh, sw)
        t0w = t0w.swapaxes(1, 2).reshape(gh * sh, gw * sw)
        t0wpad = np.pad(t0w, ((1, 1 + H - gh * sh), (1, 1 + W - gw * sw)))
        scores = [
            np.sum(
                V * patches(tpad[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]),
                axis=-1,
            )
            + np.sum(
                CP
                * patches(t0wpad[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]),
                axis=-1,
            )
            for dy, dx in shifts
        ]
        s_c, s_xm, s_xp, s_ym, s_yp = scores
        e_c = np.sum(V * CP, axis=-1)
        e_t = np.sum(w * T0 * T0, axis=-1)
    # significance gate — mirror of ops/polish.measure_shifts
    significant = s_c > 0.2 * np.sqrt(e_c * e_t * 4.0) + 1e-12

    def subpixel(sm, sp):
        denom = sm - 2.0 * s_c + sp
        with np.errstate(divide="ignore", invalid="ignore"):
            off = np.where(
                denom < -1e-12, 0.5 * (sm - sp) / denom, np.sign(sp - sm)
            )
        return np.clip(np.where(significant, off, 0.0), -1.0, 1.0)

    d = np.stack(
        [subpixel(s_xm, s_xp), subpixel(s_ym, s_yp)], axis=-1
    ).astype(np.float32)
    return d, significant


def _corr_polish_np(
    corrected: np.ndarray, template: np.ndarray, grid
) -> np.ndarray:
    """NumPy mirror of ops/piecewise.correlation_polish (one frame):
    the negated measured shifts, added to the displacement field."""
    d, _ = _measure_shifts_np(corrected, template, grid, exact=True)
    return -d


def _polish_transform_np(
    corrected: np.ndarray, template: np.ndarray, M: np.ndarray,
    model_name: str, grid,
) -> np.ndarray:
    """NumPy mirror of ops/polish.polish_transforms (one frame):
    measure per-region residual shifts of the warped frame against the
    template, fit the model family's weighted solver to the region
    correspondences (c -> c - d, significance-gated weights), and
    compose M' = M @ A."""
    H, W = corrected.shape
    gh, gw = grid
    d, sig = _measure_shifts_np(corrected, template, grid)
    # Coverage gate — mirror of ops/polish.polish_transforms: regions
    # whose Gaussian window sees the warp's out-of-coverage zeros
    # (>= 2% window mass) measure template content against synthetic
    # black; drop them from the fit.
    cov = _coverage_mask_np((H, W), M).astype(np.float64)
    w = K.region_window(H // gh, W // gw, 0.25)
    sig = sig & ((K.region_patches(cov, grid) * w).sum(-1) >= 0.98)
    cy = (np.arange(gh, dtype=np.float64) + 0.5) * H / gh - 0.5
    cx = (np.arange(gw, dtype=np.float64) + 0.5) * W / gw - 0.5
    centers = np.stack(np.meshgrid(cx, cy, indexing="xy"), axis=-1).reshape(-1, 2)
    wts = sig.reshape(-1).astype(np.float64)
    solve, min_samples, _d = K.SOLVERS[model_name]
    # same well-posedness margin as ops/polish.polish_transforms
    if wts.sum() < 2.0 * min_samples:
        return M
    A = solve(centers, centers - d.reshape(-1, 2), wts)
    if not np.all(np.isfinite(A)):
        return M
    return (M.astype(np.float64) @ A).astype(np.float32)


def _sanitize_nonfinite_np(frame: np.ndarray) -> np.ndarray:
    """Replace non-finite pixels with the frame's finite mean (mirror
    of the torch backend's `sanitize_input` path, for parity)."""
    finite = np.isfinite(frame)
    if finite.all():
        return frame
    mean = frame[finite].mean() if finite.any() else 0.0
    return np.where(finite, frame, np.float32(mean))


@register_backend("numpy")
class NumpyBackend:
    name = "numpy"
    # Plugin-seam version flag: batches may arrive in their native dtype
    # (uint16 etc.); _process_one casts each frame to float32.
    accepts_native_dtype = True

    def __init__(self, config: CorrectorConfig, **_options):
        if config.match_radius is not None:
            # Silently running the dense matcher here would
            # give a banded config different matcher SEMANTICS per
            # backend (candidate universe, ratio-test second-best,
            # capacity drops) with no warning — refuse instead.
            raise ValueError(
                "backend='numpy' has no banded-matching mirror; "
                "match_radius configs change matcher semantics (bounded "
                "candidate universe, bucket capacities) that the dense "
                "NumPy matcher cannot reproduce. Use backend='torch' for "
                "banded matching, or match_radius=None with the numpy "
                "oracle."
            )
        self.config = config
        # Mesh no-op mirror: the numpy oracle is single-host by nature.
        # `mesh_devices` (and an explicit mesh= option) are accepted and
        # ignored so one config runs on either backend — in particular
        # the degradation ladder's failover from a SHARDED torch run
        # lands here without a config scrub.
        self.mesh = None

    def runtime_info(self) -> dict:
        """Execution-environment description for the run manifest
        (obs/manifest.py) — the numpy oracle runs on the host CPU."""
        import platform

        info = {
            "backend": self.name,
            "numpy": np.__version__,
            "processor": platform.processor() or platform.machine(),
        }
        if self.config.mesh_devices:
            # recorded so a manifest shows the knob was set but unused
            info["mesh_devices_ignored"] = int(self.config.mesh_devices)
        if getattr(self.config, "plan_buckets", ()):
            # Execution plans amortize COMPILATION, which the numpy
            # oracle has none of — buckets are accepted and ignored
            # (like mesh_devices) so a bucketed torch config fails over
            # here without a config scrub; recorded for the manifest.
            info["plan_buckets_ignored"] = [
                list(b) for b in self.config.plan_buckets
            ]
        return info

    def _detect_describe_2d(self, frame: np.ndarray, multi_scale=True):
        """Single-scale detect+describe, or the ORB scale pyramid when
        n_octaves > 1 — the same octave sizes, resize matrices, and
        coordinate mapping as the torch backend (`_np_kernels` holds the
        numpy copies of ops/pyramid.py's constants), so cross-backend
        parity holds for multi-scale configs too."""
        cfg = self.config

        def stage(fr, k_octave, border):
            xy, score, valid = K.detect_keypoints(
                fr,
                max_keypoints=k_octave,
                threshold=cfg.detect_threshold,
                nms_size=cfg.nms_size,
                border=border,
                harris_k=cfg.harris_k,
                window_sigma=cfg.harris_window_sigma,
                cand_tile=cfg.cand_tile,
            )
            desc = K.describe_keypoints(
                fr, xy, valid,
                oriented=cfg.resolved_oriented(), blur_sigma=cfg.blur_sigma,
            )
            return xy, score, valid, desc

        if cfg.n_octaves <= 1 or not multi_scale:
            return stage(frame, cfg.max_keypoints, cfg.border)

        octave_sizes, per_octave_k, resize_matrix = (
            K.octave_sizes, K.per_octave_k, K.resize_matrix
        )
        H, W = frame.shape
        sizes = octave_sizes((H, W), cfg.n_octaves, cfg.octave_scale)
        ks = per_octave_k(cfg.max_keypoints, cfg.n_octaves)
        xs, ss, vs, ds = [], [], [], []
        for o, ((ho, wo), ko) in enumerate(zip(sizes, ks)):
            if o == 0:
                fr, sx, sy = frame, 1.0, 1.0
            else:
                rh = resize_matrix(H, ho)
                rw = resize_matrix(W, wo)
                fr = (rh @ frame @ rw.T).astype(np.float32)
                sx, sy = W / wo, H / ho
            b = min(cfg.border, min(ho, wo) // 4)
            xy, score, valid, desc = stage(fr, ko, b)
            xs.append((xy + 0.5) * np.float32([sx, sy]) - 0.5)
            ss.append(score)
            vs.append(valid)
            ds.append(desc)
        return (
            np.concatenate(xs).astype(np.float32),
            np.concatenate(ss),
            np.concatenate(vs),
            np.concatenate(ds),
        )

    def prepare_reference(self, ref_frame: np.ndarray) -> dict:
        cfg = self.config
        ref_frame = np.asarray(ref_frame, np.float32)
        if cfg.sanitize_input:
            ref_frame = _sanitize_nonfinite_np(ref_frame)
        if ref_frame.ndim == 3:
            frame = ref_frame
            xyz, score, valid = K.detect_keypoints_3d(
                frame,
                max_keypoints=cfg.max_keypoints,
                threshold=cfg.detect_threshold,
                border=min(cfg.border, min(frame.shape) // 4),
            )
            desc = K.describe_keypoints_3d(
                frame, xyz, valid, blur_sigma=cfg.blur_sigma
            )
            return {"xy": xyz, "desc": desc, "valid": valid, "frame": frame}
        xy, score, valid, desc = self._detect_describe_2d(ref_frame)
        return {"xy": xy, "desc": desc, "valid": valid, "frame": ref_frame}

    def update_reference(
        self, ref: dict, tail_corrected, tail_ok, window: int, alpha: float
    ) -> dict:
        """Host-side mirror of the torch backend's device-resident
        rolling-template seam: same signature, same frame-exact window
        semantics, and BIT-IDENTICAL blend math to the corrector's
        legacy `_rolled_template` path (np.mean over the ok-masked
        window, then the (1-alpha)/alpha blend in the same order)."""
        if not tail_corrected:
            return ref
        frames = np.concatenate(
            [np.asarray(c, np.float32) for c in tail_corrected]
        )[-window:]
        ok = np.concatenate([np.asarray(k, bool) for k in tail_ok])[-window:]
        frames = frames[ok]
        if len(frames) == 0:  # every frame out of warp bounds: keep ref
            return ref
        mean = np.mean(frames, axis=0, dtype=np.float32)
        new_frame = (1.0 - alpha) * np.asarray(
            ref["frame"], np.float32
        ) + alpha * mean
        return self.prepare_reference(new_frame)

    def process_batch(
        self, frames: np.ndarray, ref: dict, frame_indices: np.ndarray
    ) -> dict:
        cfg = self.config
        out: dict[str, list] = {k: [] for k in self._keys()}
        for frame, gidx in zip(frames, frame_indices):
            self._process_one(np.asarray(frame, np.float32), int(gidx), ref, out)
        merged = {k: np.stack(v) for k, v in out.items()}
        if (
            cfg.quality_metrics
            and "corrected" in merged
            and "frame" in ref
            and not ref.get("_skip_quality")
        ):
            masks = coverage_masks_np(merged["corrected"].shape[1:], merged)
            merged["template_corr"] = template_corr_np(
                merged["corrected"], ref["frame"], masks
            )
            merged["coverage"] = masks.mean(
                axis=tuple(range(1, masks.ndim))
            ).astype(np.float32)
        return merged

    def _keys(self):
        cfg = self.config
        base = [
            "corrected", "warp_ok", "n_keypoints", "n_matches",
            "n_inliers", "rms_residual",
        ]
        if (
            cfg.model != "piecewise"
            and cfg.n_octaves > 1
            and cfg.pyramid_refine
        ):
            base.append("coarse_n_matches")
        return base + (["field"] if cfg.model == "piecewise" else ["transform"])

    def _process_one(self, frame, gidx, ref, out):
        cfg = self.config
        if cfg.sanitize_input:
            frame = _sanitize_nonfinite_np(frame)
        if frame.ndim == 3:
            self._process_one_3d(frame, gidx, ref, out)
            return
        xy, score, valid, desc = self._detect_describe_2d(frame)
        idx, dist, second, ok = K.knn_match(
            desc,
            ref["desc"],
            valid,
            ref["valid"],
            ratio=cfg.ratio,
            max_dist=cfg.max_hamming,
            mutual=cfg.mutual,
        )
        src = ref["xy"][idx]
        dst = xy
        rng = np.random.default_rng([cfg.seed, gidx])
        out["n_keypoints"].append(np.int32(valid.sum()))
        out["n_matches"].append(np.int32(ok.sum()))
        out["warp_ok"].append(np.bool_(True))  # gather warp: unbounded

        if cfg.model == "piecewise":
            field, flow, n_in, rms = self._estimate_field(src, dst, ok, rng, frame.shape)
            corrected = K.warp_frame_flow(frame, flow)
            for _ in range(int(cfg.field_polish)):
                # photometric polish — mirror of the torch backend's
                # ops/piecewise.correlation_polish + re-warp
                field = field + _corr_polish_np(
                    corrected, ref["frame"], cfg.patch_grid
                )
                flow = upsample_field(field, frame.shape)
                corrected = K.warp_frame_flow(frame, flow)
            out["field"].append(field)
            out["corrected"].append(corrected)
            out["n_inliers"].append(np.int32(n_in))
            out["rms_residual"].append(np.float32(rms))
        else:
            M, n_in, inl, rms = K.ransac_estimate(
                cfg.model,
                src,
                dst,
                ok,
                rng,
                n_hypotheses=cfg.n_hypotheses,
                threshold=cfg.inlier_threshold,
                refine_iters=cfg.refine_iters,
            )
            if cfg.n_octaves > 1 and cfg.pyramid_refine:
                # Coarse-to-fine mirror of the torch backend: exactly
                # warp by the coarse multi-scale estimate, re-register
                # single-scale (full-resolution localization), compose
                # ref->frame as M_coarse @ M_residual.
                corrected0 = K.warp_frame(frame, M)
                xy2, _, valid2, desc2 = self._detect_describe_2d(
                    corrected0, multi_scale=False
                )
                idx2, _, _, ok2 = K.knn_match(
                    desc2, ref["desc"], valid2, ref["valid"],
                    ratio=cfg.ratio, max_dist=cfg.max_hamming,
                    mutual=cfg.mutual,
                )
                rng2 = np.random.default_rng([cfg.seed, gidx, 1])
                Mr, n_in, inl, rms = K.ransac_estimate(
                    cfg.model, ref["xy"][idx2], xy2, ok2, rng2,
                    n_hypotheses=cfg.n_hypotheses,
                    threshold=cfg.inlier_threshold,
                    refine_iters=cfg.refine_iters,
                )
                out["coarse_n_matches"].append(out["n_matches"].pop())
                out["n_matches"].append(np.int32(ok2.sum()))
                # the torch backend reports the FINE pass's keypoint
                # count under refine — keep diagnostics parity
                out["n_keypoints"].pop()
                out["n_keypoints"].append(np.int32(valid2.sum()))
                M = (M @ Mr).astype(np.float32)
            corrected = K.warp_frame(frame, M)
            for _ in range(int(cfg.transform_polish)):
                # photometric transform polish — mirror of the torch
                # backend's ops/polish.polish_transforms + re-warp
                M = _polish_transform_np(
                    corrected, ref["frame"], M, cfg.model, cfg.polish_grid
                )
                corrected = K.warp_frame(frame, M)
            out["transform"].append(M)
            out["corrected"].append(corrected)
            out["n_inliers"].append(np.int32(n_in))
            out["rms_residual"].append(np.float32(rms))

    def _process_one_3d(self, frame, gidx, ref, out):
        """Volumetric (rigid3d) mirror of the torch backend's 3D tail."""
        cfg = self.config
        xyz, score, valid = K.detect_keypoints_3d(
            frame,
            max_keypoints=cfg.max_keypoints,
            threshold=cfg.detect_threshold,
            border=min(cfg.border, min(frame.shape) // 4),
        )
        desc = K.describe_keypoints_3d(
            frame, xyz, valid, blur_sigma=cfg.blur_sigma
        )
        idx, dist, second, ok = K.knn_match(
            desc,
            ref["desc"],
            valid,
            ref["valid"],
            ratio=cfg.ratio,
            max_dist=cfg.max_hamming,
            mutual=cfg.mutual,
        )
        src = ref["xy"][idx]
        dst = xyz
        rng = np.random.default_rng([cfg.seed, gidx])
        out["n_keypoints"].append(np.int32(valid.sum()))
        out["n_matches"].append(np.int32(ok.sum()))
        out["warp_ok"].append(np.bool_(True))  # gather warp: unbounded
        M, n_in, inl, rms = K.ransac_estimate(
            cfg.model,
            src,
            dst,
            ok,
            rng,
            n_hypotheses=cfg.n_hypotheses,
            threshold=cfg.inlier_threshold,
            refine_iters=cfg.refine_iters,
        )
        out["transform"].append(M)
        out["corrected"].append(K.warp_volume(frame, M))
        out["n_inliers"].append(np.int32(n_in))
        out["rms_residual"].append(np.float32(rms))

    def _estimate_field(self, src, dst, ok, rng, shape):
        """Mirror of ops/piecewise.estimate_field in NumPy (including
        the residual refinement passes)."""
        cfg = self.config
        gh, gw = cfg.patch_grid
        H, W = shape
        Mg, n_g, inl_g, rms_g = K.ransac_estimate(
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
            # displacement AT the patch center (mirror of the torch
            # backend's per-patch evaluation, incl. the trust region
            # for multi-DoF patch fits)
            return Mp[:2, :2] @ c + Mp[:2, 2] - c

        def clamp(delta, cap):
            nrm = float(np.sqrt((delta**2).sum()) + 1e-12)
            return delta * min(1.0, cap / nrm)

        field = np.zeros((gh, gw, 2), np.float32)
        for i in range(gh):
            for j in range(gw):
                c = np.array([cx[j], cy[i]], np.float32)
                member = inl_g & (((src - c) ** 2).sum(-1) < reach * reach)
                Mp, n_p, _, _ = K.ransac_estimate(
                    pmodel, src, dst, member, rng,
                    n_hypotheses=cfg.patch_hypotheses, threshold=thr,
                )
                disp = g_t + clamp(
                    center_disp(Mp, c) - g_t, 2.0 * cfg.global_threshold
                )
                lam = n_p / (n_p + cfg.patch_prior)
                field[i, j] = lam * disp + (1 - lam) * g_t
        field = self._smooth_field(field, cfg.field_smooth_sigma)

        pitch = max(H / gh, W / gw)
        for it in range(cfg.field_passes - 1):
            # refinement reach shrink (mirror of ops/piecewise.py)
            reach_r = max(
                reach * cfg.refine_reach_scale ** (it + 1), 0.75 * pitch
            )
            pred = self._sample_field_at(field, src, shape)
            resid = dst - src - pred
            gate = inl_g & ((resid**2).sum(-1) < (2.0 * thr) ** 2)
            dst_resid = dst - pred
            r = np.zeros((gh, gw, 2), np.float32)
            for i in range(gh):
                for j in range(gw):
                    c = np.array([cx[j], cy[i]], np.float32)
                    member = gate & (((src - c) ** 2).sum(-1) < reach_r * reach_r)
                    # refine-pass hypothesis budget mirrors the torch
                    # backend (CorrectorConfig.refine_hypotheses)
                    Mp, n_p, _, _ = K.ransac_estimate(
                        pmodel, src, dst_resid, member, rng,
                        n_hypotheses=(
                            cfg.refine_hypotheses or cfg.patch_hypotheses
                        ),
                        threshold=thr,
                    )
                    lam = n_p / (n_p + cfg.patch_prior)
                    r[i, j] = lam * clamp(center_disp(Mp, c), 2.0 * thr)
            field = self._smooth_field(field + r, cfg.field_smooth_sigma)

        flow = upsample_field(field, shape)
        return field, flow, n_g, rms_g

    @staticmethod
    def _sample_field_at(field, pts, shape):
        """Bilinear sample of a cell-centered (gh, gw, 2) field at
        (N, 2) points (mirror of ops/piecewise.sample_field_at)."""
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

    @staticmethod
    def _smooth_field(field, sigma):
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
            k2 = np.outer(k, k)
            return np.einsum("ijkl,kl->ij", win, k2, optimize=True)

        num = np.stack([blur(field[..., i]) for i in range(2)], -1)
        den = blur(ones)[..., None]
        return (num / np.maximum(den, 1e-6)).astype(np.float32)
