"""The PyTorch execution backend: the translation, matrix-model
(single-scale or pyramid), piecewise and rigid3d batch programs.

Counterpart of `kcmc_tpu/backends/jax_backend.py` for the slices the
port covers — the 2D `core` of `_build_local_2d` and the 3D one of
`_build_local_3d` (no shape buckets or mesh):

    translation: K1 fields + blur -> selection -> K2 upright describe
        -> match -> consensus -> K3 warp -> polish -> K3 re-warp
    rigid, affine, homography: K1 -> selection -> oriented describe (K6
        and the binned selection below K=2048; K4, bins, K2, K5 from
        there on) -> match -> consensus -> K7 warp -> polish -> K7 re-warp
    similarity: as rigid, through the separable shear/scale warp
    n_octaves > 1 (2D): the detect + describe stage on every octave of
        the scale pyramid, merged in base coordinates; for the matrix
        models then the coarse-to-fine refine (jax_backend.py:1155-1208):
        warp by the coarse estimate, detect + describe single-scale,
        match and consensus again, compose coarse @ fine
    piecewise:   K1 -> selection -> K2 upright describe -> match ->
        per-patch field estimate (translation, rigid, similarity or
        affine patch fits) -> K8 warp (the upsampled flow through
        `warp_batch_flow` for grids K8 does not take) -> field_polish
        passes of correlation polish, each followed by a re-warp
    rigid3d (T, D, H, W volumes): K9 response + blur -> 3x3x3 NMS and
        selection -> K10 trilinear patches -> match -> rigid3d consensus
        -> the bounded rigid3d volume warp; no polish (jax_backend.py:1305)

plus reference preparation (the same detect+describe on a batch of
one, so the reference runs the same kernels), the exact gather rescue
of frames the bounded warp flags, and the kernels' launch counters.

The options of `correct()` meet here: `sanitize_input` replaces
non-finite pixels by each frame's finite mean before the reference's
and every batch's detection and in the rescue (jax_backend.py:72);
`match_precision="float32"` describes through the unquantized route
(K11); a warm-start `seed` is scored first by the batch's consensus
(not by the pyramid's fine pass); `quality_metrics` adds the per-frame
`template_corr` and `coverage`; `update_reference` blends a rolling
template on the device (jax_backend.py:449). Batches may arrive as
device tensors, and `to_host=False` leaves the outputs on the device.
The stages of the batch program are named profiler ranges
(`kcmc.detect_describe`, ...) that `chip_smoke.py --profile` reads. RANSAC keys fold the
global frame index into `key(seed)`, so results do not depend on batch
boundaries. Tensors live on `device`; on the card every kernel runs as
CUDA, on the CPU as its plain version.

With `match_radius` the dense match of every 2D path is the banded
matcher (`ops/match_banded.py`): geometry once per frame shape, the
reference bucketed once per batch, its Matches fed to the consensus,
the field estimate and both passes of the pyramid.
Other warps on request (`_resolve_batch_warp`): K7 for translation
warp="matrix", the separable chain plus the projective residual for
homography warp="separable"; a rigid3d blur radius above K9's takes the
plain detection route (`ops/detect3d.py`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from kcmc_tpu_torch.config import CorrectorConfig
from kcmc_tpu_torch.models.transforms import get_model
from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.ops.cuda_warp import warp_translation
from kcmc_tpu_torch.ops import cuda_warp_field
from kcmc_tpu_torch.ops.cuda_warp_matrix import warp_batch_matrix
from kcmc_tpu_torch.ops.describe3d import describe_keypoints_3d_batch
from kcmc_tpu_torch.ops.detect3d import detect_keypoints_3d_batch
from kcmc_tpu_torch.ops.fused import (
    fused_detect_describe,
    fused_match_consensus,
    match_to_reference,
)
from kcmc_tpu_torch.ops.match_banded import banded_match, build_banded_ref, make_geometry
from kcmc_tpu_torch.ops.piecewise import correlation_polish, estimate_field, upsample_field
from kcmc_tpu_torch.ops.polish import polish_transforms
from kcmc_tpu_torch.ops.warp import (
    coverage_mask,
    coverage_mask_3d,
    coverage_mask_flow,
    warp_batch,
    warp_batch_with_ok,
    warp_frame_flow,
    warp_volume,
)
from kcmc_tpu_torch.ops.warp_field import (
    warp_batch_flow,
    warp_batch_homography,
    warp_batch_rigid3d,
)
from kcmc_tpu_torch.ops.warp_separable import warp_batch_affine
from kcmc_tpu_torch.utils import prng
from kcmc_tpu_torch.utils.device import resolve_device, set_full_precision


def sanitize_nonfinite(frames: torch.Tensor) -> torch.Tensor:
    """Replace the non-finite pixels of a (B, ...) batch by each frame's
    finite mean (jax_backend.py:72, `sanitize_input`)."""
    finite = torch.isfinite(frames)
    axes = tuple(range(1, frames.dim()))
    n = torch.clamp(finite.sum(dim=axes, keepdim=True), min=1)
    zero = torch.zeros((), dtype=frames.dtype, device=frames.device)
    mean = torch.where(finite, frames, zero).sum(dim=axes, keepdim=True) / n
    return torch.where(finite, frames, mean)


def template_corr(corrected: torch.Tensor, ref_frame: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Per-frame Pearson correlation (B,) of corrected frames against the
    reference over the warp coverage mask (jax_backend.py:36), so the
    zeros a warp writes outside its coverage do not lower the score."""
    axes = tuple(range(1, corrected.dim()))
    m = mask.to(corrected.dtype)
    n = torch.clamp(m.sum(dim=axes, keepdim=True), min=1.0)
    cm = (corrected * m).sum(dim=axes, keepdim=True) / n
    rm = (ref_frame * m).sum(dim=axes, keepdim=True) / n
    c = (corrected - cm) * m
    r = (ref_frame - rm) * m
    num = (c * r).sum(dim=axes)
    den = torch.sqrt((c * c).sum(dim=axes) * (r * r).sum(dim=axes))
    return num / torch.clamp(den, min=1e-12)


def blend_template(ref_frame: torch.Tensor, frames: torch.Tensor, ok: torch.Tensor,
                   alpha: float) -> torch.Tensor:
    """(1 - alpha) * template + alpha * the mean of the window's frames
    with `ok` (jax_backend.py:111); a window with none keeps the
    template."""
    okf = ok.to(torch.float32)
    n = okf.sum()
    w = okf.reshape((-1,) + (1,) * (frames.dim() - 1))
    mean = (frames * w).sum(dim=0) / torch.clamp(n, min=1.0)
    a = torch.tensor(alpha, dtype=torch.float32, device=frames.device)
    blended = (1.0 - a) * ref_frame + a * mean
    return torch.where(n > 0.0, blended, ref_frame)


def stage(name: str):
    """A named range of the batch program (`kcmc.<name>`) that
    torch.profiler reports with its host and device time; it costs a
    few microseconds when no profiler is running."""
    return torch.profiler.record_function(f"kcmc.{name}")


class TorchBackend:
    name = "torch"
    # Device errors the robustness ladder may retry: none. A CUDA error
    # is sticky — no retry on the same context outlives it — so a launch,
    # build or kernel error always raises (faults.classify_device_transient).
    transient_error_types = ()

    def __init__(self, config: CorrectorConfig, device=None):
        missing = config.unsupported()
        if missing:
            raise NotImplementedError(
                "not implemented in this slice of the port: " + "; ".join(missing)
            )
        self.config = config
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_full_precision()
        self.model = None if config.model == "piecewise" else get_model(config.model)
        self._base_key = prng.key(config.seed, device=self.device)
        self._geometries = {}  # frame shape -> banded geometry
        self.precision = config.resolved_match_precision(self.device.type == "cuda")

    # -- launch counters ---------------------------------------------------

    @staticmethod
    def launch_counts() -> dict[str, int]:
        return cuda_build.launch_counts()

    @staticmethod
    def reset_launch_counts() -> None:
        cuda_build.reset_launches()

    # -- reference ---------------------------------------------------------

    def _detect_describe(self, frames: torch.Tensor, multi_scale: bool = True):
        """(Keypoints, desc) of a (B, H, W) frame batch (through the scale
        pyramid when n_octaves > 1 and `multi_scale`) or, for rigid3d, a
        (B, D, H, W) volume batch (K9 and K10; the reference's window
        sigma and Harris k of 3D detection, border <= min(D, H, W) // 4)."""
        cfg = self.config
        if frames.dim() == 4:
            kps, smooth = detect_keypoints_3d_batch(
                frames,
                max_keypoints=cfg.max_keypoints,
                threshold=cfg.detect_threshold,
                border=min(cfg.border, min(frames.shape[1:]) // 4),
                smooth_sigma=cfg.blur_sigma,
            )
            return kps, describe_keypoints_3d_batch(
                frames, kps, blur_sigma=cfg.blur_sigma, smooth=smooth
            )
        return fused_detect_describe(
            frames,
            max_keypoints=cfg.max_keypoints,
            detect_threshold=cfg.detect_threshold,
            nms_size=cfg.nms_size,
            border=cfg.border,
            harris_k=cfg.harris_k,
            window_sigma=cfg.harris_window_sigma,
            blur_sigma=cfg.blur_sigma,
            cand_tile=cfg.cand_tile,
            oriented=cfg.resolved_oriented(),
            n_octaves=cfg.n_octaves,
            octave_scale=cfg.octave_scale,
            multi_scale=multi_scale,
            precision=self.precision,
        )

    # -- warp policy -------------------------------------------------------

    def _shear_bound_px(self, shape) -> int:
        """Rotation allowance in pixels: `max_rotation_deg` (per frame
        shape) when set, else `max_shear_px` (jax_backend.py:1561)."""
        cfg = self.config
        if cfg.max_rotation_deg is None:
            return cfg.max_shear_px
        side = max(shape)
        return int(math.ceil(math.tan(math.radians(cfg.max_rotation_deg)) * side / 2.0))

    def _matrix_resid_px(self, shape) -> int:
        """Residual bound of the matrix warp K7: the rotation, projective
        and ~1.5% scale allowances, at least 12 (jax_backend.py:1575)."""
        cfg = self.config
        scale_margin = max(4, int(cfg.max_scale_dev * max(shape) / 2) + 1)
        return max(
            12, self._shear_bound_px(shape) + cfg.max_projective_px + scale_margin
        )

    def _resolve_batch_warp(self, shape):
        """fn(frames (B, H, W), transforms (B, 3, 3)) -> (corrected, ok),
        the reference's accelerator choices (jax_backend.py:1671-1735):
        the gather warp for warp="jnp"; K7 with max_px =
        _matrix_resid_px(shape) for warp="matrix" and for rigid, affine
        and homography under "auto"; for homography warp="separable" the
        separable chain plus the projective residual (shear bound
        _shear_bound_px, residual bound max_projective_px); the
        separable chain for similarity or warp="separable" (shear bound
        _shear_bound_px, 0 for translation); else K3 (translation). For
        rigid3d volumes and (B, 4, 4) maps: the bounded volume warp with
        max_px = max_flow_px, or the gather warp for warp="jnp"."""
        if self.config.model == "rigid3d":
            if self.config.warp == "jnp":
                def gather(vols, transforms):
                    ok = torch.ones(vols.shape[0], dtype=torch.bool, device=vols.device)
                    return warp_volume(vols, transforms), ok
                return gather
            return functools.partial(warp_batch_rigid3d, max_px=self.config.max_flow_px)
        model, warp = self.config.model, self.config.warp
        if warp == "jnp":
            return warp_batch_with_ok
        if warp == "matrix" or (warp == "auto" and model in ("rigid", "affine", "homography")):
            return functools.partial(warp_batch_matrix, max_px=self._matrix_resid_px(shape))
        if warp == "separable" and model == "homography":
            return functools.partial(
                warp_batch_homography, shear_px=self._shear_bound_px(shape),
                max_px=self.config.max_projective_px,
            )
        if warp == "separable" or model == "similarity":
            shear = 0 if model == "translation" else self._shear_bound_px(shape)
            return functools.partial(warp_batch_affine, shear_px=shear, with_ok=True)
        return warp_translation

    def _resolve_field_warp(self, shape):
        """fn(frames (B, H, W), fields (B, gh, gw, 2)) -> (corrected, ok)
        for piecewise: K8 with max_px = max_flow_px where it takes the
        grid (`cuda_warp_field.supports`), else the upsampled flow
        through `warp_batch_flow` (jax_backend.py:1741-1771); for
        warp="jnp" the gather warp of the upsampled flow (unbounded, ok
        all True). Chosen from the config before any launch."""
        cfg = self.config
        if cfg.warp == "jnp":
            def gather(frames, fields):
                return (
                    warp_frame_flow(frames, upsample_field(fields, shape)),
                    torch.ones(frames.shape[0], dtype=torch.bool, device=frames.device),
                )
            return gather
        if cuda_warp_field.supports(cfg.patch_grid, cfg.max_flow_px):
            return functools.partial(cuda_warp_field.warp_batch_field, max_px=cfg.max_flow_px)

        def flow(frames, fields):
            return warp_batch_flow(frames, upsample_field(fields, shape), max_px=cfg.max_flow_px)
        return flow

    def _banded(self, shape, ref: dict):
        """(geometry, bucketed reference) of the banded matcher for this
        batch, or None without `match_radius`: the geometry once per
        frame shape (jax_backend.py:982-991), the reference once per
        batch (:1017-1024)."""
        cfg = self.config
        if cfg.match_radius is None:
            return None
        geom = self._geometries.get(shape)
        if geom is None:
            geom = self._geometries[shape] = make_geometry(
                shape, cfg.match_radius, cfg.max_keypoints, cfg.max_keypoints,
                tile=cfg.match_tile, slack=cfg.match_slack, nms_tile=cfg.cand_tile,
            )
        return geom, build_banded_ref(geom, ref["xy"], ref["desc"], ref["valid"])

    def _banded_matches(self, banded, kps, desc):
        if banded is None:
            return None
        cfg = self.config
        return banded_match(*banded, desc, kps.xy, kps.valid, ratio=cfg.ratio,
                            max_dist=cfg.max_hamming, mutual=cfg.mutual)

    def prepare_reference(self, ref_frame) -> dict:
        """Keypoints and descriptors of the (H, W) reference frame (every
        octave's, merged, when n_octaves > 1) or (D, H, W) reference
        volume, through the batch program's kernels:
        {"xy" (K, 2 or 3), "desc" (K, N_WORDS) int64, "valid" (K,),
        "frame"}. (The JAX package prepares a 3D reference through its
        jnp route; on the CPU the port's plain versions reproduce it.)
        `ref_frame` is a numpy array or a tensor on any device; with
        `sanitize_input` its non-finite pixels are replaced first."""
        if isinstance(ref_frame, torch.Tensor):
            frame = ref_frame.to(device=self.device, dtype=torch.float32)
        else:
            frame = torch.as_tensor(np.array(ref_frame, np.float32), device=self.device)
        if self.config.sanitize_input:
            frame = sanitize_nonfinite(frame[None])[0]
        kps, desc = self._detect_describe(frame[None].contiguous())
        return {"xy": kps.xy[0], "desc": desc[0], "valid": kps.valid[0], "frame": frame}

    def reference_from_numpy(self, ref: dict) -> dict:
        """A prepared reference from numpy arrays (e.g. one prepared by
        kcmc_tpu: desc as uint32 words, xy (K, 2) or, for rigid3d,
        (K, 3); any K, such as a pyramid reference's n_octaves x
        per-octave slots) as this backend's tensors."""
        dev = self.device
        return {
            "xy": torch.as_tensor(np.array(ref["xy"], np.float32), device=dev),
            "desc": torch.as_tensor(
                np.asarray(ref["desc"]).astype(np.uint32).astype(np.int64), device=dev
            ),
            "valid": torch.as_tensor(np.array(ref["valid"], bool), device=dev),
            "frame": torch.as_tensor(np.array(ref["frame"], np.float32), device=dev),
        }

    def update_reference(self, ref: dict, tail_corrected, tail_ok, window: int,
                         alpha: float) -> dict:
        """A rolling-template update on the device (jax_backend.py:449):
        blend the last `window` frames of the per-batch corrected frames
        `tail_corrected` whose `tail_ok` holds into ref["frame"]
        (`blend_template`) and prepare the blended template as the new
        reference. Frames the bounded warp flagged are left out, where
        the host path blends their rescued pixels."""
        if not tail_corrected:
            return ref
        dev = self.device
        frames = torch.cat([torch.as_tensor(c, device=dev).to(torch.float32)
                            for c in tail_corrected])[-window:]
        ok = torch.cat([torch.as_tensor(k, device=dev).to(torch.bool)
                        for k in tail_ok])[-window:]
        with stage("update_reference"):
            new_frame = blend_template(ref["frame"].to(torch.float32), frames, ok, alpha)
        return self.prepare_reference(new_frame)

    def quality(self, corrected: torch.Tensor, out: dict, ref_frame: torch.Tensor):
        """(template_corr, coverage), (B,) each, of corrected frames and
        the transforms or fields in `out` that made them
        (jax_backend.py:676-701): coverage masks of the dense flow
        (piecewise), the volume warp (rigid3d) or the matrix warp."""
        shape = tuple(corrected.shape[1:])
        if "field" in out:
            mask = coverage_mask_flow(upsample_field(out["field"], shape))
        elif out["transform"].shape[-1] == 4:
            mask = coverage_mask_3d(shape, out["transform"])
        else:
            mask = coverage_mask(shape, out["transform"])
        coverage = mask.to(torch.float32).mean(dim=tuple(range(1, mask.dim())))
        return template_corr(corrected, ref_frame, mask), coverage

    # -- batch program -----------------------------------------------------

    def to_host(self, out: dict) -> dict:
        """A batch's outputs as numpy arrays."""
        with stage("download"):
            return {k: v.cpu().numpy() for k, v in out.items()}

    def process_batch(self, frames, ref: dict, frame_indices, seed=None,
                      to_host: bool = True) -> dict:
        """Register and correct a (B, H, W) batch (rigid3d: (B, D, H, W);
        numpy or a tensor on any device) against a prepared reference.
        Returns numpy arrays (tensors on the device with `to_host=False`):
        transform (B, 3, 3) ((B, 4, 4) for rigid3d; field (B, gh, gw, 2)
        for piecewise), corrected, warp_ok and the per-frame diagnostics
        (with `quality_metrics`, template_corr and coverage, unless
        ref["_skip_quality"]). `seed` = (transform, ok): the warm start's
        consensus seed, shared by the batch (matrix models)."""
        cfg = self.config
        with stage("upload"):
            frames = torch.as_tensor(frames, device=self.device)
            frames = frames.to(torch.float32).contiguous()
            if cfg.sanitize_input:
                frames = sanitize_nonfinite(frames)
            idx = torch.as_tensor(np.asarray(frame_indices, np.int64), device=self.device)
            keys = prng.fold_in(self._base_key, idx)
        with stage("match_consensus"):
            banded = self._banded(tuple(frames.shape[1:]), ref)
        with stage("detect_describe"):
            kps, desc = self._detect_describe(frames)
        if cfg.model == "piecewise":
            out = self._piecewise_tail(frames, kps, desc, ref, keys, banded)
        else:
            out = self._matrix_tail(frames, kps, desc, ref, keys, banded, seed)
        if cfg.quality_metrics and not ref.get("_skip_quality"):
            with stage("quality"):
                out["template_corr"], out["coverage"] = self.quality(
                    out["corrected"], out, ref["frame"])
        return self.to_host(out) if to_host else out

    def _piecewise_tail(self, frames, kps, desc, ref, keys, banded=None) -> dict:
        """Match (dense or banded), per-patch field estimate, field warp
        and the field_polish loop (jax_backend.py:1050-1104,
        :1212-1241)."""
        cfg = self.config
        with stage("match_consensus"):
            src, m = match_to_reference(
                desc, kps.valid, ref["desc"], ref["xy"], ref["valid"],
                ratio=cfg.ratio, max_dist=cfg.max_hamming, mutual=cfg.mutual,
                matches=self._banded_matches(banded, kps, desc),
            )
            fres = estimate_field(
                src, kps.xy, m.valid, keys, grid=cfg.patch_grid,
                shape=tuple(frames.shape[1:]), n_global_hyps=cfg.n_hypotheses,
                patch_hyps=cfg.patch_hypotheses, global_threshold=cfg.global_threshold,
                patch_threshold=cfg.inlier_threshold, prior=cfg.patch_prior,
                smooth_sigma=cfg.field_smooth_sigma, passes=cfg.field_passes,
                refine_reach_scale=cfg.refine_reach_scale, patch_model=cfg.patch_model,
                refine_hyps=cfg.refine_hypotheses,
            )
        field_warp = self._resolve_field_warp(tuple(frames.shape[1:]))
        field = fres.field.contiguous()
        with stage("warp"):
            corrected, ok = field_warp(frames, field)
        for _ in range(int(cfg.field_polish)):
            # a frame the bounded warp zeroed has no pixels to correlate:
            # its field stays for the rescue path
            with stage("polish"):
                delta = correlation_polish(corrected, ref["frame"], cfg.patch_grid)
                field = (field + torch.where(ok[:, None, None, None], delta,
                                             torch.zeros_like(delta))).contiguous()
            with stage("warp"):
                corrected, ok = field_warp(frames, field)
        return {
            "field": field,
            "corrected": corrected,
            "warp_ok": ok,
            "n_keypoints": kps.valid.sum(dim=1).to(torch.int32),
            "n_matches": m.valid.sum(dim=1).to(torch.int32),
            "n_inliers": fres.n_inliers,
            "rms_residual": fres.rms_residual,
        }

    def _register(self, kps, desc, ref, keys, banded=None, seed=None) -> dict:
        """Match (dense or banded) and consensus of a batch against the
        reference; `seed` = (transform, ok) is the consensus's warm-start
        seed."""
        cfg = self.config
        seed_M = seed_ok = None
        if seed is not None:
            seed_M = torch.as_tensor(seed[0], device=self.device).to(torch.float32)
            seed_ok = torch.as_tensor(seed[1], device=self.device).to(torch.bool)
        with stage("match_consensus"):
            res, n_matches = fused_match_consensus(
                self.model, desc, kps.xy, kps.valid,
                ref["desc"], ref["xy"], ref["valid"], keys,
                ratio=cfg.ratio, max_dist=cfg.max_hamming, mutual=cfg.mutual,
                n_hypotheses=cfg.n_hypotheses, threshold=cfg.inlier_threshold,
                refine_iters=cfg.refine_iters, score_cap=cfg.score_cap,
                budget_rungs=cfg.budget_rungs, early_exit_frac=cfg.early_exit_frac,
                matches=self._banded_matches(banded, kps, desc),
                seed_transform=seed_M, seed_ok=seed_ok,
            )
        return {
            "transform": res.transform.contiguous(),
            "n_keypoints": kps.valid.sum(dim=1).to(torch.int32),
            "n_matches": n_matches,
            "n_inliers": res.n_inliers,
            "rms_residual": res.rms_residual,
        }

    def _matrix_tail(self, frames, kps, desc, ref, keys, banded=None, seed=None) -> dict:
        """Match, consensus (seeded with `seed`), the pyramid's
        coarse-to-fine refine, bounded warp and the transform polish loop
        (rigid3d has no polish, jax_backend.py:1323)."""
        cfg = self.config
        batch_warp = self._resolve_batch_warp(frames.shape[1:])
        out = self._register(kps, desc, ref, keys, banded, seed)
        if frames.dim() == 3 and cfg.n_octaves > 1 and cfg.pyramid_refine:
            # warp by the coarse (multi-scale) estimate and register the
            # residual single-scale, without a temporal seed; frames the
            # bounded warp flagged keep the coarse estimate
            with stage("refine"):
                coarse = out["transform"]
                with stage("warp"):
                    corrected0, ok0 = batch_warp(frames, coarse)
                with stage("detect_describe"):
                    kps2, desc2 = self._detect_describe(corrected0, multi_scale=False)
                fine_out = self._register(kps2, desc2, ref, prng.fold_in(keys, 1), banded)
                eye = torch.eye(3, dtype=coarse.dtype, device=coarse.device)
                fine = torch.where(ok0[:, None, None], fine_out["transform"], eye)
                fine_out["transform"] = torch.matmul(coarse, fine).contiguous()
                fine_out["coarse_n_matches"] = out["n_matches"]
                out = fine_out
        M = out["transform"]
        with stage("warp"):
            corrected, ok = batch_warp(frames, M)
        n_polish = 0 if cfg.model == "rigid3d" else int(cfg.transform_polish)
        for _ in range(n_polish):
            # frames the bounded warp zeroed have nothing to correlate:
            # they keep their transform for the rescue path
            with stage("polish"):
                newM = polish_transforms(
                    corrected, ref["frame"], M, cfg.model, grid=cfg.polish_grid
                )
                M = torch.where(ok[:, None, None], newM, M).contiguous()
            with stage("warp"):
                corrected, ok = batch_warp(frames, M)
        return {**out, "transform": M, "corrected": corrected, "warp_ok": ok}

    def rescue_warp(self, frames, out: dict, ref: dict | None = None) -> np.ndarray:
        """Exact gather warp (plus the photometric polish, with `ref`)
        for frames the bounded warp (K3, K7, K8, the separable chain or
        the rigid3d volume warp) flagged; updates out["transform"] in
        place so the exported transforms match the rescued pixels.
        Piecewise frames are re-warped from their field as it is, rigid3d
        volumes through the trilinear gather, neither with a polish
        (jax_backend.py:1431)."""
        cfg = self.config
        if isinstance(frames, torch.Tensor):
            fr = frames.to(device=self.device, dtype=torch.float32)
        else:
            fr = torch.as_tensor(np.asarray(frames, np.float32), device=self.device)
        if cfg.sanitize_input:
            # the batch program sanitized its own copy; the rescue warps
            # the raw frames again (jax_backend.py:1426)
            fr = sanitize_nonfinite(fr)
        if cfg.model == "piecewise":
            fields = torch.as_tensor(np.asarray(out["field"], np.float32), device=self.device)
            return warp_frame_flow(fr, upsample_field(fields, tuple(fr.shape[1:]))).cpu().numpy()
        M = torch.as_tensor(np.asarray(out["transform"], np.float32), device=self.device)
        if fr.dim() == 4:
            return warp_volume(fr, M).cpu().numpy()
        corrected = warp_batch(fr, M)
        if ref is not None and ref.get("frame") is not None:
            for _ in range(int(cfg.transform_polish)):
                M = polish_transforms(corrected, ref["frame"], M, cfg.model,
                                      grid=cfg.polish_grid)
                corrected = warp_batch(fr, M)
            out["transform"] = M.cpu().numpy()
        return corrected.cpu().numpy()
