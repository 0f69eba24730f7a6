"""The detect->describe and match->consensus stages of the batch program.

Counterpart of `kcmc_tpu/ops/fused.py`, single scale and through the
scale pyramid (ops/pyramid.py). PyTorch runs eagerly, so "fused" here
means what the reference's traced region guarantees that matters for
results: the blur K1 computes on the side feeds the describe stage
directly, and the match and consensus of a whole batch run as batched
tensor operations.
"""

from __future__ import annotations

import torch

from kcmc_tpu_torch.models.transforms import TransformModel
from kcmc_tpu_torch.ops.describe import describe_keypoints_batch
from kcmc_tpu_torch.ops.detect import detect_keypoints_batch
from kcmc_tpu_torch.ops.match import Matches, knn_match_impl
from kcmc_tpu_torch.ops.pyramid import build_pyramid, merge_octave_keypoints, per_octave_k
from kcmc_tpu_torch.ops.ransac import RansacResult, consensus_batch


def fused_detect_describe(
    frames: torch.Tensor,
    *,
    max_keypoints: int,
    detect_threshold: float,
    nms_size: int,
    border: int,
    harris_k: float,
    window_sigma: float,
    blur_sigma: float,
    cand_tile: int,
    oriented: bool = False,
    n_octaves: int = 1,
    octave_scale: float = 1.5,
    multi_scale: bool = True,
    precision: str = "bf16",
    valid_hw: torch.Tensor | None = None,
):
    """(Keypoints, desc) of a (B, H, W) float32 batch: K1 fields and
    blur, selection, then the upright describe route through K2 or,
    with `oriented`, the small-K route through K6 or (K >= 2048) the
    bins-first route through K4, K2 and K5. With `n_octaves > 1` and
    `multi_scale`, the same stage runs on every octave of the pyramid at
    `per_octave_k` keypoints and border min(border, min(H_o, W_o) // 4),
    merged octave-major in base coordinates. `precision="float32"`
    describes through the unquantized route (K11) at every K.
    `valid_hw` masks selection to the valid extent of bucket-padded
    frames (single scale only: bucket routing gates pyramid configs
    out). The describe stage's finite mean stays over the whole canvas,
    pad zeros included, as the reference's (fused.py:111-120)."""

    def stage(fr, k, b):
        kps, smooth = detect_keypoints_batch(
            fr,
            max_keypoints=k,
            threshold=detect_threshold,
            nms_size=nms_size,
            border=b,
            harris_k=harris_k,
            smooth_sigma=blur_sigma,
            window_sigma=window_sigma,
            cand_tile=cand_tile,
            valid_hw=valid_hw,
        )
        desc = describe_keypoints_batch(
            fr, kps, blur_sigma=blur_sigma, smooth=smooth, oriented=oriented,
            precision=precision,
        )
        return kps, desc

    if n_octaves <= 1 or not multi_scale:
        return stage(frames, max_keypoints, border)
    octs = build_pyramid(frames, n_octaves, octave_scale)
    per = [
        stage(oc.frames, k, min(border, min(oc.frames.shape[1:]) // 4))
        for oc, k in zip(octs, per_octave_k(max_keypoints, n_octaves))
    ]
    return merge_octave_keypoints(per, octs)


def match_to_reference(
    desc: torch.Tensor,
    kp_valid: torch.Tensor,
    ref_desc: torch.Tensor,
    ref_xy: torch.Tensor,
    ref_valid: torch.Tensor,
    ratio: float = 0.85,
    max_dist: int = 80,
    mutual: bool = True,
    matches: Matches | None = None,
) -> tuple[torch.Tensor, Matches]:
    """Match (B, K, W) descriptors against the reference: (src (B, K, 2),
    the reference keypoint of each frame keypoint's match, and the
    Matches). The piecewise path's per-frame match (jax_backend.py:1056)
    and the first half of `fused_match_consensus`. `matches` supplies
    precomputed Matches (the banded matcher's) in place of the dense
    match."""
    if matches is None:
        matches = knn_match_impl(
            desc, ref_desc, kp_valid, ref_valid,
            ratio=ratio, max_dist=max_dist, mutual=mutual,
        )
    return ref_xy[matches.idx], matches


def fused_match_consensus(
    model: TransformModel,
    desc: torch.Tensor,
    kp_xy: torch.Tensor,
    kp_valid: torch.Tensor,
    ref_desc: torch.Tensor,
    ref_xy: torch.Tensor,
    ref_valid: torch.Tensor,
    keys: torch.Tensor,
    ratio: float = 0.85,
    max_dist: int = 80,
    mutual: bool = True,
    n_hypotheses: int = 128,
    threshold: float = 2.0,
    refine_iters: int = 2,
    score_cap: int = 0,
    budget_rungs: int = 0,
    early_exit_frac: float = 0.7,
    matches: Matches | None = None,
    seed_transform: torch.Tensor | None = None,
    seed_ok: torch.Tensor | None = None,
) -> tuple[RansacResult, torch.Tensor]:
    """Match (B, K, W) descriptors against the reference (or take the
    precomputed `matches`) and estimate per-frame transforms:
    (RansacResult, n_matches (B,) int32). Correspondences run reference
    keypoint -> frame keypoint; `seed_transform` / `seed_ok` are the
    consensus's warm-start seed."""
    src, matches = match_to_reference(
        desc, kp_valid, ref_desc, ref_xy, ref_valid,
        ratio=ratio, max_dist=max_dist, mutual=mutual, matches=matches,
    )
    res = consensus_batch(
        model, src, kp_xy, matches.valid, keys,
        n_hypotheses=n_hypotheses, threshold=threshold,
        refine_iters=refine_iters, score_cap=score_cap,
        budget_rungs=budget_rungs, early_exit_frac=early_exit_frac,
        seed_transform=seed_transform, seed_ok=seed_ok,
    )
    return res, matches.valid.sum(dim=1).to(torch.int32)
