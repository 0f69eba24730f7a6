"""The detect->describe and match->consensus stages of the batch program.

Counterpart of `kcmc_tpu/ops/fused.py` (single scale). PyTorch runs
eagerly, so "fused" here means what the reference's traced region
guarantees that matters for results: the blur K1 computes on the side
feeds the describe stage directly, and the match and consensus of a
whole batch run as batched tensor operations.
"""

from __future__ import annotations

import torch

from kcmc_tpu_torch.models.transforms import TransformModel
from kcmc_tpu_torch.ops.describe import describe_keypoints_batch
from kcmc_tpu_torch.ops.detect import detect_keypoints_batch
from kcmc_tpu_torch.ops.match import knn_match_impl
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
):
    """(Keypoints, desc) of a (B, H, W) float32 batch: K1 fields and
    blur, selection, then the upright describe route through K2."""
    kps, smooth = detect_keypoints_batch(
        frames,
        max_keypoints=max_keypoints,
        threshold=detect_threshold,
        nms_size=nms_size,
        border=border,
        harris_k=harris_k,
        smooth_sigma=blur_sigma,
        window_sigma=window_sigma,
        cand_tile=cand_tile,
    )
    desc = describe_keypoints_batch(frames, kps, blur_sigma=blur_sigma, smooth=smooth)
    return kps, desc


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
) -> tuple[RansacResult, torch.Tensor]:
    """Match (B, K, W) descriptors against the reference and estimate
    per-frame transforms: (RansacResult, n_matches (B,) int32).
    Correspondences run reference keypoint -> frame keypoint."""
    matches = knn_match_impl(
        desc, ref_desc, kp_valid, ref_valid,
        ratio=ratio, max_dist=max_dist, mutual=mutual,
    )
    src = ref_xy[matches.idx]  # (B, K, 2)
    res = consensus_batch(
        model, src, kp_xy, matches.valid, keys,
        n_hypotheses=n_hypotheses, threshold=threshold,
        refine_iters=refine_iters, score_cap=score_cap,
        budget_rungs=budget_rungs, early_exit_frac=early_exit_frac,
    )
    return res, matches.valid.sum(dim=1).to(torch.int32)
