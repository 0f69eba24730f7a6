"""The PyTorch execution backend: the translation batch program.

Counterpart of `kcmc_tpu/backends/jax_backend.py` for the slice the
port covers — the translation `core` of `_build_local_2d` (no shape
buckets, temporal seeds or mesh):

    K1 fields + blur -> selection -> K2 describe -> match -> consensus
    -> K3 warp -> photometric polish -> K3 re-warp

plus reference preparation (the same detect+describe on a batch of
one, so the reference also runs K1 and K2), the exact gather rescue of
frames K3 flags, and the kernels' launch counters. The stages of the
batch program are named profiler ranges (`kcmc.detect_describe`, ...)
that `chip_smoke.py --profile` reads. RANSAC keys fold the
global frame index into `key(seed)`, so results do not depend on batch
boundaries. Tensors live on `device`; on the card every kernel runs as
CUDA, on the CPU as its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from kcmc_tpu_torch.config import CorrectorConfig
from kcmc_tpu_torch.models.transforms import get_model
from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.ops.cuda_warp import warp_translation
from kcmc_tpu_torch.ops.fused import fused_detect_describe, fused_match_consensus
from kcmc_tpu_torch.ops.polish import polish_transforms
from kcmc_tpu_torch.ops.warp import warp_batch
from kcmc_tpu_torch.utils import prng
from kcmc_tpu_torch.utils.device import resolve_device, set_full_precision


def stage(name: str):
    """A named range of the batch program (`kcmc.<name>`) that
    torch.profiler reports with its host and device time; it costs a
    few microseconds when no profiler is running."""
    return torch.profiler.record_function(f"kcmc.{name}")


class TorchBackend:
    name = "torch"

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
        self.model = get_model(config.model)
        self._base_key = prng.key(config.seed, device=self.device)

    # -- launch counters ---------------------------------------------------

    @staticmethod
    def launch_counts() -> dict[str, int]:
        return cuda_build.launch_counts()

    @staticmethod
    def reset_launch_counts() -> None:
        cuda_build.reset_launches()

    # -- reference ---------------------------------------------------------

    def _detect_describe(self, frames: torch.Tensor):
        cfg = self.config
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
        )

    def prepare_reference(self, ref_frame) -> dict:
        """Keypoints and descriptors of the (H, W) reference frame:
        {"xy" (K, 2), "desc" (K, N_WORDS) int64, "valid" (K,), "frame"}."""
        frame = torch.as_tensor(np.array(ref_frame, np.float32), device=self.device)
        kps, desc = self._detect_describe(frame[None].contiguous())
        return {"xy": kps.xy[0], "desc": desc[0], "valid": kps.valid[0], "frame": frame}

    def reference_from_numpy(self, ref: dict) -> dict:
        """A prepared reference from numpy arrays (e.g. one prepared by
        kcmc_tpu: desc as uint32 words) as this backend's tensors."""
        dev = self.device
        return {
            "xy": torch.as_tensor(np.array(ref["xy"], np.float32), device=dev),
            "desc": torch.as_tensor(
                np.asarray(ref["desc"]).astype(np.uint32).astype(np.int64), device=dev
            ),
            "valid": torch.as_tensor(np.array(ref["valid"], bool), device=dev),
            "frame": torch.as_tensor(np.array(ref["frame"], np.float32), device=dev),
        }

    # -- batch program -----------------------------------------------------

    def process_batch(self, frames, ref: dict, frame_indices) -> dict:
        """Register and correct a (B, H, W) batch against a prepared
        reference. Returns numpy arrays: transform (B, 3, 3), corrected,
        warp_ok and the per-frame diagnostics."""
        cfg = self.config
        with stage("upload"):
            frames = torch.as_tensor(frames, device=self.device)
            frames = frames.to(torch.float32).contiguous()
            idx = torch.as_tensor(np.asarray(frame_indices, np.int64), device=self.device)
            keys = prng.fold_in(self._base_key, idx)
        with stage("detect_describe"):
            kps, desc = self._detect_describe(frames)
        with stage("match_consensus"):
            res, n_matches = fused_match_consensus(
                self.model, desc, kps.xy, kps.valid,
                ref["desc"], ref["xy"], ref["valid"], keys,
                ratio=cfg.ratio, max_dist=cfg.max_hamming, mutual=cfg.mutual,
                n_hypotheses=cfg.n_hypotheses, threshold=cfg.inlier_threshold,
                refine_iters=cfg.refine_iters, score_cap=cfg.score_cap,
                budget_rungs=cfg.budget_rungs, early_exit_frac=cfg.early_exit_frac,
            )
        M = res.transform.contiguous()
        with stage("warp"):
            corrected, ok = warp_translation(frames, M)
        for _ in range(int(cfg.transform_polish)):
            # frames the bounded warp zeroed have nothing to correlate:
            # they keep their transform for the rescue path
            with stage("polish"):
                newM = polish_transforms(
                    corrected, ref["frame"], M, cfg.model, grid=cfg.polish_grid
                )
                M = torch.where(ok[:, None, None], newM, M).contiguous()
            with stage("warp"):
                corrected, ok = warp_translation(frames, M)
        out = {
            "transform": M,
            "corrected": corrected,
            "warp_ok": ok,
            "n_keypoints": kps.valid.sum(dim=1).to(torch.int32),
            "n_matches": n_matches,
            "n_inliers": res.n_inliers,
            "rms_residual": res.rms_residual,
        }
        with stage("download"):
            return {k: v.cpu().numpy() for k, v in out.items()}

    def rescue_warp(self, frames, out: dict, ref: dict | None = None) -> np.ndarray:
        """Exact gather warp (plus the photometric polish, with `ref`)
        for frames K3 flagged; updates out["transform"] in place so the
        exported transforms match the rescued pixels."""
        cfg = self.config
        fr = torch.as_tensor(np.asarray(frames, np.float32), device=self.device)
        M = torch.as_tensor(np.asarray(out["transform"], np.float32), device=self.device)
        corrected = warp_batch(fr, M)
        if ref is not None and ref.get("frame") is not None:
            for _ in range(int(cfg.transform_polish)):
                M = polish_transforms(corrected, ref["frame"], M, cfg.model,
                                      grid=cfg.polish_grid)
                corrected = warp_batch(fr, M)
            out["transform"] = M.cpu().numpy()
        return corrected.cpu().numpy()
