"""`MotionCorrector` of the PyTorch port (translation slice).

Counterpart of the one-shot path of `kcmc_tpu/corrector.py`
(`MotionCorrector.correct`): reference selection, fixed-size batches
with the tail batch padded by repeating its last frame, the batch
program, rescue of frames the bounded warp flagged, and the merge.
Streaming, checkpoints, template refinement and the robustness ladder
are later slices (ROADMAP.md queue 1 item 15).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from kcmc_tpu_torch.backends.torch_backend import TorchBackend
from kcmc_tpu_torch.config import CorrectorConfig


@dataclasses.dataclass
class CorrectionResult:
    corrected: np.ndarray  # (T, H, W)
    transforms: np.ndarray  # (T, 3, 3) ref -> frame maps
    diagnostics: dict  # per-frame arrays
    timing: dict


def _cast_output(arr: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """Float32 frames to the output dtype; integer targets are rounded
    and clipped to the dtype's range."""
    if arr.dtype == dtype:
        return arr
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(arr), info.min, info.max).astype(dtype)
    return arr.astype(dtype)


class MotionCorrector:
    """Register every frame of a (T, H, W) stack to a reference frame
    and resample it.

    `device`: None runs on the card and raises when there is none;
    "cpu" runs every kernel's plain version (the tests' route).
    `reference`: a frame index, "first", "mean" (mean of the first
    `reference_window` frames) or an explicit (H, W) array.
    `config` / **overrides: a CorrectorConfig or keyword overrides.
    """

    def __init__(
        self,
        model: str = "translation",
        reference=0,
        config: CorrectorConfig | None = None,
        device=None,
        reference_window: int = 16,
        template_iters: int = 0,
        template_update_every: int = 0,
        mesh=None,
        **overrides,
    ):
        if template_iters or template_update_every:
            raise NotImplementedError(
                "template refinement / rolling templates are not ported "
                "yet (ROADMAP.md queue 1 item 15)"
            )
        if mesh is not None:
            raise NotImplementedError(
                "multi-device meshes are not ported yet (ROADMAP.md queue 1 "
                "item 17)"
            )
        base = config if config is not None else CorrectorConfig()
        self.config = base.replace(model=model, **overrides)
        self.backend = TorchBackend(self.config, device=device)
        self.reference = reference
        self.reference_window = reference_window

    def _select_reference(self, stack: np.ndarray) -> np.ndarray:
        ref = self.reference
        if isinstance(ref, np.ndarray):
            if ref.shape != stack.shape[1:]:
                raise ValueError(
                    f"reference shape {ref.shape} != frame shape {stack.shape[1:]}"
                )
            return np.asarray(ref, np.float32)
        if isinstance(ref, str) and ref == "first":
            return np.asarray(stack[0], np.float32)
        if isinstance(ref, str) and ref == "mean":
            n = min(self.reference_window, len(stack))
            return np.mean(stack[:n], axis=0, dtype=np.float32)
        if isinstance(ref, (int, np.integer)):
            idx = int(ref)
            if not -len(stack) <= idx < len(stack):
                raise ValueError(
                    f"reference index {idx} out of range for {len(stack)} frames"
                )
            return np.asarray(stack[idx], np.float32)
        raise ValueError(f"bad reference selector: {ref!r}")

    @staticmethod
    def _pad_batch(batch: np.ndarray, idx: np.ndarray, B: int):
        """Pad a tail batch to B frames by repeating its last frame;
        returns (n_valid, frames, indices)."""
        n = len(batch)
        if n < B:
            batch = np.concatenate([batch, np.repeat(batch[-1:], B - n, axis=0)])
            idx = np.concatenate([idx, np.repeat(idx[-1:], B - n)])
        return n, batch, idx

    def _rescue_flagged(self, host: dict, batch: np.ndarray, n: int, ref: dict) -> None:
        """Re-warp frames K3 zeroed (warp_ok False) through the exact
        gather path, in place; `warp_rescued` records which."""
        ok = np.asarray(host["warp_ok"], bool)
        host["warp_rescued"] = ~ok
        if ok.all() or not self.config.rescue_warp:
            return
        bad = np.nonzero(~ok)[0]
        sub = {"transform": host["transform"][bad]}
        rescued = self.backend.rescue_warp(batch[:n][bad], sub, ref=ref)
        corrected = np.array(host["corrected"])
        corrected[bad] = rescued
        transforms = np.array(host["transform"])
        transforms[bad] = sub["transform"]
        host["corrected"], host["transform"] = corrected, transforms
        host["warp_ok"] = np.ones_like(ok)

    def correct(self, stack, output_dtype="float32") -> CorrectionResult:
        """Correct a (T, H, W) stack. `output_dtype`: "float32", "input"
        (the stack's dtype; integers rounded and clipped) or a dtype."""
        stack = np.asarray(stack)
        if stack.ndim != 3:
            raise ValueError(f"stack must be (T, H, W), got shape {stack.shape}")
        out_dt = np.dtype(stack.dtype if output_dtype == "input" else output_dtype)
        t0 = time.perf_counter()
        ref = self.backend.prepare_reference(self._select_reference(stack))
        B = self.config.batch_size
        outs = []
        for lo in range(0, len(stack), B):
            hi = min(lo + B, len(stack))
            n, batch, idx = self._pad_batch(
                np.asarray(stack[lo:hi], np.float32), np.arange(lo, hi), B
            )
            host = {k: v[:n] for k, v in self.backend.process_batch(batch, ref, idx).items()}
            self._rescue_flagged(host, batch, n, ref)
            outs.append(host)
        merged = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        seconds = time.perf_counter() - t0
        corrected = _cast_output(merged.pop("corrected"), out_dt)
        transforms = merged.pop("transform")
        return CorrectionResult(
            corrected=corrected,
            transforms=transforms,
            diagnostics=merged,
            timing={
                "seconds": seconds,
                "frames_per_sec": len(stack) / seconds if seconds > 0 else None,
                "device": str(self.backend.device),
            },
        )
