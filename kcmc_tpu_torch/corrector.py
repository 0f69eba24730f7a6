"""`MotionCorrector` of the PyTorch port (translation, rigid, similarity,
affine, homography, piecewise and rigid3d slices, single-scale or
through the scale pyramid).

Counterpart of the one-shot path of `kcmc_tpu/corrector.py`
(`MotionCorrector.correct`): reference selection, fixed-size batches
with the tail batch padded by repeating its last frame, the batch
program, rescue of frames the bounded warp flagged with the out-of-bound
policy (warn, then escalate the remaining batches to the exact gather
warp; kcmc_tpu/corrector.py:1990-2066), and the merge. Streaming,
checkpoints, template refinement and the robustness ladder are later
slices (ROADMAP.md queue 1 item 15).
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np

from kcmc_tpu_torch.backends.torch_backend import TorchBackend
from kcmc_tpu_torch.config import CorrectorConfig


@dataclasses.dataclass
class CorrectionResult:
    corrected: np.ndarray  # (T, H, W), or (T, D, H, W) for rigid3d
    transforms: np.ndarray | None  # (T, 3, 3) ref -> frame maps ((T, 4, 4)
    # for rigid3d); None for piecewise
    diagnostics: dict  # per-frame arrays
    timing: dict
    fields: np.ndarray | None = None  # (T, gh, gw, 2) for piecewise


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
    """Register every frame of a (T, H, W) stack (model="rigid3d": every
    volume of a (T, D, H, W) z-stack series) to a reference and resample
    it.

    `device`: None runs on the card and raises when there is none;
    "cpu" runs every kernel's plain version (the tests' route).
    `reference`: a frame index, "first", "mean" (mean of the first
    `reference_window` frames) or an explicit (H, W) / (D, H, W) array.
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
        self._escalation_backend = None
        self._reset_rescue_policy()

    def _reset_rescue_policy(self) -> None:
        """Out-of-bound telemetry and the escalation decision, reset at
        the start of every correct() (corrector.py:1627-1636)."""
        self._rescue_seen = 0
        self._rescue_count = 0
        self._rescue_window: list[tuple[int, int]] = []  # (frames, rescued)
        self._escalated = False
        self._escalated_at = None  # first frame the escalation backend took
        self._rescue_warned = False

    def _get_escalation_backend(self) -> TorchBackend:
        """The same backend with warp="jnp" (exact, unbounded), built the
        first time the escalation trips; it takes the reference prepared
        by the main backend."""
        if self._escalation_backend is None:
            self._escalation_backend = TorchBackend(
                self.config.replace(warp="jnp"), device=self.backend.device
            )
        return self._escalation_backend

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

    def _maybe_escalate(self) -> None:
        """When more than `rescue_warn_fraction` of the frames seen so far,
        or of the sliding window, took the rescue, warn once and (with
        `rescue_escalate`) switch the remaining batches to the exact
        gather warp (corrector.py:2002-2045)."""
        cfg = self.config
        if self._rescue_warned or self._rescue_seen < cfg.batch_size:
            return
        frac = self._rescue_count / max(self._rescue_seen, 1)
        wn = sum(n for n, _ in self._rescue_window)
        wr = sum(r for _, r in self._rescue_window)
        if wn >= cfg.batch_size:
            frac = max(frac, wr / wn)
        if frac <= cfg.rescue_warn_fraction:
            return
        self._rescue_warned = True
        detail = (
            f"{self._rescue_count}/{self._rescue_seen} frames "
            f"({100.0 * frac:.0f}%) exceeded the bounded warp kernel's "
            "static motion bound and took the per-frame exact-warp "
            "rescue path"
        )
        if cfg.rescue_escalate:
            self._escalated = True
            self._escalated_at = self._rescue_seen
            warnings.warn(
                f"kcmc: {detail}; switching the remaining batches to the "
                "exact unbounded warp (one recompile, then full batch "
                "speed). Raise max_shear_px / set max_rotation_deg to "
                "keep such stacks on the fast bounded kernels.",
                RuntimeWarning, stacklevel=3,
            )
        else:
            warnings.warn(
                f"kcmc: {detail}. Use warp='jnp', or raise max_shear_px / "
                "set max_rotation_deg, for stacks with persistently "
                "large motion.",
                RuntimeWarning, stacklevel=3,
            )

    def _rescue_flagged(self, host: dict, batch: np.ndarray, n: int, ref: dict) -> None:
        """Re-warp frames the bounded warp (K3, K7, K8, the separable
        chain or the rigid3d volume warp) zeroed (warp_ok False) through
        the exact gather path, in place; `warp_rescued` records which.
        Counts the batch for the out-of-bound policy first: the window
        holds the newest batches totalling at least max(256, 4 x batch)
        frames (corrector.py:2051-2066)."""
        ok = np.asarray(host["warp_ok"], bool)
        host["warp_rescued"] = ~ok
        n_bad = int((~ok).sum())
        self._rescue_seen += len(ok)
        self._rescue_count += n_bad
        self._rescue_window.append((len(ok), n_bad))
        win = max(256, 4 * self.config.batch_size)
        while sum(m for m, _ in self._rescue_window[:-1]) >= win:
            self._rescue_window.pop(0)
        self._maybe_escalate()
        if ok.all():
            return
        bad = np.nonzero(~ok)[0]
        sub = {k: host[k][bad] for k in ("transform", "field") if k in host}
        rescued = self.backend.rescue_warp(batch[:n][bad], sub, ref=ref)
        corrected = np.array(host["corrected"])
        corrected[bad] = rescued
        host["corrected"] = corrected
        if "transform" in sub:
            # the rescue polished the flagged frames' transforms
            transforms = np.array(host["transform"])
            transforms[bad] = sub["transform"]
            host["transform"] = transforms
        host["warp_ok"] = np.ones_like(ok)

    def correct(self, stack, output_dtype="float32") -> CorrectionResult:
        """Correct a (T, H, W) stack, or a (T, D, H, W) one for rigid3d.
        `output_dtype`: "float32", "input" (the stack's dtype; integers
        rounded and clipped) or a dtype."""
        stack = np.asarray(stack)
        if stack.ndim not in (3, 4):
            raise ValueError(
                f"stack must be (T, H, W) or (T, D, H, W), got shape {stack.shape}"
            )
        if stack.ndim == 4 and self.config.model != "rigid3d":
            raise ValueError(
                "4D (volumetric) stacks require model='rigid3d', got "
                f"{self.config.model!r}"
            )
        if stack.ndim == 3 and self.config.model == "rigid3d":
            raise ValueError("model='rigid3d' requires a (T, D, H, W) stack")
        out_dt = np.dtype(stack.dtype if output_dtype == "input" else output_dtype)
        t0 = time.perf_counter()
        self._reset_rescue_policy()
        ref = self.backend.prepare_reference(self._select_reference(stack))
        B = self.config.batch_size
        outs = []
        for lo in range(0, len(stack), B):
            hi = min(lo + B, len(stack))
            n, batch, idx = self._pad_batch(
                np.asarray(stack[lo:hi], np.float32), np.arange(lo, hi), B
            )
            backend = self._get_escalation_backend() if self._escalated else self.backend
            host = {k: v[:n] for k, v in backend.process_batch(batch, ref, idx).items()}
            if self.config.rescue_warp:
                self._rescue_flagged(host, batch, n, ref)
            outs.append(host)
        merged = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        seconds = time.perf_counter() - t0
        corrected = _cast_output(merged.pop("corrected"), out_dt)
        transforms = merged.pop("transform", None)
        fields = merged.pop("field", None)
        return CorrectionResult(
            corrected=corrected,
            transforms=transforms,
            fields=fields,
            diagnostics=merged,
            timing={
                "seconds": seconds,
                "frames_per_sec": len(stack) / seconds if seconds > 0 else None,
                "device": str(self.backend.device),
                "warp_escalated": self._escalated,
                "warp_escalated_at": self._escalated_at,
            },
        )
