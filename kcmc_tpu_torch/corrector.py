"""`MotionCorrector` of the PyTorch port (translation, rigid, similarity,
affine, homography, piecewise and rigid3d slices, single-scale or
through the scale pyramid), and `apply_correction`.

Counterpart of `kcmc_tpu/corrector.py`'s `MotionCorrector.correct`
(:1318-1524) and `apply_correction` (:242): reference selection and
template refinement (`template_iters`), fixed-size batches with the tail
batch padded by repeating its last frame, rolling-template segments
(`template_update_every`: updates at absolute multiples of it, blended
on the host or, with `device_templates`, on the device), the batch
program with the warm-start seed of the previous batch, rescue of frames
the bounded warp flagged with the out-of-bound policy (warn, then
escalate the remaining batches to the exact gather warp;
kcmc_tpu/corrector.py:1990-2066), and the merge. `correct()` takes a
host array or a tensor (sliced where it lies), a frame range with global
frame indices, and `device_outputs`. `stream_view` gives per-stream
correctors that share one backend. The port dispatches synchronously.
Streaming, checkpoints and the robustness ladder are later slices
(ROADMAP.md queue 1 item 15b).
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from kcmc_tpu_torch.backends.torch_backend import TorchBackend
from kcmc_tpu_torch.config import CorrectorConfig
from kcmc_tpu_torch.ops.warp import fast_apply_fields, fast_apply_matrix, warp_volume
from kcmc_tpu_torch.utils.device import resolve_device


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


def _resolve_dtype(output_dtype, input_dtype) -> np.dtype:
    """"input" keeps the stack's dtype (corrector.py:431)."""
    if isinstance(output_dtype, str) and output_dtype == "input":
        return np.dtype(input_dtype)
    return np.dtype(output_dtype)


def _stack_dtype(stack) -> np.dtype:
    if isinstance(stack, torch.Tensor):
        return np.dtype(str(stack.dtype).removeprefix("torch."))
    return stack.dtype


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def apply_correction(
    stack,
    transforms: np.ndarray | None = None,
    fields: np.ndarray | None = None,
    batch_size: int = 32,
    output_dtype="float32",
    device=None,
) -> np.ndarray:
    """Resample a stack through transforms or fields recovered earlier:
    register one channel with `MotionCorrector.correct`, apply its
    transforms to another (corrector.py:242).

    Exactly one of `transforms` ((T, 3, 3), or (T, 4, 4) for a (T, D, H,
    W) stack) or `fields` ((T, gh, gw, 2), 2D stacks) must be given.
    Batches of `batch_size` frames go to `device` (the card unless
    "cpu"): 2D matrix applies through `fast_apply_matrix` (K7 on the
    card), field applies through `fast_apply_fields` (K8 on the card),
    each with an exact per-frame gather for the frames the kernel flags;
    on the CPU the gather; volumes through the trilinear gather. Integer
    `output_dtype` rounds and clips ("input" keeps the stack's dtype).
    Returns numpy."""
    if (transforms is None) == (fields is None):
        raise ValueError("pass exactly one of transforms= or fields=")
    if not isinstance(stack, torch.Tensor):
        stack = np.asarray(stack)
    if fields is not None and stack.ndim != 3:
        raise ValueError(
            "fields= (piecewise) applies to 2D (T, H, W) stacks only; "
            f"got stack shape {tuple(stack.shape)}"
        )
    n = len(stack)
    maps = transforms if transforms is not None else fields
    if len(maps) != n:
        raise ValueError(f"stack has {n} frames but {len(maps)} transforms/fields")
    if transforms is not None:
        want = 4 if stack.ndim == 4 else 3
        if np.asarray(transforms).shape[-1] != want:
            raise ValueError(
                f"stack of rank {stack.ndim} needs ({want}, {want}) "
                f"transforms, got {np.asarray(transforms).shape[-2:]} — "
                "a 4x4 rigid3d registration cannot be applied to a 2D "
                "stack (and vice versa)"
            )
    out_dt = _resolve_dtype(output_dtype, _stack_dtype(stack))
    if n == 0:
        return np.empty(tuple(stack.shape), out_dt)
    dev = resolve_device(device)
    maps = torch.as_tensor(np.asarray(maps, np.float32))
    if transforms is not None and stack.ndim == 4:
        def warp(fr, m):
            return warp_volume(fr, m)
    elif transforms is not None:
        def warp(fr, m):
            return fast_apply_matrix(fr, m)
    else:
        def warp(fr, m):
            return fast_apply_fields(fr, m)
    outs = []
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        fr = torch.as_tensor(stack[lo:hi], device=dev).to(torch.float32).contiguous()
        got = warp(fr, maps[lo:hi].to(dev).contiguous())
        outs.append(_cast_output(got.cpu().numpy(), out_dt))
    return np.concatenate(outs)


class MotionCorrector:
    """Register every frame of a (T, H, W) stack (model="rigid3d": every
    volume of a (T, D, H, W) z-stack series) to a reference and resample
    it.

    `device`: None runs on the card and raises when there is none;
    "cpu" runs every kernel's plain version (the tests' route).
    `backend`: None or "torch" builds a TorchBackend; a TorchBackend
    instance is shared (the serving seam; its config must equal this
    corrector's, and its device is used).
    `reference`: a frame index, "first", "mean" (mean of the first
    `reference_window` frames) or an explicit (H, W) / (D, H, W) array.
    `template_iters`: rounds of template refinement (register the first
    `template_window` frames, default max(reference_window, 32), and
    take the mean of those the warp kept as the new reference).
    `template_update_every` / `template_update_alpha`: rolling template
    updates every that many frames, (1 - alpha) * template + alpha *
    the mean of the last `template_window` corrected frames.
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
        template_window: int | None = None,
        template_update_every: int = 0,
        template_update_alpha: float = 0.5,
        mesh=None,
        backend=None,
        **overrides,
    ):
        base = config if config is not None else CorrectorConfig()
        self.config = base.replace(model=model, **overrides)
        if isinstance(backend, TorchBackend):
            if mesh is not None:
                raise ValueError(
                    "mesh= cannot be combined with a backend instance "
                    "(the instance already owns its mesh)"
                )
            if backend.config != self.config:
                raise ValueError(
                    "shared backend instance was built for a different "
                    "CorrectorConfig than this corrector's — construct "
                    "the corrector with the backend's config (serve "
                    "sessions must not change compiled-program knobs)"
                )
            self.backend = backend
        elif backend in (None, "torch"):
            if mesh is not None:
                raise NotImplementedError(
                    "multi-device meshes are not ported yet (ROADMAP.md queue 1 "
                    "item 17)"
                )
            self.backend = TorchBackend(self.config, device=device)
        else:
            raise ValueError(f"backend must be 'torch' or a TorchBackend, got {backend!r}")
        self.reference = reference
        self.reference_window = reference_window
        self.template_iters = template_iters
        self.template_window = (
            template_window if template_window is not None else max(reference_window, 32)
        )
        if self.template_window < 1:
            raise ValueError(
                f"template_window must be >= 1 frame, got {self.template_window}"
            )
        if template_update_every < 0:
            raise ValueError(
                f"template_update_every must be >= 0 frames, got {template_update_every}"
            )
        if not 0.0 < template_update_alpha <= 1.0:
            raise ValueError(
                f"template_update_alpha must be in (0, 1], got {template_update_alpha}"
            )
        self.template_update_every = template_update_every
        self.template_update_alpha = template_update_alpha
        self._escalation_backend = None
        self._reset_rescue_policy()

    def stream_view(self, reference=None, template_update_every: int | None = None,
                    template_update_alpha: float | None = None) -> MotionCorrector:
        """A per-stream corrector that shares this corrector's backend
        (corrector.py:757): it builds no backend and holds its own
        reference, rolling-template cadence and rescue counters."""
        return MotionCorrector(
            model=self.config.model,
            backend=self.backend,
            reference=self.reference if reference is None else reference,
            config=self.config,
            reference_window=self.reference_window,
            template_iters=self.template_iters,
            template_window=self.template_window,
            template_update_every=(self.template_update_every
                                   if template_update_every is None
                                   else template_update_every),
            template_update_alpha=(self.template_update_alpha
                                   if template_update_alpha is None
                                   else template_update_alpha),
        )

    def _reset_rescue_policy(self) -> None:
        """Out-of-bound telemetry, the escalation decision and the warm
        start's seed, reset at the start of every correct()
        (corrector.py:1627-1642)."""
        self._rescue_seen = 0
        self._rescue_count = 0
        self._rescue_window: list[tuple[int, int]] = []  # (frames, rescued)
        self._escalated = False
        self._escalated_at = None  # first frame the escalation backend took
        self._rescue_warned = False
        self._warm_seed = None

    def _get_escalation_backend(self) -> TorchBackend:
        """The same backend with warp="jnp" (exact, unbounded), built the
        first time the escalation trips; it takes the reference prepared
        by the main backend."""
        if self._escalation_backend is None:
            self._escalation_backend = TorchBackend(
                self.config.replace(warp="jnp"), device=self.backend.device
            )
        return self._escalation_backend

    def _select_reference(self, stack):
        """The reference frame: an explicit array, or a slice of the
        stack (a tensor stack is sliced where it lies, then the one frame
        or window is converted)."""
        ref = self.reference
        if isinstance(ref, (np.ndarray, torch.Tensor)):
            if tuple(ref.shape) != tuple(stack.shape[1:]):
                raise ValueError(
                    f"reference shape {tuple(ref.shape)} != frame shape "
                    f"{tuple(stack.shape[1:])}"
                )
            return ref.float() if isinstance(ref, torch.Tensor) else np.asarray(ref, np.float32)
        if isinstance(ref, str) and ref == "first":
            ref = 0
        if isinstance(ref, str) and ref == "mean":
            n = min(self.reference_window, len(stack))
            if isinstance(stack, torch.Tensor):
                return stack[:n].float().mean(dim=0)
            return np.mean(stack[:n], axis=0, dtype=np.float32)
        if isinstance(ref, (int, np.integer)):
            idx = int(ref)
            if not -len(stack) <= idx < len(stack):
                raise ValueError(
                    f"reference index {idx} out of range for {len(stack)} frames"
                )
            if isinstance(stack, torch.Tensor):
                return stack[idx].float()
            return np.asarray(stack[idx], np.float32)
        raise ValueError(f"bad reference selector: {ref!r}")

    @staticmethod
    def _pad_batch(batch, idx: np.ndarray, B: int):
        """Pad a tail batch to B frames by repeating its last frame;
        returns (n_valid, frames, indices). A tensor batch stays where it
        lies."""
        n = len(batch)
        if n < B:
            if isinstance(batch, torch.Tensor):
                batch = torch.cat([batch, batch[-1:].expand(B - n, *batch.shape[1:])])
            else:
                batch = np.concatenate([batch, np.repeat(batch[-1:], B - n, axis=0)])
            idx = np.concatenate([idx, np.repeat(idx[-1:], B - n)])
        return n, batch, idx

    def _segment_bounds(self, start: int, stop: int) -> list[tuple[int, int]]:
        """Frame ranges between rolling-template updates: boundaries at
        absolute multiples of `template_update_every`, so chunked runs
        update at the same frames as one-shot runs (corrector.py:1532)."""
        E = self.template_update_every
        if E <= 0:
            return [(start, stop)]
        bounds, lo = [], start
        while lo < stop:
            hi = min(stop, (lo // E + 1) * E)
            bounds.append((lo, hi))
            lo = hi
        return bounds

    def _refine_reference(self, stack, ref_frame):
        """`template_iters` rounds: register the first `template_window`
        frames to the current reference (no quality metric, no rescue)
        and take the mean of the frames with warp_ok; stop when none has
        it (corrector.py:1188)."""
        W = min(len(stack), self.template_window)
        B = self.config.batch_size
        for _ in range(self.template_iters):
            ref = dict(self.backend.prepare_reference(ref_frame), _skip_quality=True)
            corrected, ok = [], []
            for lo in range(0, W, B):
                hi = min(lo + B, W)
                n, batch, idx = self._pad_batch(stack[lo:hi], np.arange(lo, hi), B)
                out = self.backend.process_batch(batch, ref, idx)
                corrected.append(out["corrected"][:n])
                ok.append(np.asarray(out["warp_ok"][:n], bool))
            frames = np.concatenate(corrected)[np.concatenate(ok)]
            if len(frames) == 0:  # every warp out of bounds: keep the ref
                break
            ref_frame = np.mean(frames, axis=0, dtype=np.float32)
        return ref_frame

    def _rolled_template(self, ref_frame, tail_corrected, tail_ok, window: int) -> np.ndarray:
        """One rolling update on the host: blend the mean of the last
        `window` frames the warp kept into the template, or keep it when
        there are none (corrector.py:1235)."""
        if not tail_corrected:
            return ref_frame
        frames = np.concatenate([_host(c).astype(np.float32) for c in tail_corrected])[-window:]
        ok = np.concatenate([_host(k).astype(bool) for k in tail_ok])[-window:]
        frames = frames[ok]
        if len(frames) == 0:
            return ref_frame
        mean = np.mean(frames, axis=0, dtype=np.float32)
        a = self.template_update_alpha
        return (1.0 - a) * _host(ref_frame).astype(np.float32) + a * mean

    def _template_tail(self, outs: list[dict], window: int):
        """(corrected, warp_ok) arrays covering the last `window` frames of
        the merged batch outputs (corrector.py:1298)."""
        tail_c, tail_ok, have = [], [], 0
        for host in reversed(outs):
            c = host["corrected"]
            k = host.get("warp_ok")
            k = np.ones(len(c), bool) if k is None else _host(k).astype(bool)
            take = min(len(c), window - have)
            tail_c.append(c[len(c) - take:])
            tail_ok.append(k[len(k) - take:])
            have += take
            if have >= window:
                break
        return list(reversed(tail_c)), list(reversed(tail_ok))

    @staticmethod
    def _collect_tail(tail: list, n: int, out: dict, window: int) -> None:
        """Keep each batch's (n_valid, corrected, warp_ok) device outputs,
        before any rescue, trimmed to batches covering the last `window`
        frames (corrector.py:1260)."""
        tail.append((n, out["corrected"], out.get("warp_ok")))
        while len(tail) > 1 and sum(t[0] for t in tail) - tail[0][0] >= window:
            tail.pop(0)

    def _update_reference_device(self, ref: dict, dev_tail: list, window: int) -> dict:
        """One update through the backend's `update_reference`; consumes
        the collected tail (corrector.py:1281)."""
        ref = self.backend.update_reference(
            ref,
            [c[:n] for n, c, _ in dev_tail],
            [np.ones(n, bool) if k is None else k[:n] for n, _, k in dev_tail],
            window,
            self.template_update_alpha,
        )
        dev_tail.clear()
        return ref

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

    def _rescue_flagged(self, host: dict, batch, n: int, ref: dict) -> None:
        """Re-warp frames the bounded warp (K3, K7, K8, the separable
        chain or the rigid3d volume warp) zeroed (warp_ok False) through
        the exact gather path, in place; `warp_rescued` records which,
        and with `quality_metrics` their template_corr is recomputed
        (corrector.py:2093). Counts the batch for the out-of-bound policy
        first: the window holds the newest batches totalling at least
        max(256, 4 x batch) frames (corrector.py:2051-2066)."""
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
        if "template_corr" in host and ref is not None:
            dev = self.backend.device
            maps = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                    for k, v in sub.items()}
            corr, _ = self.backend.quality(
                torch.as_tensor(rescued, device=dev), maps, ref["frame"])
            tc = np.array(host["template_corr"])
            tc[bad] = corr.cpu().numpy()
            host["template_corr"] = tc

    def correct(self, stack, start_frame: int = 0, end_frame: int | None = None,
                progress: bool = False, device_outputs: bool = False,
                output_dtype="float32") -> CorrectionResult:
        """Correct a (T, H, W) stack, or a (T, D, H, W) one for rigid3d.

        `stack`: a numpy array, or a tensor (a CUDA tensor is sliced on
        the card, never copied whole to the host). `start_frame` /
        `end_frame` bound the frames processed; indices stay global, so
        chunked runs give the one-shot run's transforms (a rolling
        template restarts from the initial template in each call).
        `progress` prints "[kcmc] frames {hi}/{T}" per batch.
        `device_outputs` returns the arrays as tensors on the backend's
        device, without the rescue, in float32 (`output_dtype` ignored).
        `output_dtype`: "float32", "input" (the stack's dtype; integers
        rounded and clipped) or a dtype."""
        if not isinstance(stack, torch.Tensor):
            stack = np.asarray(stack)
        if stack.ndim not in (3, 4):
            raise ValueError(
                f"stack must be (T, H, W) or (T, D, H, W), got shape {tuple(stack.shape)}"
            )
        if stack.ndim == 4 and self.config.model != "rigid3d":
            raise ValueError(
                "4D (volumetric) stacks require model='rigid3d', got "
                f"{self.config.model!r}"
            )
        if stack.ndim == 3 and self.config.model == "rigid3d":
            raise ValueError("model='rigid3d' requires a (T, D, H, W) stack")
        cfg = self.config
        T = len(stack) if end_frame is None else min(end_frame, len(stack))
        t0 = time.perf_counter()
        self._reset_rescue_policy()
        ref_frame = self._select_reference(stack)
        if self.template_iters > 0:
            ref_frame = self._refine_reference(stack, ref_frame)
        ref = self.backend.prepare_reference(ref_frame)
        B = cfg.batch_size
        do_rescue = cfg.rescue_warp and not device_outputs
        warm = cfg.warm_start and cfg.model != "piecewise"
        segs = self._segment_bounds(start_frame, T)
        dev_tmpl = len(segs) > 1 and cfg.device_templates
        E = self.template_update_every
        tail_window = min(self.template_window, E) if E > 0 else 0
        dev_tail: list[tuple] = []
        outs = []
        n_updates = 0
        for si, (slo, shi) in enumerate(segs):
            for lo in range(slo, shi, B):
                hi = min(lo + B, shi)
                n, batch, idx = self._pad_batch(stack[lo:hi], np.arange(lo, hi), B)
                backend = self._get_escalation_backend() if self._escalated else self.backend
                seed = (self._warm_seed, True) if warm and self._warm_seed is not None else None
                out = backend.process_batch(batch, ref, idx, seed=seed, to_host=False)
                if warm:
                    # the newest transform seeds the next batch's consensus
                    self._warm_seed = out["transform"][n - 1]
                if dev_tmpl:
                    self._collect_tail(dev_tail, n, out, tail_window)
                if device_outputs:
                    host = {k: v[:n] for k, v in out.items()}
                else:
                    host = {k: v[:n] for k, v in backend.to_host(out).items()}
                    if do_rescue:
                        self._rescue_flagged(host, batch, n, ref)
                outs.append(host)
                if progress:
                    print(f"[kcmc] frames {hi}/{T}", flush=True)
            if si < len(segs) - 1:  # rolling template update
                W = min(self.template_window, shi - slo)
                n_updates += 1
                if dev_tmpl:
                    ref = self._update_reference_device(ref, dev_tail, W)
                    ref_frame = ref["frame"]
                else:
                    tail_c, tail_ok = self._template_tail(outs, W)
                    ref_frame = self._rolled_template(ref_frame, tail_c, tail_ok, W)
                    ref = self.backend.prepare_reference(ref_frame)
        if device_outputs:
            cat = torch.cat
            empty = torch.empty((0,) + tuple(stack.shape[1:]), dtype=torch.float32,
                                device=self.backend.device)
        else:
            cat = np.concatenate
            empty = np.empty((0,) + tuple(stack.shape[1:]), np.float32)
        merged = {k: cat([o[k] for o in outs]) for k in outs[0]} if outs else {}
        seconds = time.perf_counter() - t0
        corrected = merged.pop("corrected", empty)
        if not device_outputs:
            corrected = _cast_output(corrected, _resolve_dtype(output_dtype, _stack_dtype(stack)))
        n_frames = max(T - start_frame, 0)
        return CorrectionResult(
            corrected=corrected,
            transforms=merged.pop("transform", None),
            fields=merged.pop("field", None),
            diagnostics=merged,
            timing={
                "seconds": seconds,
                "frames_per_sec": n_frames / seconds if seconds > 0 else None,
                "device": str(self.backend.device),
                "warp_escalated": self._escalated,
                "warp_escalated_at": self._escalated_at,
                "pipeline": {"template_updates": n_updates,
                             "device_templates": bool(dev_tmpl)},
            },
        )
