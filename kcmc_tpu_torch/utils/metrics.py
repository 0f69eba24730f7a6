"""Transform- and field-error metrics (numpy only), the run's recovery
report and per-stage timing, copied from kcmc_tpu.utils.metrics.

Transform error is the RMS control-point displacement, in pixels, that
an estimated ref -> frame transform induces relative to ground truth
over a 9x9 grid inset 10% from the borders; field error the RMS
endpoint error of patch-grid displacement fields.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np


def control_points(shape: tuple[int, ...], n_per_axis: int = 9) -> np.ndarray:
    """(N, d) control points in (x, y[, z]) order, inset 10% from borders."""
    axes = [
        np.linspace(0.1 * (s - 1), 0.9 * (s - 1), n_per_axis, dtype=np.float32)
        for s in shape
    ]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in reversed(mesh)], axis=-1)


def _apply_np(M: np.ndarray, pts: np.ndarray) -> np.ndarray:
    d = pts.shape[-1]
    lin = pts @ M[:d, :d].T + M[:d, d]
    w = pts @ M[d, :d] + M[d, d]
    return lin / np.where(np.abs(w) < 1e-8, 1e-8, w)[..., None]


def transform_rmse(
    est: np.ndarray, gt: np.ndarray, shape: tuple[int, ...], n_per_axis: int = 9
) -> float:
    """RMS control-point displacement error between two (T, d+1, d+1)
    stacks of ref -> frame transforms, in pixels."""
    pts = control_points(shape, n_per_axis)
    errs = []
    for Me, Mg in zip(np.asarray(est), np.asarray(gt)):
        diff = _apply_np(Me, pts) - _apply_np(Mg, pts)
        errs.append(np.sum(diff * diff, axis=-1))
    return float(np.sqrt(np.mean(np.stack(errs))))


def relative_transforms(gt: np.ndarray, ref_index: int = 0) -> np.ndarray:
    """Ground truth re-expressed relative to frame `ref_index`:
    gt_t @ inv(gt_ref), the target of an estimate against that frame."""
    inv = np.linalg.inv(gt[ref_index])
    return np.stack([M @ inv for M in np.asarray(gt)])


def field_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMS endpoint error between (T, gh, gw, 2) displacement fields (px)."""
    diff = np.asarray(est, np.float64) - np.asarray(gt, np.float64)
    return float(np.sqrt(np.mean(np.sum(diff * diff, axis=-1))))


def crispness(stack: np.ndarray) -> float:
    """Crispness of a stack's MEAN image (kcmc_tpu/utils/metrics.py:76):
    the Frobenius norm of its gradient field, normalized by the mean
    image's own Frobenius norm.

    The standard stack-level motion-correction quality score
    (NoRMCorre-style): residual motion blurs the temporal mean, so a
    better-corrected stack has a sharper mean image and a HIGHER
    crispness. Unitless and scale-invariant (the normalization divides
    out contrast).

        before = crispness(stack)
        after = crispness(res.corrected)   # expect after > before

    `stack` is (T, H, W) or (T, D, H, W) — always a STACK with a
    leading frame axis (a bare mean image would be indistinguishable
    from a (T, H, W) stack by shape). Singleton spatial axes (e.g. a
    single-plane volume) contribute no gradient term.
    """
    stack = np.asarray(stack, np.float32)
    if stack.ndim not in (3, 4):
        raise ValueError(
            f"crispness expects a (T, H, W) or (T, D, H, W) stack, "
            f"got shape {stack.shape}"
        )
    mean = stack.mean(axis=0)
    g2 = np.zeros_like(mean)
    for axis in range(mean.ndim):
        if mean.shape[axis] >= 2:
            g2 = g2 + np.gradient(mean, axis=axis) ** 2
    denom = float(np.linalg.norm(mean.ravel()))
    return float(np.sqrt(g2.ravel().sum()) / max(denom, 1e-12))


@dataclasses.dataclass
class RobustnessReport:
    """Per-run recovery telemetry (utils/faults.py's consumer side).

    Counts every rung of the degradation ladder a run touched: IO and
    device retries, batches failed over to the CPU failover backend,
    frames marked failed (and later rescued by `interpolate_failed`
    trajectory interpolation), and checkpoint parts quarantined on
    resume. Surfaced as ``CorrectionResult.timing["robustness"]``.
    """

    io_retries: int = 0  # chunk-read attempts beyond the first
    device_retries: int = 0  # device-batch attempts beyond the first
    backend_failovers: int = 0  # batches re-run on the failover backend
    failed_frame_indices: list = dataclasses.field(default_factory=list)
    failover_frame_indices: list = dataclasses.field(default_factory=list)
    rescued_frames: int = 0  # failed frames trajectory-interpolated
    quarantined_parts: list = dataclasses.field(default_factory=list)
    faults_injected: int = 0  # faults a FaultPlan actually fired
    # serve-plane counters (serve/): per-session journal durability and
    # the idempotent-submit dedup; zero on one-shot runs
    journal_saves: int = 0  # durable session-journal snapshots written
    journal_failures: int = 0  # journal writes that failed (advised)
    deduped_frames: int = 0  # replayed submit frames dropped by dedup
    resumed_from_frame: int = -1  # journal-resume cursor (-1 = fresh)

    @property
    def failed_frames(self) -> int:
        return len(self.failed_frame_indices)

    def any(self) -> bool:
        return bool(
            self.io_retries
            or self.device_retries
            or self.backend_failovers
            or self.failed_frame_indices
            or self.rescued_frames
            or self.quarantined_parts
            or self.faults_injected
            or self.journal_saves
            or self.journal_failures
            or self.deduped_frames
            or self.resumed_from_frame >= 0
        )

    def as_dict(self) -> dict:
        """JSON-serializable summary (the timing payload); the serve-only
        keys appear only when serving touched them."""
        out = {
            "io_retries": int(self.io_retries),
            "device_retries": int(self.device_retries),
            "backend_failovers": int(self.backend_failovers),
            "failover_frames": len(self.failover_frame_indices),
            "failed_frames": int(self.failed_frames),
            "rescued_frames": int(self.rescued_frames),
            "quarantined_parts": [str(p) for p in self.quarantined_parts],
            "faults_injected": int(self.faults_injected),
        }
        if self.journal_saves or self.journal_failures:
            out["journal_saves"] = int(self.journal_saves)
            out["journal_failures"] = int(self.journal_failures)
        if self.deduped_frames:
            out["deduped_frames"] = int(self.deduped_frames)
        if self.resumed_from_frame >= 0:
            out["resumed_from_frame"] = int(self.resumed_from_frame)
        return out


@dataclasses.dataclass
class StageTimer:
    """Per-stage wall-clock timing with the streaming pipeline's stall
    accounting: time the consumer thread spent blocked on a seam that
    should overlap with device compute — waiting on the prefetch thread
    (`prefetch_wait`), synchronizing device outputs at drain
    (`drain_sync`), backpressured by the background writer
    (`writer_backpressure`), flushing it for a checkpoint
    (`writer_flush`), or updating the rolling template at a segment
    boundary (`template_update`). Stalls happen inside the stages and
    are reported separately as `stalls_s` / `stall_counts`
    (kcmc_tpu/utils/metrics.py:211-272)."""

    totals: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=dict)
    stalls: dict = dataclasses.field(default_factory=dict)
    stall_counts: dict = dataclasses.field(default_factory=dict)
    # Optional obs.trace.Tracer: stage/stall intervals double as spans
    # in the exported Chrome trace. None (the default) costs one
    # attribute check per interval.
    tracer: object = None

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if self.tracer is not None:
                self.tracer.complete(name, t0, dt, cat="stage")

    @contextlib.contextmanager
    def stall(self, name: str):
        """Time one blocking wait on a pipeline seam."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.stalls[name] = self.stalls.get(name, 0.0) + dt
            self.stall_counts[name] = self.stall_counts.get(name, 0) + 1
            if self.tracer is not None:
                self.tracer.complete(name, t0, dt, cat="stall")

    def add_stall(self, name: str, seconds: float, count: int = 1,
                  trace: bool = True) -> None:
        """Accumulate stall seconds measured elsewhere. With `trace`
        (for a wait that just ended) an attached tracer gets a span
        back-dated to end now; `trace=False` is for end-of-run
        aggregates whose waits were already traced at source (the
        background writer's own backpressure and flush spans)."""
        self.stalls[name] = self.stalls.get(name, 0.0) + float(seconds)
        self.stall_counts[name] = self.stall_counts.get(name, 0) + count
        if trace and self.tracer is not None and seconds > 0:
            self.tracer.complete(
                name, time.perf_counter() - float(seconds), float(seconds),
                cat="stall",
            )

    @property
    def total_seconds(self) -> float:
        return sum(self.totals.values())

    def report(self, n_frames: int | None = None) -> dict:
        out = {
            "stages_s": dict(self.totals),
            "stage_counts": dict(self.counts),
            "stage_mean_s": {
                k: v / self.counts[k]
                for k, v in self.totals.items()
                if self.counts.get(k)
            },
            "total_s": self.total_seconds,
        }
        if self.stalls:
            out["stalls_s"] = dict(self.stalls)
            out["stall_counts"] = dict(self.stall_counts)
        if n_frames and self.total_seconds > 0:
            out["frames_per_sec"] = n_frames / self.total_seconds
        return out
