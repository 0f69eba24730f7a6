"""Per-run observability coordinator (the port's copy of
kcmc_tpu/obs/run.py).

One object owns the run's tracer, frame-record stream, and heartbeat so
the orchestrator (`corrector.py`) carries a single nullable handle:
`RunTelemetry.begin(...)` returns None when every observability knob is
off — the disabled cost is one `is not None` check per batch — and
otherwise wires:

* the run manifest (obs/manifest.py), embedded in both artifacts;
* a `Tracer` attached to the run's `StageTimer` (stage/stall spans)
  and handed to the dispatch and writer seams;
* a `FrameRecordStream` fed from the drain path (`note_batch`);
* a `Heartbeat` narrating progress/stalls/robustness to stderr.

`finish(timing)` stamps the final timing into the trace metadata and
the records summary line; `close()` (idempotent, called from the
orchestrator's `finally`) guarantees the heartbeat thread is joined
and partial artifacts are flushed even when the run dies — a
post-mortem trace of a crashed run is the whole point.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

from kcmc_tpu_torch.obs.manifest import build_manifest

# -- concurrent-run artifact-path registry --------------------------------
#
# One process used to mean one run, so trace/records paths could be
# taken verbatim from the config. The serving layer multiplexes many
# simultaneous sessions through one process — two sessions armed with
# the same configured path would interleave writes into one file and
# corrupt both artifacts. Every live RunTelemetry therefore CLAIMS its
# artifact paths here; a second claimant of an already-live path gets a
# derived per-run filename (`run_id` inserted before the extension)
# instead. Sequential runs keep the exact configured path (claims are
# released at finish), so single-run behavior is unchanged.
_PATHS_LOCK = threading.Lock()
_ACTIVE_PATHS: set[str] = set()
_RUN_SEQ = itertools.count(1)


def next_run_id() -> str:
    """Process-unique short run id (used for serve session ids too)."""
    return f"r{os.getpid()}-{next(_RUN_SEQ):04d}"


def _claim_path(
    path: str | None, run_id: str, always_derive: bool = False
) -> str | None:
    """Claim `path` for this run; returns the path to actually write —
    the configured one when free, a `<stem>.<run_id><ext>` derivative
    when another live run already owns it. `always_derive=True` skips
    the verbatim claim entirely: serve sessions use it so SEQUENTIAL
    sessions of a long-lived server keep distinct artifacts instead of
    each overwriting the last (claims release at finish, so without it
    only concurrent sessions would get derived names)."""
    if not path:
        return path
    with _PATHS_LOCK:
        key = os.path.abspath(path)
        if not always_derive and key not in _ACTIVE_PATHS:
            _ACTIVE_PATHS.add(key)
            return path
        root, ext = os.path.splitext(path)
        derived = f"{root}.{run_id}{ext}"
        n = 2
        while os.path.abspath(derived) in _ACTIVE_PATHS:
            derived = f"{root}.{run_id}-{n}{ext}"
            n += 1
        _ACTIVE_PATHS.add(os.path.abspath(derived))
        return derived


def _release_path(path: str | None) -> None:
    if not path:
        return
    with _PATHS_LOCK:
        _ACTIVE_PATHS.discard(os.path.abspath(path))


class RunTelemetry:
    @classmethod
    def begin(
        cls, config, backend=None, backend_name=None, timer=None,
        report=None, total=None, run_id=None, derive_paths=False,
    ):
        """Construct only when some observability surface is enabled;
        None otherwise (the hot paths test one attribute). The enabled
        predicate lives in `CorrectorConfig.observability_enabled` —
        one definition for this gate and the orchestrator's. `run_id`
        names the run in the manifest and in derived artifact paths
        (serve sessions pass their session id); autogenerated when
        omitted. `derive_paths=True` forces run-id-derived artifact
        filenames even when the configured path is free (serve: every
        session its own file)."""
        if not getattr(config, "observability_enabled", False):
            return None
        return cls(
            config, backend=backend, backend_name=backend_name,
            timer=timer, report=report, total=total, run_id=run_id,
            derive_paths=derive_paths,
        )

    def __init__(
        self, config, backend=None, backend_name=None, timer=None,
        report=None, total=None, run_id=None, derive_paths=False,
    ):
        self.config = config
        self.report = report  # RobustnessReport (may be None)
        self.timer = timer
        self.total = total
        self.frames_done = 0
        # Request-latency segment histograms (obs/latency.py): one-shot
        # runs record the dispatch/device/drain subset of the serve
        # vocabulary here (corrector._dispatch_batches), so batch and
        # serve share one latency schema in `timing["latency"]`.
        self.latency = None
        if getattr(config, "latency_telemetry", False):
            from kcmc_tpu_torch.obs.latency import SegmentLatencies

            self.latency = SegmentLatencies()
        self._t0 = time.perf_counter()
        self._finished = False
        self.run_id = run_id if run_id is not None else next_run_id()
        # Collision-safe artifact paths: concurrent runs in one process
        # (serve sessions) sharing a configured path each get their own
        # run-id-derived file instead of interleaving writes.
        self.trace_path = _claim_path(
            getattr(config, "trace_path", None), self.run_id,
            always_derive=derive_paths,
        )
        self.frame_records_path = _claim_path(
            getattr(config, "frame_records_path", None), self.run_id,
            always_derive=derive_paths,
        )
        try:
            self.manifest = build_manifest(
                config=config, backend=backend, backend_name=backend_name
            )
            self.manifest["run_id"] = self.run_id
            self.tracer = None
            if self.trace_path:
                from kcmc_tpu_torch.obs.trace import Tracer

                self.tracer = Tracer(metadata={"manifest": self.manifest})
                if timer is not None:
                    timer.tracer = self.tracer
                # Execution-plan compile events (jit_compile /
                # plan_build spans, plan_cache_hit/miss instants) from
                # any thread land on this trace while the run is live.
                from kcmc_tpu_torch.plans.runtime import add_tracer

                add_tracer(self.tracer)
            self.records = None
            if self.frame_records_path:
                from kcmc_tpu_torch.obs.records import FrameRecordStream

                self.records = FrameRecordStream(
                    self.frame_records_path,
                    manifest=self.manifest,
                    tracer=self.tracer,
                )
            self.heartbeat = None
            if getattr(config, "heartbeat_s", 0) > 0:
                from kcmc_tpu_torch.obs.heartbeat import Heartbeat

                self.heartbeat = Heartbeat(config.heartbeat_s, self._sample)
                self.heartbeat.start()
        except BaseException:
            # A failed construction never reaches finish(); releasing
            # here keeps the claims registry from treating the path as
            # live forever (which would silently divert every later run
            # in this process to derived filenames).
            if getattr(self, "tracer", None) is not None:
                from kcmc_tpu_torch.plans.runtime import discard_tracer

                discard_tracer(self.tracer)
            _release_path(self.trace_path)
            _release_path(self.frame_records_path)
            raise

    def set_total(self, total: int) -> None:
        self.total = int(total)

    def resumed(self, done: int) -> None:
        """The run restored `done` frames from a checkpoint: switch the
        frame-records sink to append mode (the killed run's records are
        the post-mortem — truncating them would destroy the artifact)
        and mark the resume point on the trace."""
        if self.records is not None:
            self.records.mark_resume(done)
        if self.tracer is not None:
            self.tracer.instant(
                "checkpoint_resume", cat="checkpoint",
                args={"done": int(done)},
            )

    # -- drain-path hook ---------------------------------------------------

    def note_batch(
        self, first_frame: int, n: int, host: dict, escalated: bool = False
    ) -> None:
        """Record one drained batch: progress for the heartbeat, a
        frames_done counter sample for the trace, and per-frame quality
        records. `host` is the drained output dict (post-rescue)."""
        self.frames_done += int(n)
        if self.tracer is not None:
            self.tracer.counter("frames_done", {"frames": self.frames_done})
        if self.records is not None:
            from kcmc_tpu_torch.obs.records import records_from_batch

            rep = self.report
            failed = (
                frozenset(rep.failed_frame_indices)
                if rep is not None and rep.failed_frame_indices
                else frozenset()
            )
            failover = (
                frozenset(rep.failover_frame_indices)
                if rep is not None
                and getattr(rep, "failover_frame_indices", None)
                else frozenset()
            )
            self.records.append(
                records_from_batch(
                    int(first_frame),
                    host,
                    model=self.config.model,
                    n=int(n),
                    failed=failed,
                    failover=failover,
                    escalated=escalated,
                )
            )

    def checkpoint_saved(self, done: int) -> None:
        if self.tracer is not None:
            self.tracer.instant(
                "checkpoint_save", cat="checkpoint", args={"done": int(done)}
            )

    # -- heartbeat ---------------------------------------------------------

    def _sample(self) -> str:
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        done = self.frames_done
        total = f"/{self.total}" if self.total else ""
        parts = [
            f"{done}{total} frames",
            f"{done / elapsed:.1f} fps",
            f"{elapsed:.0f}s elapsed",
        ]
        timer = self.timer
        if timer is not None and timer.stalls:
            # dict() snapshot: this runs on the heartbeat thread while
            # the consumer inserts stall keys; PyDict_Copy is atomic
            # under the GIL, Python-level .items() iteration is not
            stalls = dict(timer.stalls)
            frac = {k: v / elapsed for k, v in stalls.items() if v > 0}
            if frac:
                top = sorted(frac.items(), key=lambda kv: -kv[1])[:3]
                parts.append(
                    "stalls "
                    + " ".join(f"{k}={100 * v:.0f}%" for k, v in top)
                )
        rep = self.report
        if rep is not None and rep.any():
            parts.append(
                f"retries io={rep.io_retries} dev={rep.device_retries} "
                f"failovers={rep.backend_failovers} "
                f"failed={rep.failed_frames}"
            )
        return ", ".join(parts)

    # -- teardown ----------------------------------------------------------

    def finish(self, timing: dict | None = None, error: str | None = None):
        """Stop the heartbeat and flush both artifacts. Idempotent —
        the orchestrator calls it with the final timing on success and
        again (a no-op) from its `finally`; on the error path the
        `finally` call flushes whatever was collected."""
        if self._finished:
            return
        self._finished = True
        if self.heartbeat is not None:
            self.heartbeat.stop()
        if (
            timing is not None
            and self.latency is not None
            and self.latency.count
        ):
            # setdefault: serve sessions attach their own (richer)
            # section before finish — never overwrite it
            timing.setdefault("latency", self.latency.report())
        summary: dict = {"frames": self.frames_done}
        if timing is not None:
            summary["timing"] = timing
        if self.report is not None and self.report.any():
            summary["robustness"] = self.report.as_dict()
        if error is not None:
            summary["error"] = error
        try:
            if self.records is not None:
                try:
                    self.records.close(summary=summary)
                except Exception:
                    if error is None:  # don't mask the run's own failure
                        raise
            if self.tracer is not None:
                if timing is not None:
                    self.tracer.metadata["timing"] = timing
                if error is not None:
                    self.tracer.metadata["error"] = error
                try:
                    self.tracer.write(self.trace_path)
                except Exception:
                    if error is None:  # don't mask the run's own failure
                        raise
        finally:
            if self.tracer is not None:
                from kcmc_tpu_torch.plans.runtime import discard_tracer

                discard_tracer(self.tracer)
            # Release the artifact-path claims so the NEXT run (not a
            # concurrent one) reuses the configured path verbatim.
            _release_path(self.trace_path)
            _release_path(self.frame_records_path)

    def close(self, exc: BaseException | None = None) -> None:
        """`finally`-path teardown: flush with the error recorded when
        the run is unwinding, no-op when finish() already ran."""
        if self._finished:
            return
        self.finish(
            timing=None, error=repr(exc) if exc is not None else "unfinished"
        )
