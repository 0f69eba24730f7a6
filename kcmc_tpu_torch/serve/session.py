"""Session: stream-scoped correction state, decoupled from process
lifetime (the port's copy of kcmc_tpu/serve/session.py).

`MotionCorrector.correct_file` owns its run-scoped state (prepared
reference, rolling-template history, cursor, writer, telemetry) for
exactly the lifetime of one file. Serving decouples the two: a
`Session` IS that state, extracted into an object whose lifetime is the
client stream's — frames arrive in arbitrary-size submits, results
leave incrementally, and the card's work interleaves with other
sessions through the `StreamScheduler`'s shared dispatch window.

Each session wraps a per-stream `MotionCorrector` view
(`MotionCorrector.stream_view`) sharing the resident `TorchBackend`,
which gives it the one-shot path's exact per-batch machinery —
`_pad_batch`, `_rescue_flagged`, the degradation ladder,
`_rolled_template` — so a stream's outputs match a one-shot `correct()`
of the same frames: the batches carry the session's own frame indices,
which the RANSAC keys fold in. Drained outputs reach a session as host
numpy arrays (the scheduler materializes them through
`TorchBackend.to_host`), never as tensors on the card.

Threading: all mutable state is guarded by the scheduler's lock (one
lock for the whole serving plane — sessions are touched from client
threads and the scheduler thread). Result waiters block on a
per-session Condition built on that lock.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from kcmc_tpu_torch.corrector import (
    CorrectionResult,
    _cast_output,
    merge_outputs,
)


class SessionClosed(RuntimeError):
    """Raised by submit-side calls on a session that is closing/closed."""


class Session:
    """One client stream through the resident serving backend.

    Built by `StreamScheduler.open_session` — not directly. `corrector`
    is a per-stream `MotionCorrector` view sharing the warm backend;
    `lock` is the scheduler's lock (see module docstring).
    """

    def __init__(
        self,
        corrector,
        lock: threading.Lock,
        session_id: str,
        tenant: str = "default",
        weight: int = 1,
        emit_frames: bool = False,
        output: str | None = None,
        expected_frames: int | None = None,
        output_dtype="float32",
        compression: str = "none",
        telemetry: bool = True,
        trace_shard=None,
        exemplars=None,
        qos_class: str = "batch",
        deadline_ms: float | None = None,
    ):
        if output is not None and expected_frames is None:
            raise ValueError(
                "output= (server-side corrected file) requires "
                "expected_frames= — streaming writers size their "
                "containers up front"
            )
        if weight < 1:
            raise ValueError(f"session weight must be >= 1, got {weight}")
        if qos_class not in ("latency", "batch"):
            raise ValueError(
                f"qos_class must be 'latency' or 'batch', got {qos_class!r}"
            )
        if deadline_ms is not None and float(deadline_ms) <= 0:
            raise ValueError(
                f"deadline_ms must be > 0, got {deadline_ms!r}"
            )
        self.mc = corrector
        self.sid = str(session_id)
        self.tenant = str(tenant)
        self.weight = int(weight)
        # Latency QoS (docs/SERVING.md "Latency QoS"): the scheduling
        # class is immutable for the stream's lifetime (journaled, so a
        # migrated session keeps it); deadline_ms is the session-default
        # per-frame deadline a submit may override per call.
        self.qos_class = str(qos_class)
        self.deadline_ms = (
            float(deadline_ms) if deadline_ms is not None else None
        )
        self.emit_frames = bool(emit_frames)
        self.output = output
        self.expected_frames = expected_frames
        self.compression = compression
        self._output_dtype = output_dtype
        self._cond = threading.Condition(lock)

        # Arm per-stream run state on the view: robustness report +
        # retry policy (the scheduler's ladder calls reuse them), rescue
        # counters. Mid-stream warp escalation is disabled — it would
        # switch the SHARED backend's warp per stream; the per-frame
        # exact-warp rescue still covers out-of-bound frames.
        self.mc._begin_robust_run()
        self.mc._escalation_allowed = False

        cfg = self.mc.config
        # Rolling template state (the host blend path of a one-shot
        # run without device_templates, so parity with one-shot runs
        # holds).
        self.E = self.mc.template_update_every
        self.W_roll = min(self.mc.template_window, self.E) if self.E else 0
        self._tail: list[dict] = []
        self._next_boundary = self.E if self.E else None

        self.ref_frame: np.ndarray | None = None
        self.ref: dict | None = None
        # Reference SOURCE frame staged for the scheduler thread to
        # prepare (device compute stays off the client/lock path).
        self._ref_src: np.ndarray | None = None
        # The stream's frame shape, pinned by the first reference/
        # submit: a later mismatched submit is a CLIENT error rejected
        # at admission — np.stack-ing mixed shapes in take_batch would
        # blow up on the scheduler thread instead.
        self.frame_shape: tuple | None = None

        # Temporal warm-start seed (config.warm_start, matrix models):
        # this stream's most recently dispatched batch's last transform
        # — a tensor on the card the scheduler threads into the next
        # dispatch's consensus as hypothesis zero. Per session: streams
        # are independent temporal histories.
        self.warm_seed = None

        # Stream cursors: submitted >= dispatched >= done >= delivered.
        self.pending: list[np.ndarray] = []  # frames awaiting dispatch
        self.submitted = 0
        self.dispatched = 0
        self.done = 0
        self.inflight = 0  # batches of this session in the window
        self.degraded = False  # QoS: dispatching on the degraded backend
        self.closing = False
        self.closed = False
        self.error: BaseException | None = None
        self._finalizing = False
        self._result: CorrectionResult | None = None
        # Whether result() has delivered at least once — the scheduler's
        # closed-session retention only strips emit pixels from results
        # a client has already received.
        self._result_delivered = False

        self._outs: list[dict] = []  # drained per-batch host dicts
        self._outs_delivered = 0  # fetch() high-water mark (batches)
        self._frames_delivered = 0
        self._t0: float | None = None

        self.writer = None
        self.out_dt: np.dtype | None = (
            None
            if isinstance(output_dtype, str) and output_dtype == "input"
            else np.dtype(output_dtype)
        )

        # Durable-session state (serve/journal.py; attached by the
        # scheduler when serve_journal_dir is configured). keep_journal
        # marks finalizations that must NOT discard the journal: a
        # scheduler shutdown (SIGTERM drain) or a staleness reap closes
        # the stream server-side while leaving it client-resumable.
        self.journal = None
        self.keep_journal = False
        self._config_sig: str | None = None
        # _outs high-water already persisted as journal parts: each
        # snapshot appends only the batches drained since the last one
        # (O(new work) — the checkpoint layer's append-only contract).
        self._outs_journaled = 0
        # Client-liveness clock (monotonic): submits and result reads
        # refresh it; the scheduler reaps sessions idle past
        # serve_session_timeout_s (journaled, not dropped). `waiters`
        # counts client threads currently BLOCKED in fetch()/result()
        # — a long results() poll is a live client whose activity clock
        # has gone stale, and the reaper must not close the stream out
        # from under it.
        self.last_activity = time.monotonic()
        self.waiters = 0
        # Idempotent-submit dedup: replayed frames dropped at admission
        # (client reconnect retries). Folded into the RobustnessReport
        # at finalize (scheduler thread) so the counter write stays
        # under the plane lock.
        self.deduped_frames = 0
        # Plane-locked snapshot of the robustness counters for the
        # heartbeat/stats readers (the report object itself is only
        # touched by the scheduler thread mid-run).
        self._rb: dict = {}

        # Request-latency telemetry (obs/latency.py; docs/
        # OBSERVABILITY.md "Request latency"): per-(segment, QoS rung)
        # mergeable histograms this stream's lifecycle seams record
        # into. `_t_submit` carries (t_call, t_admitted) perf_counter
        # stamps per pending frame (aligned with `pending`);
        # `_t_done` carries (t_call, t_accounted) per drained,
        # not-yet-fetched frame so `fetch`/finalize can close the
        # delivery and end-to-end segments. The scheduler folds `lat`
        # into the plane-wide rollup exactly once, at close
        # (`_lat_folded`).
        self.lat = None
        self._lat_folded = False
        if cfg.latency_telemetry:
            from kcmc_tpu_torch.obs.latency import SegmentLatencies

            self.lat = SegmentLatencies()
        self._t_submit: deque = deque()
        self._t_done: deque = deque()

        # Deadline-QoS state (docs/SERVING.md "Latency QoS"):
        # `_deadlines` carries one absolute (epoch-seconds) deadline —
        # or None — per pending frame, aligned with `pending` exactly
        # like `_t_submit`; take_batch pops the dispatched prefix into
        # `_inflight_deadlines` (a FIFO of per-batch lists — drains
        # are in dispatch order, the same invariant `_outs` ordering
        # rests on) and on_drained scores each against the wall clock.
        # `_replay_deadlines` holds journal-restored absolute deadlines
        # keyed by session frame index, consumed as the client replays
        # those frames — a migrated stream keeps its ORIGINAL deadlines
        # rather than restarting the clock at resubmit.
        self._deadlines: deque = deque()
        self._inflight_deadlines: deque = deque()
        self._replay_deadlines: dict[int, float] = {}
        # Outstanding-deadline meta changed since the last durable
        # snapshot: deadlines arrive on SUBMIT, not drain, so the
        # forced stop/reap save must not be skipped by the "nothing
        # new since the last durable frame" cursor check — a migrated
        # stream would silently drop its pending frames' deadlines.
        self._deadlines_dirty = False
        self.deadline_hits = 0
        self.deadline_misses = 0
        # Dispatches of this session that jumped the weighted round-
        # robin (incremented by the scheduler, plane lock held).
        self.preempted_dispatches = 0

        # Distributed-trace plumbing (obs/tracing.py; docs/
        # OBSERVABILITY.md "Distributed tracing"): `trace_shard` is the
        # scheduler's bounded per-process span sink, `exemplars` its
        # latency-exemplar store. `_trace_ctx` is the most recent
        # traced submit's context — batches formed from this session
        # attribute their segment spans to it (latest-wins: a stream
        # interleaving traced submits shares attribution, which keeps
        # the hot path to one reference write instead of a per-frame
        # context queue).
        self._trace_shard = trace_shard
        self._exemplars = exemplars
        self._trace_ctx: dict | None = None

        # Per-session telemetry (trace + frame records) through the
        # run-id machinery: concurrent sessions configured with the same
        # artifact paths get per-session derived filenames. The serve
        # plane owns the heartbeat (aggregated across sessions), so the
        # per-session one is pinned off.
        self.telemetry = None
        if telemetry and cfg.observability_enabled:
            from kcmc_tpu_torch.obs.run import RunTelemetry

            self.telemetry = RunTelemetry.begin(
                cfg.replace(heartbeat_s=0.0),
                backend=self.mc.backend,
                backend_name=self.mc.backend_name,
                report=self.mc._robustness,
                total=expected_frames,
                run_id=self.sid,
                # Every session gets its OWN derived artifact file —
                # without this, sequential sessions of a long-lived
                # server would each overwrite the last one's trace.
                derive_paths=True,
            )

    # -- submit side (client threads, scheduler lock held) ----------------

    def set_reference(self, ref_frame: np.ndarray) -> None:
        """Explicit reference frame (before the first submit). Stages
        the source; the scheduler thread runs the device preparation."""
        if self.ref is not None or self._ref_src is not None:
            raise ValueError(
                "reference is already set (set it before submitting)"
            )
        self._ref_src = np.asarray(ref_frame, np.float32)
        if self._ref_src.ndim != 2:
            raise ValueError(
                f"reference frame must be 2-D, got shape "
                f"{self._ref_src.shape}"
            )
        self.frame_shape = self._ref_src.shape

    def backlog(self) -> int:
        """Frames admitted but not yet dispatched (the admission gauge)."""
        return len(self.pending)

    def note_trace(self, ctx: dict, n: int) -> None:
        """Remember the most recent traced submit's context (plane lock
        held; scheduler calls this at admission). Subsequent batch/
        delivery spans of this stream parent under it."""
        self._trace_ctx = ctx

    def trace_obs(self, seg, dur, n, rung, ctx, args=None) -> None:
        """Emit one span-shard record (+ latency exemplar) mirroring a
        segment observation. The span's weight — ``dur × n`` — equals
        the same site's histogram-sum contribution, so per-trace span
        sums telescope against the `metrics` segment sums. `args`
        merges extra span attributes (the scheduler rides the dispatch
        decision's `why` here). No-op without a context; shard/
        exemplar sinks are each optional."""
        if ctx is None:
            return
        tid = ctx.get("trace_id")
        if self._trace_shard is not None:
            self._trace_shard.complete(
                seg, time.time() - dur, dur,
                trace_id=tid, parent_id=ctx.get("span_id"),
                args={"n": int(n), "rung": rung, **(args or {})},
            )
        if self._exemplars is not None and tid:
            self._exemplars.note(seg, dur, tid, rung=rung)

    def _rung(self) -> str:
        """The (segment, rung) histogram dimension this stream records
        under. Degradation wins — a degraded stream's tail must never
        land in a healthy series — then latency-class streams get
        their own rung, so per-class latency summaries and SLOs fall
        out of the existing rung dimension with no new plumbing."""
        if self.degraded:
            return "degraded"
        return "latency" if self.qos_class == "latency" else "full"

    def add_frames(self, frames, deadline_ms: float | None = None) -> int:
        """Append admitted frames to the pending queue (admission checks
        happen in the scheduler BEFORE this). Runs on a CLIENT thread
        under the serving plane's one lock, so it only stages work:
        reference preparation (device compute, possibly a kernel
        library's first build) and
        writer construction (file I/O) happen on the scheduler thread
        (`prepare_reference_now` / first drain). `deadline_ms` (relative
        to NOW) stamps each of this call's frames with an absolute
        deadline; None falls back to the session default. Journal-
        replayed frames keep their original restored deadlines."""
        if self.closing or self.closed:
            raise SessionClosed(f"session {self.sid} is closed")
        frames = np.asarray(frames)
        if frames.ndim == 2:
            frames = frames[None]
        if frames.ndim != 3:
            raise ValueError(
                f"frames must be (H, W) or (T, H, W), got shape "
                f"{frames.shape}"
            )
        if self.frame_shape is None:
            self.frame_shape = tuple(frames.shape[1:])
        elif tuple(frames.shape[1:]) != tuple(self.frame_shape):
            raise ValueError(
                f"session {self.sid} frames are "
                f"{tuple(self.frame_shape)}; got {tuple(frames.shape[1:])}"
            )
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self.last_activity = time.monotonic()
        if self.out_dt is None:
            self.out_dt = np.dtype(frames.dtype)
        if self.ref is None and self._ref_src is None:
            self._ref_src = np.asarray(frames[0], np.float32)
        if deadline_ms is None:
            deadline_ms = self.deadline_ms
        abs_dl = (
            time.time() + float(deadline_ms) / 1000.0
            if deadline_ms is not None
            else None
        )
        base = self.submitted
        for i, f in enumerate(frames):
            self.pending.append(np.asarray(f))
            # a replayed frame's restored deadline (absolute) beats the
            # resubmit's fresh one — migration must not reset the clock
            d = self._replay_deadlines.pop(base + i, None)
            d = d if d is not None else abs_dl
            self._deadlines.append(d)
            if d is not None:
                self._deadlines_dirty = True
        self.submitted += len(frames)
        return len(frames)

    def fully_delivered(self) -> bool:
        """All drained result spans have been fetched (lock held) —
        the staleness reaper's no-data-loss gate for unjournaled
        sessions."""
        return self._outs_delivered >= len(self._outs)

    def needs_reference(self) -> bool:
        """Whether the scheduler thread must prepare this session's
        reference before its frames become dispatchable (lock held)."""
        return self.ref is None and self._ref_src is not None

    def prepare_reference_now(self) -> None:
        """Prepare the staged reference. SCHEDULER thread only, lock
        NOT held — this is device compute (and a possible first build
        of a kernel library) that must never stall other tenants'
        submits. Only the staged-
        source read takes the lock; the compute does not."""
        with self._cond:
            src = self._ref_src
            backend = self.mc.backend
        ref = backend.prepare_reference(src)
        with self._cond:
            if self._ref_src is not src or self.mc.backend is not backend:
                # The staging changed while this prepare was in flight
                # — a journal restore's boundary re-roll swapped the
                # source, or a quarantine rebuild swapped the backend.
                # Installing would pin a stale template (silent parity
                # divergence) or a dead-backend ref; drop it and let
                # the next loop pass prepare the current staging.
                return
            self.ref_frame = src
            self.ref = ref
            self._cond.notify_all()

    def begin_close(self) -> None:
        """Mark the stream complete: remaining pending frames still
        process; the scheduler finalizes once everything drains.
        Takes the plane lock itself (reentrant) — the shutdown path
        calls it with no lock held."""
        with self._cond:
            self.closing = True
            self._cond.notify_all()

    # -- durable journal (scheduler thread; serve/journal.py) --------------

    def _rb_snapshot(self) -> dict:
        """Plane-locked robustness snapshot for the heartbeat/stats
        readers (the report object is scheduler-thread-only).
        `faults_injected` is normally folded from the fault plan only
        at finalize — fold the live counter here too, so a chaos run's
        `stats` never shows failovers climbing with zero injections."""
        rb = self.mc._robustness.as_dict()
        plan = self.mc._fault_plan
        if plan is not None and plan.injected:
            rb["faults_injected"] = int(plan.injected)
        return rb

    def attach_journal(self, journal) -> None:
        """Arm periodic journaling (scheduler-owned; called at open)."""
        from kcmc_tpu_torch.serve.journal import serve_config_signature

        with self._cond:
            self.journal = journal
            self._config_sig = serve_config_signature(self.mc.config)

    def _journal_state(self):
        """Snapshot the resume state (lock held). Array contents are
        append-only once drained, so only the dict/list copies need the
        lock — serialization runs outside it. Returns only the batches
        NEW since the last durable snapshot (journal parts are
        append-only; corrected pixels are never journaled)."""
        new_outs = [
            {k: v for k, v in o.items() if k != "corrected"}
            for o in self._outs[self._outs_journaled :]
        ]
        tail = list(self._tail)
        meta = {
            "sid": self.sid,
            "tenant": self.tenant,
            "weight": self.weight,
            "config": self._config_sig,
            "backend": self.mc.backend_name,
            "model": self.mc.config.model,
            "done": int(self.done),
            "next_boundary": self._next_boundary,
            "template_update_every": int(self.E) if self.E else 0,
            "frame_shape": (
                list(self.frame_shape) if self.frame_shape else None
            ),
            "out_dtype": str(self.out_dt) if self.out_dt is not None else None,
            "emit_frames": bool(self.emit_frames),
            "expected_frames": self.expected_frames,
            "output": self.output,
            "compression": self.compression,
            # Latency-QoS state: the class and session-default deadline
            # survive a migration, and each pending frame's ABSOLUTE
            # deadline is journaled keyed by its session frame index —
            # a resumed stream's replayed frames keep the clock they
            # were admitted under, not a fresh one.
            "qos_class": self.qos_class,
            "deadline_ms": self.deadline_ms,
            "deadline_hits": int(self.deadline_hits),
            "deadline_misses": int(self.deadline_misses),
            "deadlines": self._outstanding_deadlines(),
        }
        return meta, new_outs, tail

    def _outstanding_deadlines(self) -> dict:
        """Absolute deadlines of every frame past the durable cursor
        (lock held): in-flight batches first — a resume replays from
        `done`, so their frames are outstanding too — then the pending
        queue. Keys are session frame indices (as strings: JSON)."""
        out: dict[str, float] = {}
        i = self.done
        for batch_dl in self._inflight_deadlines:
            for d in batch_dl:
                if d is not None:
                    out[str(i)] = float(d)
                i += 1
        i = self.dispatched
        for d in self._deadlines:
            if d is not None:
                out[str(i)] = float(d)
            i += 1
        return out

    def maybe_journal(self, force: bool = False) -> None:
        """Write a durable snapshot when the cadence (or `force` — the
        graceful-drain/reap path) calls for one. SCHEDULER thread only;
        the serialization runs outside the plane lock."""
        with self._cond:
            j = self.journal
            if j is None:
                return
            done = self.done
            if done <= 0 or not (force or j.due(done)):
                return
            if (
                force and done <= j.last_saved
                and not self._deadlines_dirty
            ):
                # nothing new since the last durable frame — and no
                # deadline stamped since it either (deadlines change
                # the meta on submit, with the cursor standing still)
                return
            meta, new_outs, tail = self._journal_state()
            outs_high = len(self._outs)  # high-water this save covers
            # consumed by THIS snapshot — cleared here (same lock
            # hold), so a deadline stamped while the write runs below
            # re-dirties for the next save instead of being lost
            was_dirty, self._deadlines_dirty = (
                self._deadlines_dirty, False
            )
        arrays: dict = {}
        ref_frame = self.ref_frame
        if ref_frame is not None:
            # Rolling templates store under "template": the checkpoint
            # loader's rewind gate keys on that name — a corrupt part
            # of a rolling stream must NOT rewind (the stored template
            # matches only the final cursor), while a static-reference
            # stream may resume from its last good prefix.
            key = "template" if self.E else "ref_frame"
            arrays[key] = np.asarray(ref_frame, np.float32)
        if tail:
            arrays["tail_corrected"] = np.concatenate(
                [np.asarray(t["corrected"], np.float32) for t in tail]
            )
            arrays["tail_warp_ok"] = np.concatenate(
                [np.asarray(t["warp_ok"], bool) for t in tail]
            )
            meta["tail_lens"] = [int(len(t["corrected"])) for t in tail]
        else:
            meta["tail_lens"] = []
        t0 = time.perf_counter()
        saved = j.save(meta, new_outs, arrays)
        dur = time.perf_counter() - t0
        if saved:
            # durability cost is a first-class span: a DURATION on the
            # trace (where the old instant hid the write time) and a
            # latency segment in the `metrics` verb
            if self.telemetry is not None and self.telemetry.tracer is not None:
                self.telemetry.tracer.complete(
                    "journal.save", t0, dur, cat="journal",
                    args={"done": int(meta["done"])},
                )
            if self.lat is not None:
                self.lat.observe("journal.save", dur)
            with self._cond:
                self._outs_journaled = outs_high
                self._rb = self._rb_snapshot()
        elif was_dirty:
            # failed write: the snapshot never became durable, so the
            # deadline meta is still pending — re-arm the force path
            with self._cond:
                self._deadlines_dirty = True

    def restore_from_journal(
        self, meta: dict, segments: list, arrays: dict, journal=None
    ):
        """Rehydrate a freshly opened session from a journal snapshot:
        cursors, rolling-template history, the staged template source
        (prepared on the CURRENT backend by the scheduler), and the
        journaled per-batch outputs, restored delivered-by-journal —
        corrected pixels are never journaled, so resumed `results`
        spans start at the resume cursor while `close_session` still
        returns the full stream's transforms/diagnostics. Called under
        the plane lock at registration, before anything dispatches."""
        with self._cond:
            if self.submitted or self.pending or self.dispatched:
                # A submit slipped in between registration and restore
                # (only possible for a client violating the resume
                # protocol): refusing is recoverable, silently
                # re-basing its frame indices is not.
                raise RuntimeError(
                    f"session {self.sid} received frames before its "
                    "journal restore completed; resume aborted"
                )
            done = int(meta["done"])
            self.done = self.dispatched = self.submitted = done
            if meta.get("frame_shape"):
                self.frame_shape = tuple(meta["frame_shape"])
            od = meta.get("out_dtype")
            if od:
                self.out_dt = np.dtype(od)
            nb = meta.get("next_boundary")
            self._next_boundary = int(nb) if nb is not None else None
            # Latency-QoS state: journal wins over open-time defaults —
            # a migrated latency stream keeps its class, its session-
            # default deadline, its hit/miss history, and the ORIGINAL
            # absolute deadlines of every outstanding frame (consumed
            # by add_frames as the client replays them).
            qc = meta.get("qos_class")
            if qc in ("latency", "batch"):
                self.qos_class = qc
            dm = meta.get("deadline_ms")
            if dm is not None:
                self.deadline_ms = float(dm)
            self.deadline_hits = int(meta.get("deadline_hits", 0))
            self.deadline_misses = int(meta.get("deadline_misses", 0))
            self._replay_deadlines = {
                int(k): float(v)
                for k, v in (meta.get("deadlines") or {}).items()
            }
            restored = [dict(s) for s in segments]
            if restored:
                self._outs = restored
                self._outs_delivered = len(restored)
                self._outs_journaled = len(restored)
                self._frames_delivered = done
            lens = [int(x) for x in meta.get("tail_lens") or []]
            if lens:
                tc = np.asarray(arrays["tail_corrected"], np.float32)
                tw = np.asarray(arrays["tail_warp_ok"], bool)
                self._tail, lo = [], 0
                for ln in lens:
                    self._tail.append(
                        {"corrected": tc[lo : lo + ln],
                         "warp_ok": tw[lo : lo + ln]}
                    )
                    lo += ln
            ref = arrays.get("template", arrays.get("ref_frame"))
            if ref is not None:
                self._ref_src = np.asarray(ref, np.float32)
                self.ref = None
            roll_src = None
            if (
                self._next_boundary is not None
                and done == self._next_boundary
                and self._tail
                and self._ref_src is not None
            ):
                # The snapshot caught a closing stream exactly at a
                # boundary whose roll was skipped (stream was ending).
                # A resumed stream continues PAST the boundary, so it
                # must roll — same blend an uninterrupted run would
                # have done — or frames past the boundary would never
                # dispatch. The blend itself runs AFTER this lock
                # section (frame-sized host compute; other tenants'
                # submits must keep flowing).
                roll_src = self._ref_src
                roll_tails = [t["corrected"] for t in self._tail]
                roll_oks = [t["warp_ok"] for t in self._tail]
            tr = restored[-1].get("transform") if restored else None
            if (
                self.mc.config.warm_start
                and tr is not None
                and len(tr)
                and self.mc.config.model != "piecewise"
            ):
                self.warm_seed = np.asarray(tr[-1])
            self.journal = journal
            if journal is not None:
                journal.adopt(meta)
            self.mc._robustness.resumed_from_frame = done
            self._rb = self._rb_snapshot()
            self.last_activity = time.monotonic()
            self._cond.notify_all()
        if roll_src is not None:
            rolled = self.mc._rolled_template(
                roll_src, roll_tails, roll_oks, self.W_roll
            )
            with self._cond:
                self._ref_src = rolled
                # the scheduler may have prepared the unrolled source
                # in the gap (no frame can have dispatched — the
                # boundary gate holds ready_count at 0 until the next
                # line advances it); clear it so the rolled template
                # is what gets prepared
                self.ref = None
                self._tail = []
                self._next_boundary += self.E
                self._cond.notify_all()

    def adopt_backend(self, backend) -> None:
        """Point this stream at a rebuilt backend (the scheduler's
        quarantine/rebuild path, plane lock held): the prepared
        reference re-stages so the scheduler re-prepares it on the new
        backend off this call, and the warm seed (a device array owned
        by the quarantined backend) is dropped — the next batch simply
        runs unseeded. A rebuild recovers from errors that leave the
        CUDA context usable (the injected device faults among them); a
        sticky CUDA error poisons the whole context, and no rebuild in
        this process recovers from it."""
        self.mc.backend = backend
        if self.ref_frame is not None:
            self._ref_src = self.ref_frame
            self.ref = None
        self.warm_seed = None

    # -- dispatch side (scheduler thread, scheduler lock held) ------------

    def ready_count(self) -> int:
        """Frames eligible for dispatch NOW: pending, minus the rolling-
        template gate (frames past the next boundary wait until the
        boundary's drained update has run)."""
        n = len(self.pending)
        if n == 0 or self.ref is None:
            return 0
        if self._next_boundary is not None:
            n = min(n, self._next_boundary - self.dispatched)
        return max(n, 0)

    def head_deadline(self) -> float | None:
        """Earliest absolute deadline among the dispatch-ready pending
        frames (lock held) — the scheduler's deadline-pressure signal.
        None when no ready frame carries one."""
        n = self.ready_count()
        if n <= 0 or not self._deadlines:
            return None
        best = None
        for i, d in enumerate(self._deadlines):
            if i >= n:
                break
            if d is not None and (best is None or d < best):
                best = d
        return best

    def take_batch(self, B: int, target: int | None = None):
        """Pop up to min(ready, B) frames as a padded dispatch batch:
        (n_valid, frames (T, ...), global indices (T,), ref, clock),
        where T is `target` (a batch-ladder rung covering the take —
        the deadline-forced partial-dispatch path pads to the smallest
        covering rung instead of the full window) or B. Indices are
        the session's own frame numbers — the RANSAC keys fold them
        in, so stream results match a one-shot run of the same frames
        regardless of how submits were sliced into batches OR which
        rung padded them (the parity contract `tests/test_serve_qos.py`
        pins per rung). `clock` (a RequestClock, None with latency
        telemetry off) carries each frame's submit stamp forward; the
        queue-wait and batch-formation segments are recorded here."""
        n = min(self.ready_count(), B)
        if n <= 0:
            return None
        t_take = time.perf_counter()
        pad_to = B if target is None else max(min(int(target), B), n)
        frames = np.stack(self.pending[:n])
        del self.pending[:n]
        idx = np.arange(self.dispatched, self.dispatched + n)
        self.dispatched += n
        self.inflight += 1
        # stage this batch's deadlines for on_drained's hit/miss
        # scoring (drains are in dispatch order — see ctor comment)
        taken_dl = [
            self._deadlines.popleft() if self._deadlines else None
            for _ in range(n)
        ]
        self._inflight_deadlines.append(taken_dl)
        clock = None
        if self.lat is not None:
            from kcmc_tpu_torch.obs.latency import RequestClock

            rung = self._rung()
            stamps = [
                self._t_submit.popleft()
                if self._t_submit
                # defensive alignment for frames enqueued outside the
                # scheduler's submit path (no stamp = zero queue wait)
                else (t_take, t_take)
                for _ in range(n)
            ]
            for _, t_adm in stamps:
                self.lat.observe(
                    "request.queue_wait", t_take - t_adm, rung=rung
                )
            padded = self.mc._pad_batch(frames, idx, pad_to)
            t_formed = time.perf_counter()
            self.lat.observe(
                "request.batch_form", t_formed - t_take, n=n, rung=rung
            )
            clock = RequestClock(
                [t0 for t0, _ in stamps], t_formed, trace=self._trace_ctx
            )
            clock.rung = rung
            if clock.trace is not None:
                # one span per batch, dur = per-frame mean so the span
                # weight (dur × n) equals the per-frame histogram sum
                q_sum = sum(t_take - t_adm for _, t_adm in stamps)
                self.trace_obs(
                    "request.queue_wait", q_sum / n, n, rung, clock.trace
                )
                self.trace_obs(
                    "request.batch_form", t_formed - t_take, n, rung,
                    clock.trace,
                )
            return padded + (self.ref, clock)
        return self.mc._pad_batch(frames, idx, pad_to) + (self.ref, clock)

    def wants_pixels(self) -> bool:
        """Whether drains need the corrected frames materialized: the
        client asked for them, a server-side writer consumes them, or
        the rolling-template blend needs the averaging window. When not,
        the scheduler dispatches with `emit_frames=False` and no
        (B, H, W) download starts at all."""
        return bool(self.emit_frames or self.output is not None or self.E)

    # -- drain side (scheduler thread; takes the lock itself) -------------

    def on_drained(
        self, n: int, host: dict, kept, ref_used: dict, clock=None
    ) -> None:
        """Account one drained batch (host arrays already sliced [:n]).
        Mirrors the one-shot drain: exact-warp rescue of flagged frames
        (when their input pixels were kept), QC NaN-ing otherwise,
        rolling-template tail collection, writer append, telemetry.
        `clock` (the batch's RequestClock) closes the device/drain
        latency segments and stages per-frame stamps for delivery."""
        with self._cond:
            # error can be set off-thread (a client thread's failed
            # journal restore, a ladder fail) — read it under the lock
            if self.error is not None:
                return  # failed stream: entries drain without accounting
            # out_dt is pinned by the first admitted submit (a client
            # thread, under this same lock) — snapshot it rather than
            # reading it unlocked mid-drain
            out_dt = self.out_dt
        cfg = self.mc.config
        if cfg.rescue_warp and kept is not None:
            self.mc._rescue_flagged(host, kept, n, ref_used)
        elif "template_corr" in host and "warp_ok" in host:
            # Never-rescued out-of-bound frames: their QC was measured
            # against a zeroed warp — NaN beats silently wrong.
            host["template_corr"] = np.where(
                host["warp_ok"], host["template_corr"], np.nan
            )
        corrected = host.pop("corrected", None)
        if self.E and corrected is not None:
            entry = {
                "corrected": np.asarray(corrected, np.float32),
                "warp_ok": np.asarray(
                    host.get("warp_ok", np.ones(len(corrected), bool)), bool
                ),
            }
            with self._cond:
                # _tail mutations stay under the plane lock: the
                # journal snapshot (scheduler thread) and a journal
                # restore (handler thread) both touch it
                self._tail.append(entry)
                have = sum(len(t["corrected"]) for t in self._tail)
                while have - len(self._tail[0]["corrected"]) >= self.W_roll:
                    have -= len(self._tail.pop(0)["corrected"])
        if corrected is not None:
            corrected = _cast_output(corrected, out_dt)
            if self.writer is None and self.output is not None:
                # Lazy writer construction on the scheduler thread at
                # the first drained batch — file I/O stays off the
                # client submit path (and its lock).
                from kcmc_tpu_torch.io.async_writer import AsyncBatchWriter
                from kcmc_tpu_torch.io.formats import make_writer

                inner = make_writer(
                    self.output, int(self.expected_frames),
                    tuple(corrected.shape[1:]), out_dt,
                    compression=self.compression,
                )
                depth = self.mc.config.writer_depth
                self.writer = (
                    AsyncBatchWriter(inner, depth=depth)
                    if depth > 0
                    else inner
                )
            if self.writer is not None:
                # encode-thread budget from the shared config
                self.writer.append_batch(
                    corrected, n_threads=self.mc.config.io_workers
                )
            if self.emit_frames:
                host["corrected"] = corrected
        with self._cond:
            self._outs.append(host)
            if self.telemetry is not None:
                self.telemetry.note_batch(self.done, n, host)
            if clock is not None and self.lat is not None:
                t_acct = time.perf_counter()
                t_host = clock.t_host if clock.t_host is not None else t_acct
                t_disp = (
                    clock.t_dispatched
                    if clock.t_dispatched is not None
                    else clock.t_formed
                )
                self.lat.observe(
                    "request.device", t_host - t_disp, n=n, rung=clock.rung
                )
                self.lat.observe(
                    "request.drain", t_acct - t_host, n=n, rung=clock.rung
                )
                if clock.trace is not None:
                    self.trace_obs(
                        "request.device", t_host - t_disp, n,
                        clock.rung, clock.trace,
                    )
                    self.trace_obs(
                        "request.drain", t_acct - t_host, n,
                        clock.rung, clock.trace,
                    )
                for t0f in clock.t_submit[:n]:
                    self._t_done.append((t0f, t_acct))
            # score this batch's deadlines at result availability —
            # the drain is when frames become fetchable, so it is the
            # honest hit/miss boundary (delivery adds client wait)
            if self._inflight_deadlines:
                t_wall = time.time()
                for d in self._inflight_deadlines.popleft():
                    if d is None:
                        continue
                    if t_wall <= d:
                        self.deadline_hits += 1
                    else:
                        self.deadline_misses += 1
            self.done += n
            # plane-locked robustness snapshot for the heartbeat/stats
            # readers (the report object is scheduler-thread-only)
            self._rb = self._rb_snapshot()
            boundary = (
                self._next_boundary is not None
                and self.done == self._next_boundary
                and not (self.closing and not self.pending)
            )
            self._cond.notify_all()
        if boundary:
            # Rolling-template update at the boundary (host blend path;
            # frame-exact window slicing inside _rolled_template). Runs
            # on the scheduler thread, after every pre-boundary frame
            # of THIS session drained — other sessions' batches keep
            # the window busy meanwhile. The blend + re-preparation
            # compute outside the lock; only the handle swap takes it
            # (client-side set_reference probes `self.ref` under it).
            with self._cond:
                tails = [t["corrected"] for t in self._tail]
                oks = [t["warp_ok"] for t in self._tail]
                self._tail.clear()
            rolled = self.mc._rolled_template(
                self.ref_frame, tails, oks, self.W_roll
            )
            new_ref = self.mc.backend.prepare_reference(rolled)
            with self._cond:
                self.ref_frame = rolled
                self.ref = new_ref
                self._next_boundary += self.E
                self._cond.notify_all()
        # Journal AFTER any boundary roll so a snapshot never lands in
        # the done==boundary/unrolled-tail in-between state (a resumed
        # stream must have dispatchable frames).
        self.maybe_journal()

    def entry_done(self) -> None:
        """Scheduler-side accounting: one of this session's dispatched
        batches has been fully handled (drained, laddered, or failed).
        Owned by the SCHEDULER so in-flight counts stay correct on
        every error path."""
        with self._cond:
            self.inflight = max(0, self.inflight - 1)
            self._cond.notify_all()

    def drained_out(self) -> bool:
        """True when every admitted frame has drained (finalize gate).
        A failed stream only waits for its in-flight entries — its
        pending frames were dropped by `fail`. Takes the plane lock
        itself (reentrant) — the shutdown path polls it lock-free."""
        with self._cond:
            if self.error is not None:
                return self.inflight == 0
            return (
                not self.pending and self.inflight == 0
                and self.dispatched == self.done
            )

    def fail(self, exc: BaseException) -> None:
        """Fatal stream error (ladder exhausted with mark-failed off, or
        a scheduler-side bug): fail waiters, drop pending work."""
        with self._cond:
            if self.error is None:
                self.error = exc
            self.closing = True
            self.pending.clear()
            self._t_submit.clear()  # stays aligned with `pending`
            self._deadlines.clear()  # likewise
            self._cond.notify_all()

    def finalize(self) -> None:
        """Build the final CorrectionResult and tear the stream down.
        Called by the SCHEDULER thread once the stream fully drained —
        the writer teardown deliberately happens on a different thread
        than the one that created it (AsyncBatchWriter.close is
        cross-thread safe)."""
        with self._cond:
            if self._finalizing or self.closed:
                return
            self._finalizing = True
            if self.lat is not None and self._t_done:
                # frames never fetched incrementally (close-only
                # clients): their delivery segment closes at finalize —
                # the moment the final result becomes available. Keep
                # the session's QoS rung, like the fetch path — a
                # degraded stream's tail must not land in the healthy
                # series.
                t_now = time.perf_counter()
                rung = self._rung()
                d_sum = e_sum = 0.0
                k = 0
                while self._t_done:
                    t0f, t_acct = self._t_done.popleft()
                    self.lat.observe(
                        "request.delivery", t_now - t_acct, rung=rung
                    )
                    self.lat.observe(
                        "request.total", t_now - t0f, rung=rung
                    )
                    d_sum += t_now - t_acct
                    e_sum += t_now - t0f
                    k += 1
                if k and self._trace_ctx is not None:
                    self.trace_obs(
                        "request.delivery", d_sum / k, k, rung,
                        self._trace_ctx,
                    )
                    self.trace_obs(
                        "request.total", e_sum / k, k, rung,
                        self._trace_ctx,
                    )
            # Shallow-copy each batch dict: the merge below runs
            # OUTSIDE the lock, and a concurrent fetch() pops delivered
            # pixels from the shared dicts mid-merge otherwise. The
            # stream clock (_t0: first-submit time, a client-thread
            # write) snapshots under the lock for the same reason.
            outs = [dict(o) for o in self._outs]
            done = self.done
            t0 = self._t0
            deduped = self.deduped_frames
            journal = self.journal
            keep_journal = self.keep_journal or self.error is not None
            qos = self.qos_class
            d_hits = self.deadline_hits
            d_misses = self.deadline_misses
            preempted = self.preempted_dispatches
        err: BaseException | None = None
        try:
            if self.writer is not None:
                self.writer.close()
        except BaseException as e:  # surfaced on result()
            err = e
        elapsed = (
            max(time.perf_counter() - t0, 1e-9)
            if t0 is not None
            else 0.0
        )
        timing: dict = {
            "n_frames": done,
            "frames_per_sec": done / elapsed if elapsed else None,
            "elapsed_s": elapsed,
        }
        if self.lat is not None and self.lat.count:
            # the stream's own latency section — same schema as the
            # `metrics` verb (docs/OBSERVABILITY.md "Request latency"),
            # carried through the close_session payload and the
            # frame-records run summary
            timing["latency"] = self.lat.report()
        if qos == "latency" or d_hits or d_misses or preempted:
            # deadline-QoS section (obs/registry.py TIMING_KEYS;
            # rendered as the "Deadline QoS" table by obs/report.py) —
            # only attached when the stream actually had QoS exposure
            timing["deadline_qos"] = {
                "qos_class": qos,
                "deadline_hits": int(d_hits),
                "deadline_misses": int(d_misses),
                "preempted_dispatches": int(preempted),
            }
        merged = merge_outputs(outs)
        corrected = merged.pop("corrected", None)
        transforms = merged.pop("transform", None)
        fields = merged.pop("field", None)
        # Fold the plane-locked dedup counter into the report here, on
        # the scheduler thread — the thread that owns every other
        # report write — so it lands in timing["robustness"] below.
        self.mc._robustness.deduped_frames = int(deduped)
        transforms = self.mc._finalize_robustness(
            merged, transforms, 0, done, timing
        )
        if journal is not None:
            if keep_journal:
                # Shutdown drain / staleness reap: the stream stays
                # client-resumable — leave the last snapshot in place.
                pass
            else:
                # Clean client-initiated close: a completed stream must
                # not be resurrectable into a duplicate.
                journal.discard()
        result = CorrectionResult(
            corrected=(
                corrected
                if corrected is not None
                else np.empty((0,), np.float32)
            ),
            transforms=transforms,
            fields=fields,
            diagnostics=merged,
            timing=timing,
        )
        with self._cond:
            # error can be set off-thread (a client thread's failed
            # journal restore) — snapshot under the lock
            stream_err = self.error
        if self.telemetry is not None:
            try:
                if err is None and stream_err is None:
                    self.telemetry.finish(timing)
                else:
                    self.telemetry.close(err or stream_err)
            except BaseException as e:
                err = err or e
        with self._cond:
            if err is not None and self.error is None:
                self.error = err
            self._result = result
            self.closed = True
            self._cond.notify_all()

    # -- results side (client threads) ------------------------------------

    def fetch(self, timeout: float | None = None) -> dict | None:
        """Incremental results: block until at least one undelivered
        batch drained (or the stream closed), then return a merged dict
        ``{"first_frame", "n", <output arrays>}``. Returns None when
        the stream is closed and exhausted; raises the stream's error
        if it failed. Delivered corrected frames are released from
        session memory."""
        with self._cond:
            self.last_activity = time.monotonic()
            self.waiters += 1
            try:
                ok = self._cond.wait_for(
                    lambda: self.error is not None
                    or len(self._outs) > self._outs_delivered
                    or self.closed,
                    timeout=timeout,
                )
            finally:
                self.waiters -= 1
                self.last_activity = time.monotonic()
            if self.error is not None:
                raise self.error
            if not ok:
                raise TimeoutError(
                    f"no results within {timeout}s for session {self.sid}"
                )
            new = self._outs[self._outs_delivered :]
            if not new:
                return None  # closed and exhausted
            first = self._frames_delivered
            self._outs_delivered = len(self._outs)
            n = sum(len(next(iter(o.values()))) for o in new if o)
            self._frames_delivered += n
            if self.lat is not None and self._t_done:
                # close the delivery + end-to-end segments for every
                # frame this fetch hands over
                t_now = time.perf_counter()
                rung = self._rung()
                d_sum = e_sum = 0.0
                k = 0
                for _ in range(min(n, len(self._t_done))):
                    t0f, t_acct = self._t_done.popleft()
                    self.lat.observe(
                        "request.delivery", t_now - t_acct, rung=rung
                    )
                    self.lat.observe(
                        "request.total", t_now - t0f, rung=rung
                    )
                    d_sum += t_now - t_acct
                    e_sum += t_now - t0f
                    k += 1
                if k and self._trace_ctx is not None:
                    self.trace_obs(
                        "request.delivery", d_sum / k, k, rung,
                        self._trace_ctx,
                    )
                    self.trace_obs(
                        "request.total", e_sum / k, k, rung,
                        self._trace_ctx,
                    )
            merged = merge_outputs(new)
            # Release delivered pixels — frames dominate memory; the
            # final merge stays key-uniform because fetch always
            # consumes a PREFIX of the batch list (keys come from
            # outs[0], so a popped prefix excludes "corrected" from the
            # final result consistently).
            for o in new:
                o.pop("corrected", None)
        merged["first_frame"] = first
        merged["n"] = n
        return merged

    def result(self, timeout: float | None = None) -> CorrectionResult:
        """Block until the stream is finalized; return its result (or
        raise its error)."""
        with self._cond:
            self.last_activity = time.monotonic()
            self.waiters += 1
            try:
                done = self._cond.wait_for(
                    lambda: self.closed, timeout=timeout
                )
            finally:
                self.waiters -= 1
                self.last_activity = time.monotonic()
            if not done:
                raise TimeoutError(
                    f"session {self.sid} did not finalize within {timeout}s"
                )
            if self.error is not None:
                raise self.error
            self._result_delivered = True
            return self._result

    # -- telemetry snapshot (heartbeat thread) -----------------------------

    def snapshot(self) -> dict:
        with self._cond:  # reentrant: the scheduler snapshots under it
            t0 = self._t0
            done = self.done
            idle = time.monotonic() - self.last_activity
            rb = dict(self._rb)
            rb_deduped = self.deduped_frames
            qos = self.qos_class
            d_hits = self.deadline_hits
            d_misses = self.deadline_misses
            preempted = self.preempted_dispatches
        elapsed = (
            max(time.perf_counter() - t0, 1e-9)
            if t0 is not None
            else None
        )
        out = {
            "name": f"{self.tenant}/{self.sid}",
            "frames": done,
            "fps": (done / elapsed) if elapsed else 0.0,
            "idle_s": round(max(idle, 0.0), 1),
            "qos_class": qos,
        }
        if d_hits or d_misses:
            out["deadline_hits"] = int(d_hits)
            out["deadline_misses"] = int(d_misses)
        if preempted:
            out["preempted_dispatches"] = int(preempted)
        if rb_deduped:
            rb["deduped_frames"] = int(rb_deduped)
        if any(
            v for v in rb.values() if not isinstance(v, (list, str))
        ) or rb.get("quarantined_parts"):
            out["robustness"] = rb
        return out
