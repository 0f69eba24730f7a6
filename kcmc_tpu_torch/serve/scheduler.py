"""StreamScheduler: cross-session batching, fairness, and QoS admission
(the port's copy of kcmc_tpu/serve/scheduler.py).

The resident serving plane's core loop. One warm backend (a
`TorchBackend` on the card, or any registered backend; owned by the
corrector the scheduler is built around) serves every session. A
backend without `process_batch_async` (the NumPy oracle, a plugin) is
dispatched through its plain `process_batch`, its host outputs drained
in order:

* **Cross-stream batching** — ready frames are taken per session (each
  device batch carries ONE session's reference, the per-entry-ref
  dispatch seam of the pipelined dispatch) and interleaved through a
  single bounded in-flight window (`serve_inflight` batches): each
  batch's downloads start at dispatch into pooled pinned buffers
  (`process_batch_async`) and are materialized at drain
  (`TorchBackend.to_host`, where a deferred device error surfaces and
  walks the ladder), so the card never idles while ANY stream has
  work. Registration-only sessions dispatch with `emit_frames=False`:
  no (B, H, W) download starts for them.
* **Fairness** — weighted round-robin across sessions with ready
  frames: a session opened with weight w gets w interleaved slots per
  cycle, so a bulk-backfill tenant cannot starve a live interactive
  stream.
* **Admission control + QoS** — a submit that would push a session's
  pending queue past `serve_queue_depth` is rejected 429-style, but
  rejection is the LAST resort: past `serve_degrade_watermark` of the
  bound, the session's batches dispatch through a degraded backend
  (reduced RANSAC hypothesis budget and refine/polish passes — the
  consensus-stage rungs of the robustness ladder, which never change
  reference preparation) so the backlog drains faster at reduced
  accuracy instead of being refused. Decisions are counted in
  `stats()` and narrated by the aggregate heartbeat.

Device errors walk the SAME degradation ladder as one-shot runs
(retry -> the CPU failover backend -> mark-failed + trajectory rescue),
per session, via each session's corrector view. Only injected transient
faults enter the ladder: a fatal dispatch error (a kernel that does not
build or launch, any other fault of the program) raises from it and
fails that session's stream, its error reaching `close_session` and the
client, as a one-shot run's reaches its caller; it never moves the work
to the CPU. (The reference instead quarantines the backend on a fatal
error and recovers the batch on the failover rung.) Repeated transient
strikes quarantine the backend and rebuild it off the request path. A
rebuild recovers from errors that leave the CUDA context usable; a
sticky CUDA error (an illegal address, say) poisons the whole context,
and no rebuild inside the process recovers from it: restart the server
(with `--journal-dir`, its streams resume). So after a fatal dispatch
error the scheduler probes the card once (`device_context_lost`). A
lost context stops dispatch for good: the stream whose batch raised
fails (listed in `failed_sessions`), every other stream is released
with a `DeviceLostError` (code 503, its journal frozen at its last
durable snapshot), and new sessions, submits and resumes are refused
with it. `device_lost` in the supervisor block of `stats()` tells a
fleet router the replica is dead: the released streams migrate from
their journals, the failed one does not.

Threading model: ONE scheduler thread owns dispatch, drains, template
updates, and finalization; client threads only enqueue (submit/open/
close) under the scheduler lock and wait on per-session conditions.
Warm-up and rebuild threads launch on the card too: every thread uses
the device's default stream, the backend's copy streams are ordered by
its own events, and a kernel library's first build is serialized
(ops/cuda_build.py).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import uuid
from collections import deque

import numpy as np

from kcmc_tpu_torch.backends import get_backend
from kcmc_tpu_torch.obs.latency import SegmentLatencies
from kcmc_tpu_torch.obs.log import advise
from kcmc_tpu_torch.plans.buckets import batch_ladder, route_batch


def device_context_lost(device) -> bool:
    """True when the CUDA context of `device` no longer works: one
    `torch.cuda.synchronize` that raises (a sticky error — an illegal
    address, a kernel trap — raises again at every later call). A CPU
    device has no context to lose."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return False
    try:
        torch.cuda.synchronize(device)
    except Exception:
        return True
    return False


# Failed stream ids `stats()` keeps listing for the fleet router.
_FAILED_SIDS_KEEP = 256


class DeviceLostError(RuntimeError):
    """503-style refusal of a server whose CUDA context is lost: the
    stream did not cause the loss and is released so that it resumes
    elsewhere from its journal. Carries `.code` for transports."""

    code = 503


class OverloadedError(RuntimeError):
    """429-style admission rejection: the session's queue is full even
    after QoS degradation engaged — or, with predictive admission, a
    deadline the horizon model already predicts will be missed
    (`predicted_wait_s` carries the prediction so clients can back off
    an informed amount). Carries `.code` for transports."""

    code = 429

    def __init__(
        self, message: str, queued: int, limit: int,
        predicted_wait_s: float | None = None,
    ):
        super().__init__(message)
        self.queued = int(queued)
        self.limit = int(limit)
        self.predicted_wait_s = (
            float(predicted_wait_s) if predicted_wait_s is not None else None
        )


class StreamScheduler:
    """Multiplex concurrent `Session` streams through one warm backend.

    `corrector` is the resident MotionCorrector whose backend (and
    compiled batch programs) every session shares; its config supplies
    `batch_size` and the serve_* QoS knobs.
    """

    def __init__(self, corrector, heartbeat_s: float = 0.0):
        self.mc = corrector
        cfg = corrector.config
        self.B = cfg.batch_size
        self.inflight_depth = cfg.serve_inflight
        self.queue_depth = cfg.serve_queue_depth
        self.watermark = cfg.serve_degrade_watermark
        self.journal_dir = cfg.serve_journal_dir
        self.journal_every = cfg.serve_journal_every
        self.session_timeout_s = cfg.serve_session_timeout_s
        # Latency QoS (docs/SERVING.md "Latency QoS"): the deadline-
        # aware dispatch knobs, plus the halving batch-bucket ladder a
        # deadline-forced partial window pads to (smallest covering
        # rung — a smaller compiled program is a faster one).
        self.fill_floor = cfg.serve_latency_fill_floor
        self.admission_predict = cfg.serve_latency_admission
        self.horizon_refresh_s = cfg.serve_latency_horizon_refresh_s
        self.starvation_limit = cfg.serve_latency_starvation_limit
        self._rungs = batch_ladder(self.B)
        # Dispatch-horizon model cache (predicted seconds from "dispatch
        # now" to results, per rung): recomputed from the live latency
        # histograms at most every horizon_refresh_s — scheduling
        # decisions read a dict, not quantile math.
        self._horizon_cache: dict | None = None
        self._horizon_last = -float("inf")
        # Bounded-starvation ledger: batch-class sessions a latency
        # preemption skipped while they had ready frames accumulate
        # credit; at serve_latency_starvation_limit one gets the next
        # slot unconditionally (credit reset, grant counted).
        self._starve_credit: dict[str, int] = {}
        # Latency sessions whose deadline-forced partial is being held
        # below serve_latency_fill_floor (the dispatch that finally
        # fires records why="fill_floor").
        self._floor_deferred: set = set()
        # (shape, rung) partial-window programs already background-
        # compiled for latency streams (see _maybe_warm_partial_rungs).
        self._rung_warm_started: set = set()
        # The serve plane's OWN fault-plan instance, for the surfaces
        # the plane (not a session) owns: `scheduler` here, `transport`
        # in serve/server.py's handler. Sessions arm their own plans
        # (per-stream deterministic op counters) for device/io/journal.
        from kcmc_tpu_torch.utils.faults import resolve_fault_plan

        self.fault_plan = resolve_fault_plan(cfg.fault_plan, seed=cfg.seed)
        # RLock: paths like a take_batch failure call session methods
        # (fail -> _cond, built on this same lock) while already
        # holding it — reentrancy beats a deadlock class.
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._sessions: dict[str, object] = {}
        self._reserved: set = set()  # sids mid-construction (open_session)
        self._order: list[str] = []  # weighted round-robin schedule
        self._rr = 0
        self._window: deque = deque()  # in-flight entries (scheduler thread)
        self._degraded_backend = None
        self._degraded_build = threading.Lock()
        # Frame shapes whose degraded-budget programs have been warmed
        # (and those with a warm-up in flight or permanently failed —
        # never re-attempted). See _warm_degraded_shape.
        self._degraded_warm_started: set = set()
        # Recently closed session ids: a `results` poll racing a
        # concurrent close must read "exhausted", not "no such session"
        # (bounded — ids only, never session state).
        self._closed_ids: set = set()
        self._closed_order: deque = deque(maxlen=4096)
        # The most recently closed Session OBJECTS, so a close_session
        # that timed out client-side can be retried without losing the
        # stream's final result, and a late results poll can still
        # deliver undelivered spans. Small and bounded — these retain
        # result arrays (pixels included for emit sessions).
        self._recent: dict[str, object] = {}
        self._recent_depth = 16
        self._running = False
        self._thread: threading.Thread | None = None
        # Non-daemon warm-up and rebuild threads (card work must never
        # run on a daemon thread); joined on stop(). See _spawn_warmup.
        self._warm_threads: list[threading.Thread] = []
        self._heartbeat = None
        self._heartbeat_s = float(heartbeat_s)
        self._seq = 0
        # Backend supervision (docs/ROBUSTNESS.md "Serve-plane
        # failures"): consecutive primary-backend transient batch
        # failures; at cfg.serve_backend_strikes the backend is
        # quarantined and rebuilt on a background thread while the
        # ladder's rungs keep sessions flowing. All under the plane
        # lock.
        self._strikes = 0
        self._strike_limit = cfg.serve_backend_strikes
        self._rebuilding = False
        # Monotonic stamp of the last rebuild attempt's completion: a
        # transient fault that keeps recurring walks the ladder and
        # keeps coming, and without a cooldown every recurrence would
        # quarantine + rebuild + re-prewarm the whole plane forever.
        self._last_rebuild = -float("inf")
        # Set once a fatal dispatch error left the CUDA context unusable
        # (device_context_lost): every later batch of this process
        # would fail, so nothing dispatches again. `_lost_by` is the
        # stream whose batch raised. The streams fatal errors failed,
        # oldest first (bounded).
        self._device_lost = False
        self._lost_by: str | None = None
        self._failed_sids: deque = deque(maxlen=_FAILED_SIDS_KEEP)
        # Serializes resume_session end to end (journal load ->
        # open -> restore): a replayed/raced resume of the same id
        # must observe the winner's FULLY restored session, never a
        # freshly opened one whose cursor is still 0.
        self._resume_lock = threading.Lock()
        # Liveness beat of the scheduler loop (monotonic): stats() and
        # the wedge watchdog read its age — a large age with pending
        # work means the loop is wedged, not idle.
        self._loop_beat = time.monotonic()
        # Plane-wide request-latency rollup of CLOSED sessions
        # (obs/latency.py): each session's histograms fold in exactly
        # once at close (`_record_closed_locked`), so `metrics()`'s
        # plane view = this accumulator merged with the live sessions
        # — an EXACT merge, bit-identical to recording every sample
        # into one histogram.
        self._lat_closed = SegmentLatencies()
        # Distributed tracing (obs/tracing.py, docs/OBSERVABILITY.md
        # "Distributed tracing"): one bounded span shard per serving
        # process when `trace_shard_dir` is set — traced requests emit
        # their lifecycle-segment and rpc.server spans here, the
        # `trace` verb serves its in-memory ring, and the collector
        # stitches the shard with the client's.
        self.trace_shard = None
        if cfg.trace_shard_dir:
            from kcmc_tpu_torch.obs.tracing import SpanShard

            self.trace_shard = SpanShard(
                os.path.join(
                    cfg.trace_shard_dir,
                    f"spans-{os.getpid()}-{uuid.uuid4().hex[:8]}.jsonl",
                ),
                cap=cfg.trace_shard_cap,
            )
        # Exemplars: bounded last-wins (segment, rung, bucket) ->
        # trace id, exported as the `exemplars` metrics section so the
        # p99 bucket names real traces. Parallel to the histograms —
        # their bit-identity merge contract stays untouched.
        self._exemplars = None
        if cfg.latency_telemetry:
            from kcmc_tpu_torch.obs.tracing import ExemplarStore

            self._exemplars = ExemplarStore()
        # SLO burn-rate engine (obs/slo.py): armed by the declarative
        # `slo_objectives` config spec; ticked by the scheduler loop
        # and surfaced via metrics()/snapshot().
        self._slo = None
        self._slo_tick_last = 0.0
        if cfg.slo_objectives:
            from kcmc_tpu_torch.obs.slo import SLOEngine

            self._slo = SLOEngine(cfg.slo_objectives)
        self._stats = {
            "accepted_frames": 0,
            "rejected_submits": 0,
            "rejected_frames": 0,
            "degrade_events": 0,
            "degraded_batches": 0,
            "batches": 0,
            "occupied_frames": 0,  # valid frames across dispatched batches
            "frames_done": 0,
            # serve fault tolerance
            "deduped_frames": 0,  # idempotent-submit replays dropped
            "backend_rebuilds": 0,  # quarantine->rebuild cycles started
            "sessions_resumed": 0,  # journal resumes served
            "sessions_reaped": 0,  # stale sessions journaled + closed
            # latency QoS (docs/SERVING.md "Latency QoS")
            "preemptions": 0,  # latency dispatches that jumped the WRR
            "starvation_grants": 0,  # starved batch sessions given a slot
            "rejected_deadline_submits": 0,  # predictive-admission 429s
            "deadline_hits": 0,  # folded from sessions at close
            "deadline_misses": 0,
            # Every dispatch records exactly one `why` (the literal
            # keys ARE the registry-checked counter vocabulary —
            # obs/registry.py DISPATCH_WHY_COUNTERS; mirrored as
            # SpanShard counters when tracing is armed).
            "dispatch_why": {
                "dispatch.why.full_window": 0,
                "dispatch.why.deadline_forced": 0,
                "dispatch.why.preempted": 0,
                "dispatch.why.fill_floor": 0,
                "dispatch.why.flush": 0,
            },
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "StreamScheduler":
        with self._lock:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="kcmc-serve-scheduler", daemon=True
        )
        self._thread.start()
        if self.watermark < 1.0:
            # Prewarm the QoS escape hatch's CONSTRUCTION (backend +
            # mesh setup). Its compiled batch programs are shape-
            # dependent, so those warm later, per shape, as sessions'
            # references are prepared (_warm_degraded_shape) — well
            # before overload can engage on that shape.
            self._spawn_warmup(
                self._warm_degraded, "kcmc-serve-degraded-warm"
            )
        if self._heartbeat_s > 0:
            from kcmc_tpu_torch.obs.heartbeat import Heartbeat, aggregate_sampler

            self._heartbeat = Heartbeat(
                self._heartbeat_s, aggregate_sampler(self.snapshot)
            )
            self._heartbeat.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the scheduler thread. In-flight batches drain; sessions
        still open are finalized (complete streams) or failed (streams
        with frames left) — a clean shutdown closes sessions first."""
        if self._heartbeat is not None:
            self._heartbeat.stop()
            self._heartbeat = None
        with self._wake:
            self._running = False
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        with self._lock:
            warm, self._warm_threads = self._warm_threads, []
        for t in warm:
            t.join(timeout=timeout)
        if self.trace_shard is not None:
            self.trace_shard.close()

    def _spawn_warmup(self, target, name: str, args: tuple = ()) -> None:
        """Warm-up and rebuild threads launch kernels on the card (and
        may run a kernel library's first nvcc build), so they are
        NON-daemon and joined on stop — a daemon thread killed inside a
        CUDA call at interpreter exit can abort the teardown. Bounded:
        one construction warm-up plus one per distinct frame shape (and
        one rebuild at a time)."""
        t = threading.Thread(
            target=target, name=name, args=args, daemon=False
        )
        with self._lock:
            self._warm_threads = [
                w for w in self._warm_threads if w.is_alive()
            ]
            self._warm_threads.append(t)
            # start INSIDE the lock: stop() swaps the list under the
            # same lock, so every thread it joins has been started
            # (join on a never-started thread raises), and a racing
            # spawn's is_alive() prune cannot drop a tracked thread
            # between append and start
            t.start()

    def __enter__(self) -> "StreamScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- session management (client threads) -------------------------------

    def open_session(
        self,
        tenant: str = "default",
        weight: int = 1,
        reference=None,
        template_update_every: int | None = None,
        emit_frames: bool = False,
        output: str | None = None,
        expected_frames: int | None = None,
        output_dtype="float32",
        compression: str = "none",
        session_id: str | None = None,
        telemetry: bool = True,
        qos_class: str = "batch",
        deadline_ms: float | None = None,
    ):
        """Open a stream: builds a per-session corrector view sharing
        the warm backend, registers it with the fairness schedule, and
        returns the `Session`. `qos_class` ("latency" | "batch") picks
        the scheduling class; `deadline_ms` is the session-default
        per-frame deadline (docs/SERVING.md "Latency QoS")."""
        from kcmc_tpu_torch.serve.session import Session

        self._refuse_if_lost()
        view = self.mc.stream_view(
            reference=reference,
            template_update_every=template_update_every,
        )
        ref_arr = None
        if isinstance(reference, np.ndarray):
            # Validate BEFORE any session state exists: a bad reference
            # must fail without arming (and leaking) telemetry
            # artifact-path claims.
            ref_arr = np.asarray(reference, np.float32)
            if ref_arr.ndim != 2:
                raise ValueError(
                    f"reference frame must be 2-D, got shape "
                    f"{ref_arr.shape}"
                )
        with self._wake:
            if not self._running:
                raise RuntimeError("scheduler is not running")
            self._seq += 1
            sid = session_id if session_id else f"s{self._seq:04d}"
            if sid in self._sessions or sid in self._reserved:
                raise ValueError(f"session id {sid!r} already open")
            self._reserved.add(sid)
        # Construct OUTSIDE the plane lock: telemetry arming builds a
        # manifest (version probes, config digest) — other tenants'
        # submits and the scheduler loop must not stall behind it. The
        # reservation above keeps the sid unique meanwhile.
        sess = None
        try:
            sess = Session(
                view, self._lock, sid, tenant=tenant, weight=weight,
                emit_frames=emit_frames, output=output,
                expected_frames=expected_frames, output_dtype=output_dtype,
                compression=compression, telemetry=telemetry,
                trace_shard=self.trace_shard, exemplars=self._exemplars,
                qos_class=qos_class, deadline_ms=deadline_ms,
            )
            if self.journal_dir:
                from kcmc_tpu_torch.serve.journal import SessionJournal

                # The session's own fault plan / report: journal faults
                # and durability counters are per-stream like every
                # other robustness surface.
                sess.attach_journal(
                    SessionJournal(
                        self.journal_dir, sid, every=self.journal_every,
                        fault_plan=sess.mc._fault_plan,
                        report=sess.mc._robustness,
                    )
                )
            with self._wake:
                # Reference staging happens under the plane lock with
                # the registration: the scheduler thread reads the
                # staged source under the same lock, and ref_arr is
                # already float32 so this is pointer work, not a copy.
                if ref_arr is not None:
                    sess.set_reference(ref_arr)
                self._sessions[sid] = sess
                self._rebuild_order()
                self._wake.notify_all()
            return sess
        except BaseException as e:
            # A constructed-but-never-registered session still owns
            # telemetry (artifact-path claims): release it, or the
            # registry treats those paths as live forever.
            if sess is not None and sess.telemetry is not None:
                try:
                    sess.telemetry.close(e)
                except Exception:
                    pass
            raise
        finally:
            with self._wake:
                self._reserved.discard(sid)

    def _rebuild_order(self) -> None:
        # Weighted round-robin schedule: a session with weight w appears
        # w times per cycle, interleaved (not clustered) so a heavy
        # tenant's extra slots spread across the cycle.
        sids = sorted(self._sessions)
        if not sids:
            self._order = []
            self._rr = 0
            return
        maxw = max(self._sessions[s].weight for s in sids)
        self._order = [
            s
            for round_i in range(maxw)
            for s in sids
            if round_i < self._sessions[s].weight
        ]
        self._rr %= len(self._order)

    def resume_session(self, session_id: str) -> tuple:
        """Resume a journaled stream on this (possibly restarted)
        server: returns ``(session, cursor, resumed)``.

        Idempotent by construction — the client reconnect path calls
        it blindly. A session still live on this server returns as-is
        (``resumed=False``) with its current submit cursor, so a
        client that merely lost its socket re-syncs without touching
        session state. Otherwise the journal is loaded (quarantined
        with a warning when corrupt), validated against the serving
        config's resume signature, and a fresh session is rehydrated
        from the snapshot; the client re-submits frames from `cursor`.
        """
        from kcmc_tpu_torch.serve import journal as journal_mod

        self._refuse_if_lost()
        with self._resume_lock:
            return self._resume_session_locked(session_id, journal_mod)

    def _refuse_if_lost(self) -> None:
        """Refuse new work 503-style once the CUDA context is lost."""
        with self._lock:
            lost = self._device_lost
        if lost:
            raise DeviceLostError(
                "the CUDA context of this server is lost; open or "
                "resume the stream on another server"
            )

    def _resume_session_locked(self, session_id: str, journal_mod) -> tuple:
        with self._lock:
            sess = self._sessions.get(session_id)
            if sess is not None:
                return sess, sess.submitted, False
        if not self.journal_dir:
            raise KeyError(
                f"no open session {session_id!r} (and journaling is "
                "off — set serve_journal_dir / --journal-dir to make "
                "streams resumable)"
            )
        path = journal_mod.journal_path(self.journal_dir, session_id)
        # Collect any part quarantined during the load so the counter
        # reaches the resumed session's RobustnessReport below — the
        # documented contract; corruption must not be advisory-only.
        from kcmc_tpu_torch.utils.metrics import RobustnessReport

        load_report = RobustnessReport()
        loaded = journal_mod.load_session_journal(path, report=load_report)
        if loaded is None:
            raise KeyError(
                f"no journal for session {session_id!r} under "
                f"{self.journal_dir} (never journaled, already closed, "
                "or quarantined as corrupt)"
            )
        meta, segments, arrays = loaded
        if meta.get("backend") and meta["backend"] != self.mc.backend_name:
            # same gate the one-shot checkpoint signature carries: a
            # stream's numerics (warm seeds, template history) must not
            # mix two backends across the resume seam
            raise ValueError(
                f"session {session_id!r} was journaled on backend "
                f"{meta['backend']!r}; this server runs "
                f"{self.mc.backend_name!r} — restart with the original "
                "backend to resume it"
            )
        want = journal_mod.serve_config_signature(self.mc.config)
        if meta.get("config") != want:
            raise ValueError(
                f"session {session_id!r} was journaled under an "
                "incompatible serving config (resume-signature "
                "mismatch); restart the server with the original "
                "config to resume it"
            )
        if meta.get("output"):
            raise ValueError(
                f"session {session_id!r} wrote a server-side output "
                "file; those streams are not journal-resumable (the "
                "writer state is not journaled) — use correct_file "
                "checkpoints for durable file runs"
            )
        tue = meta.get("template_update_every")
        try:
            sess = self.open_session(
                tenant=meta.get("tenant", "default"),
                weight=int(meta.get("weight", 1)),
                # 0 is meaningful (an explicit no-rolling override), so
                # only an absent key falls back to the server default
                template_update_every=int(tue) if tue is not None else None,
                emit_frames=bool(meta.get("emit_frames", False)),
                expected_frames=meta.get("expected_frames"),
                session_id=session_id,
            )
        except ValueError:
            # two clients racing to resume the same stream: the loser's
            # open collides with the winner's registration — hand back
            # the now-live session (same contract as the live-check)
            with self._lock:
                live = self._sessions.get(session_id)
            if live is not None:
                return live, live.submitted, False
            raise
        if load_report.quarantined_parts:
            with self._lock:
                sess.mc._robustness.quarantined_parts.extend(
                    load_report.quarantined_parts
                )
        # restore takes the plane lock itself, releasing it around the
        # boundary template blend (device-frame-sized host compute must
        # not stall other tenants); _resume_lock + the restore guard
        # keep the gap safe
        t_restore = time.perf_counter()
        try:
            sess.restore_from_journal(
                meta, segments, arrays, journal=sess.journal
            )
        except BaseException as e:
            # The open above registered the session: left alive but
            # un-restored, the live-check would hand it back on the
            # next resume with cursor 0 and the client would silently
            # re-submit the whole stream as fresh frames. Fail it so
            # the scheduler finalizes and removes it (the error keeps
            # the on-disk journal for the retry), then surface the
            # restore error.
            sess.fail(e)
            with self._wake:
                self._wake.notify_all()
            raise
        restore_dur = time.perf_counter() - t_restore
        with self._wake:
            self._stats["sessions_resumed"] += 1
            self._wake.notify_all()
        # resume cost is a DURATION span (trace) + latency segment
        # (`metrics` verb) — rehydration is real work (array decode,
        # boundary re-roll), not an instant
        if sess.telemetry is not None and sess.telemetry.tracer is not None:
            sess.telemetry.tracer.complete(
                "journal.resume", t_restore, restore_dur, cat="journal",
                args={"done": int(meta["done"])},
            )
        if sess.lat is not None:
            sess.lat.observe("journal.resume", restore_dur)
        advise(
            f"kcmc serve: session {session_id} resumed from its "
            f"journal at frame {int(meta['done'])}",
            stacklevel=2,
        )
        return sess, int(meta["done"]), True

    def submit(
        self, session_id: str, frames, first: int | None = None,
        trace: dict | None = None, deadline_ms: float | None = None,
        replay: bool = False,
    ):
        """Admission-controlled submit. Returns a decision dict
        ``{"accepted", "queued", "degraded", "next"}``; raises
        OverloadedError when the queue bound is exceeded (the last
        resort — QoS degradation engages first, at the watermark).

        `first` is the idempotency key: the session-global index of
        this call's first frame. A retried submit (client reconnect
        after a transport timeout) replays frames the server already
        admitted — the overlap is deduplicated here, so retries never
        double-process a frame; a `first` PAST the session cursor is a
        gap (lost frames) and is rejected so a stream can never
        silently skip. Without `first` (legacy callers) frames append
        unconditionally.

        `trace` is the request's distributed-trace context (the
        server's span for this call, obs/tracing.py): the admitted
        frames inherit it, so their queue/dispatch/device/drain spans
        and bucket exemplars name the originating trace id.

        `deadline_ms` stamps this call's frames with a per-frame
        deadline (milliseconds from now; overrides the session
        default). With `serve_latency_admission` on, a submit whose
        PREDICTED wait — the dispatch-horizon model plus the plane's
        backlog in device-p50 units — already exceeds its deadline is
        rejected 429-style up front with `predicted_wait_s`, instead
        of being admitted into a miss (docs/SERVING.md "Latency QoS")."""
        t_call = time.perf_counter()  # request.total's anchor
        frames = np.asarray(frames)
        if frames.ndim == 2:
            frames = frames[None]
        n = len(frames)
        with self._wake:
            if self._device_lost and session_id != self._lost_by:
                raise self._lost_error()
            sess = self._get(session_id)
            deduped = 0
            if first is not None:
                expected = sess.submitted
                if int(first) > expected:
                    raise ValueError(
                        f"session {session_id}: submit gap — frames "
                        f"{expected}..{int(first)} were never received "
                        "(resync from resume_session's cursor)"
                    )
                deduped = min(expected - int(first), n)
                if deduped:
                    frames = frames[deduped:]
                    n -= deduped
                if n == 0:
                    # pure replay: touch liveness, change nothing
                    sess.deduped_frames += deduped
                    self._stats["deduped_frames"] += deduped
                    sess.last_activity = time.monotonic()
                    return {
                        "accepted": 0,
                        "queued": sess.backlog(),
                        "degraded": sess.degraded,
                        "deduped": deduped,
                        "next": sess.submitted,
                    }
            queued = sess.backlog()
            if queued + n > self.queue_depth:
                self._stats["rejected_submits"] += 1
                self._stats["rejected_frames"] += n
                raise OverloadedError(
                    f"session {session_id}: queue {queued}+{n} frames "
                    f"exceeds serve_queue_depth={self.queue_depth} "
                    "(submit less per call, or wait for results)",
                    queued=queued, limit=self.queue_depth,
                )
            eff_dl = deadline_ms if deadline_ms is not None else (
                sess.deadline_ms
            )
            # `replay` marks a migration re-delivery: admission already
            # ran once when the client first submitted these frames, and
            # rejecting them now would strand the stream mid-migrate —
            # prediction never re-judges spent budget.
            if (
                self.admission_predict and eff_dl is not None and n
                and not replay
            ):
                predicted = self._predicted_wait_locked(sess, queued + n)
                if (
                    predicted is not None
                    and predicted > float(eff_dl) / 1000.0
                ):
                    # Reject-with-hint: admitting would only manufacture
                    # a deadline miss — tell the client how long the
                    # plane predicts it would actually take.
                    self._stats["rejected_submits"] += 1
                    self._stats["rejected_frames"] += n
                    self._stats["rejected_deadline_submits"] += 1
                    raise OverloadedError(
                        f"session {session_id}: predicted wait "
                        f"{predicted:.3f}s exceeds the "
                        f"{float(eff_dl) / 1000.0:.3f}s deadline "
                        "(predictive admission — retry later, relax "
                        "deadline_ms, or disable "
                        "serve_latency_admission)",
                        queued=queued, limit=self.queue_depth,
                        predicted_wait_s=round(predicted, 4),
                    )
            engage = (
                not sess.degraded
                and self.watermark < 1.0
                and queued + n > self.watermark * self.queue_depth
            )
            # Validate/admit BEFORE flipping QoS state: a mis-shaped
            # submit raises here and must not leave the session
            # permanently degraded by load it never added.
            sess.add_frames(frames, deadline_ms=deadline_ms)
            self._stats["accepted_frames"] += n
            if sess.lat is not None and n:
                # Per-request lifecycle tracing (obs/latency.py): each
                # admitted frame's clock starts at the submit call;
                # admission covers the lock wait + decision, and the
                # (t_call, t_admitted) stamps seed queue_wait/total.
                t_adm = time.perf_counter()
                sess._t_submit.extend([(t_call, t_adm)] * n)
                rung = sess._rung()
                sess.lat.observe(
                    "request.admission", t_adm - t_call, n=n, rung=rung,
                )
                if trace is not None:
                    sess.note_trace(trace, n)
                    sess.trace_obs(
                        "request.admission", t_adm - t_call, n, rung,
                        trace,
                    )
            # Dedup counts only once the trimmed remainder is ADMITTED:
            # a rejected/raising submit will be retried verbatim, and
            # counting its overlap on every attempt would inflate the
            # replay counters with phantom frames.
            if deduped:
                sess.deduped_frames += deduped
                self._stats["deduped_frames"] += deduped
            if engage:
                sess.degraded = True
                self._stats["degrade_events"] += 1
                advise(
                    f"kcmc serve: session {session_id} backlog "
                    f"{queued + n}/{self.queue_depth} frames passed the "
                    f"{self.watermark:.0%} watermark; dispatching its "
                    "batches at degraded consensus budgets until it drains",
                    stacklevel=2,
                )
            self._wake.notify_all()
            return {
                "accepted": n,
                "queued": sess.backlog(),
                "degraded": sess.degraded,
                "deduped": deduped,
                "next": sess.submitted,
            }

    def close_session(self, session_id: str, timeout: float | None = None):
        """Mark a stream complete; block until its remaining frames
        drain and it finalizes. Returns the final CorrectionResult.
        Retryable: a close that timed out client-side can be reissued —
        a recently reaped session still returns its final result
        (transforms/diagnostics; retained results drop emit pixels)."""
        with self._wake:
            sess = self._sessions.get(session_id)
            if sess is not None:
                sess.begin_close()
                self._wake.notify_all()
        if sess is None:
            # Already finalized and reaped (e.g. a retry after a
            # timed-out close): result() returns immediately.
            sess = self.lookup_session(session_id)
        out = sess.result(timeout=timeout)
        # A client-initiated close that successfully consumed the
        # result IS the clean close, even when the stream was already
        # finalized by a staleness reap or shutdown drain (which keep
        # the journal) — discard it, or resume_session could resurrect
        # a stream its client believes complete into a duplicate.
        # Under _resume_lock, and only while no LIVE session holds the
        # sid: a session resumed between the reap and this close retry
        # shares the journal path, and discarding it out from under
        # that live stream would silently destroy its durability.
        with self._resume_lock:
            with self._lock:
                live = self._sessions.get(session_id)
                j = sess.journal
                if live is None or live is sess:
                    sess.journal = None
            if j is not None and (live is None or live is sess):
                j.discard()
        return out

    def _get(self, session_id: str):
        sess = self._sessions.get(session_id)
        if sess is None:
            raise KeyError(f"no open session {session_id!r}")
        return sess

    def session_closed(self, session_id: str) -> bool:
        """Whether `session_id` was a real session that has since
        closed (vs never existing) — lets a `results` poll racing a
        concurrent close report "exhausted" instead of erroring."""
        with self._lock:
            return session_id in self._closed_ids

    def lookup_session(self, session_id: str):
        """A live session, or a recently closed one retained for late
        result()/fetch() reads (e.g. a close_session retry after a
        client-side timeout); KeyError otherwise."""
        with self._lock:
            sess = self._sessions.get(session_id)
            if sess is None:
                sess = self._recent.get(session_id)
        if sess is None:
            raise KeyError(f"no open session {session_id!r}")
        return sess

    def _record_closed_locked(self, sess) -> None:
        if len(self._closed_order) == self._closed_order.maxlen:
            self._closed_ids.discard(self._closed_order[0])
        self._closed_order.append(sess.sid)
        self._closed_ids.add(sess.sid)
        # Fold the stream's deadline scorecard into the plane counters
        # (same exactly-once close seam as the latency fold below) and
        # drop its QoS ledger entries.
        self._stats["deadline_hits"] += int(sess.deadline_hits)
        self._stats["deadline_misses"] += int(sess.deadline_misses)
        self._starve_credit.pop(sess.sid, None)
        self._floor_deferred.discard(sess.sid)
        # Fold the stream's latency histograms into the plane rollup
        # exactly once — finalize has already closed its delivery
        # segments, so nothing records into `sess.lat` after this and
        # the plane view stays an exact merge.
        if sess.lat is not None and not sess._lat_folded:
            sess._lat_folded = True
            self._lat_closed.merge_from(sess.lat)
        # Retention must not pin pixels: an emit session's final result
        # holds the whole corrected stack, so once a client has RECEIVED
        # it (delivered flag — an undelivered result stays whole for the
        # still-blocked/retrying waiter), a later retried close gets
        # transforms/diagnostics only. Undelivered `results` spans in
        # _outs keep their pixels — a racing poll still gets them, and
        # fetch releases each span as it delivers.
        res = sess._result
        if sess._result_delivered and res is not None and (
            res.corrected is not None and len(res.corrected)
        ):
            sess._result = dataclasses.replace(
                res, corrected=np.empty((0,), np.float32)
            )
        self._recent[sess.sid] = sess
        while len(self._recent) > self._recent_depth:
            self._recent.pop(next(iter(self._recent)))

    # -- stats / heartbeat --------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            sessions = list(self._sessions.values())
            st = dict(self._stats)
            # deep-copy the nested why dict (the shallow dict() above
            # shares it with the scheduler thread's increments) and
            # fold LIVE sessions' deadline scorecards over the closed
            # accumulator, all under the plane lock
            why = dict(self._stats["dispatch_why"])
            d_hits = st["deadline_hits"] + sum(
                s.deadline_hits for s in sessions
            )
            d_misses = st["deadline_misses"] + sum(
                s.deadline_misses for s in sessions
            )
            qos_classes = {s.sid: s.qos_class for s in sessions}
            inflight = len(self._window)
            # backlog() walks session queues the scheduler mutates —
            # snapshot it under the plane lock, not after it
            queues = {s.sid: s.backlog() for s in sessions}
            degraded_active = sorted(
                s.sid for s in sessions if s.degraded
            )
            db = self._degraded_backend
            strikes = self._strikes
            rebuilding = self._rebuilding
            device_lost = self._device_lost
            failed_sids = list(self._failed_sids)
            beat_age = time.monotonic() - self._loop_beat
            # per-session robustness: the plane-locked snapshots the
            # drain path maintains (never the live report objects)
            robustness = {
                s.sid: dict(s._rb) for s in sessions if s._rb
            }
            journal = {
                s.sid: {
                    "saves": s.journal.saves,
                    "failures": s.journal.failures,
                    "last_saved": s.journal.last_saved,
                }
                for s in sessions
                if s.journal is not None
            }
        batches = max(st["batches"], 1)
        out = {
            "sessions_open": len(sessions),
            "queues": queues,
            "inflight_batches": inflight,
            "batch_size": self.B,
            "batch_occupancy": round(
                st["occupied_frames"] / (batches * self.B), 4
            ),
            "frames_done": st["frames_done"],
            "admission": {
                "accepted_frames": st["accepted_frames"],
                "rejected_submits": st["rejected_submits"],
                "rejected_frames": st["rejected_frames"],
                "degrade_events": st["degrade_events"],
                "degraded_batches": st["degraded_batches"],
                "degraded_active": degraded_active,
            },
            # serve-plane fault tolerance (docs/ROBUSTNESS.md):
            # supervisor state, the loop-wedge gauge, and per-session
            # recovery/durability counters for operators and the CI
            # chaos canaries.
            "supervisor": {
                "backend_strikes": strikes,
                "backend_rebuilding": rebuilding,
                "backend_rebuilds": st["backend_rebuilds"],
                "loop_beat_age_s": round(max(beat_age, 0.0), 3),
                "device_lost": device_lost,
                "failed_sessions": failed_sids,
            },
            "resilience": {
                "deduped_frames": st["deduped_frames"],
                "sessions_resumed": st["sessions_resumed"],
                "sessions_reaped": st["sessions_reaped"],
                "journal_dir": self.journal_dir,
            },
            # deadline-QoS explainability (docs/SERVING.md "Latency
            # QoS"): the dispatch-decision vocabulary, the fairness
            # counters bounding batch-class starvation, and the plane's
            # deadline scorecard (closed sessions + live)
            "deadline_qos": {
                "dispatch_why": why,
                "preemptions": st["preemptions"],
                "starvation_grants": st["starvation_grants"],
                "rejected_deadline_submits": st[
                    "rejected_deadline_submits"
                ],
                "deadline_hits": d_hits,
                "deadline_misses": d_misses,
                "qos_classes": qos_classes,
            },
        }
        if robustness:
            out["robustness"] = robustness
        if journal:
            out["journal"] = journal
        # Execution-plan / kernel-cache accounting (plans/): operators
        # verify a resident server actually starts (and stays) warm —
        # zero stamp_misses after the first boot means every kernel
        # library came from the persistent cache. The degraded QoS
        # rung's backend keeps its own counters.
        stats_fn = getattr(self.mc.backend, "plan_cache_stats", None)
        if stats_fn is not None:
            try:
                ps = stats_fn()
                if ps.get("enabled") or ps.get("programs_compiled"):
                    out["plan_cache"] = ps
            except Exception:
                pass
        dstats_fn = getattr(db, "plan_cache_stats", None) if db else None
        if dstats_fn is not None:
            try:
                dps = dstats_fn()
                if dps.get("programs_compiled"):
                    out["plan_cache_degraded"] = dps
            except Exception:
                pass
        return out

    def metrics(self) -> dict:
        """The scrapeable request-latency/health payload behind the
        `metrics` serve verb (docs/OBSERVABILITY.md "Request
        latency"): plane-wide per-(segment, rung) latency summaries +
        full mergeable histogram state, per-live-session summaries,
        and the serve counters/gauges a Prometheus scraper health-checks
        on. The plane view is an EXACT merge of the closed-session
        rollup and every live session — merging the per-session
        histograms yourself reproduces it bit for bit."""
        per_session: dict = {}
        plane = SegmentLatencies()
        with self._lock:
            sessions = list(self._sessions.values())
            st = dict(self._stats)
            inflight = len(self._window)
            queues = {s.sid: s.backlog() for s in sessions}
            degraded = {s.sid: s.degraded for s in sessions}
            strikes = self._strikes
            rebuilding = self._rebuilding
            beat_age = time.monotonic() - self._loop_beat
            why = dict(self._stats["dispatch_why"])
            d_hits = st["deadline_hits"] + sum(
                s.deadline_hits for s in sessions
            )
            d_misses = st["deadline_misses"] + sum(
                s.deadline_misses for s in sessions
            )
            # Merge INSIDE the plane lock: a session folding into
            # _lat_closed (close happens under this lock) between the
            # live-session snapshot and these merges would otherwise be
            # counted twice, breaking the bit-exact merge contract a
            # scrape relies on. The lock is reentrant, so s.snapshot()
            # is fine here; merges are ~100 integer adds per source.
            plane.merge_from(self._lat_closed)
            for s in sessions:
                snap = s.snapshot()
                entry = {
                    "tenant": s.tenant,
                    "frames": snap.get("frames", 0),
                    "fps": round(float(snap.get("fps", 0.0)), 2),
                    "queued": queues.get(s.sid, 0),
                    "degraded": bool(degraded.get(s.sid)),
                    "qos_class": snap.get("qos_class", "batch"),
                }
                for k in (
                    "deadline_hits", "deadline_misses",
                    "preempted_dispatches",
                ):
                    if k in snap:
                        entry[k] = snap[k]
                if s.lat is not None:
                    plane.merge_from(s.lat)
                    rep = s.lat.report()
                    entry["segments"] = rep["segments"]
                    entry["totals"] = rep["totals"]
                    entry["histograms"] = s.lat.hist_dicts()
                per_session[s.sid] = entry
        plane_rep = plane.report()
        batches = max(st["batches"], 1)
        payload = {
            "schema": "kcmc_metrics/1",
            "latency_telemetry": bool(self.mc.config.latency_telemetry),
            "plane": {
                "segments": plane_rep["segments"],
                "totals": plane_rep["totals"],
                "histograms": plane.hist_dicts(),
            },
            "sessions": per_session,
            "counters": {
                "frames_done": st["frames_done"],
                "accepted_frames": st["accepted_frames"],
                "rejected_submits": st["rejected_submits"],
                "rejected_frames": st["rejected_frames"],
                "deduped_frames": st["deduped_frames"],
                "degrade_events": st["degrade_events"],
                "degraded_batches": st["degraded_batches"],
                "batches": st["batches"],
                "backend_rebuilds": st["backend_rebuilds"],
                "sessions_resumed": st["sessions_resumed"],
                "sessions_reaped": st["sessions_reaped"],
                # deadline QoS — flat ints, summable across servers
                "preemptions": st["preemptions"],
                "starvation_grants": st["starvation_grants"],
                "rejected_deadline_submits": st[
                    "rejected_deadline_submits"
                ],
                "deadline_hits": d_hits,
                "deadline_misses": d_misses,
                **{
                    k.replace("dispatch.why.", "dispatch_why_"): v
                    for k, v in why.items()
                },
            },
            "gauges": {
                "sessions_open": len(sessions),
                "inflight_batches": inflight,
                "batch_size": self.B,
                "batch_occupancy": round(
                    st["occupied_frames"] / (batches * self.B), 4
                ),
                "queued_frames": sum(queues.values()),
                "backend_strikes": strikes,
                "backend_rebuilding": int(rebuilding),
                "loop_beat_age_s": round(max(beat_age, 0.0), 3),
                "queues": queues,
            },
        }
        if self._exemplars is not None:
            ex = self._exemplars.export()
            if ex:
                payload["exemplars"] = ex
        if self._slo is not None:
            self._slo.tick(
                payload["plane"]["histograms"], payload["counters"]
            )
            payload["slo"] = self._slo.gauges()
        return payload

    def trace_dump(self) -> list:
        """Recent finished spans from the process span ring (the
        `trace` serve verb); [] when tracing is unarmed."""
        if self.trace_shard is None:
            return []
        return self.trace_shard.tail()

    def _slo_tick(self) -> None:
        """Advance the burn-rate windows from the scheduler loop (at
        most 1/s) so the SLO state moves even when nobody scrapes."""
        if self._slo is None:
            return
        now = time.monotonic()
        if now - self._slo_tick_last < 1.0:
            return
        self._slo_tick_last = now
        plane = SegmentLatencies()
        with self._lock:
            plane.merge_from(self._lat_closed)
            for s in self._sessions.values():
                if s.lat is not None:
                    plane.merge_from(s.lat)
            counters = dict(self._stats)
        self._slo.tick(plane.hist_dicts(), counters)

    def _latency_beat(self) -> dict | None:
        """End-to-end p50/p99 for the heartbeat line: the plane's
        `request.total` across closed + live sessions (exact merge;
        ~100 integer adds per source — beat-cheap)."""
        with self._lock:
            # under the plane lock for the same close-fold consistency
            # as metrics() — a folding session must never count twice
            h = self._lat_closed.segment_total("request.total")
            for s in self._sessions.values():
                if s.lat is not None:
                    h.merge(s.lat.segment_total("request.total"))
        if not h.count:
            return None
        return {
            "p50_ms": round((h.quantile(50) or 0.0) * 1e3, 1),
            "p99_ms": round((h.quantile(99) or 0.0) * 1e3, 1),
        }

    def snapshot(self) -> dict:
        """Aggregate-heartbeat snapshot (obs.heartbeat.aggregate_sampler)."""
        with self._lock:
            sessions = list(self._sessions.values())
            st = dict(self._stats)
            inflight = len(self._window)
            queues = {s.sid: s.backlog() for s in sessions}
            snaps = [s.snapshot() for s in sessions]
            rebuilding = self._rebuilding
            beat_age = time.monotonic() - self._loop_beat
        batches = max(st["batches"], 1)
        # Aggregate the per-session robustness snapshots so the
        # liveness line narrates recovery (retries/failovers/rescues)
        # next to progress — "slow but surviving" vs "wedged".
        rb_total: dict[str, int] = {}
        for s in snaps:
            for k, v in (s.get("robustness") or {}).items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    rb_total[k] = rb_total.get(k, 0) + int(v)
        rb_total.pop("resumed_from_frame", None)
        for k in ("deduped_frames", "sessions_resumed", "sessions_reaped"):
            if st.get(k):
                rb_total[k] = st[k]
        extra = (
            f"occupancy={st['occupied_frames'] / (batches * self.B):.2f}"
            f" inflight={inflight}"
        )
        if rebuilding:
            extra += " BACKEND-REBUILDING"
        out = {
            "sessions": snaps,
            "queues": queues,
            "admission": {
                "rejected": st["rejected_frames"],
                "degraded": st["degraded_batches"],
            },
            "extra": extra,
            "loop_beat_age_s": round(max(beat_age, 0.0), 3),
        }
        lat = self._latency_beat()
        if lat is not None:
            out["latency"] = lat
        if self._slo is not None:
            slo_line = self._slo.heartbeat()
            if slo_line:
                out["slo"] = slo_line
        if any(rb_total.values()):
            out["robustness"] = rb_total
        if self.session_timeout_s > 0:
            stale = {
                s["name"]: s["idle_s"]
                for s in snaps
                if s.get("idle_s", 0) > 0.5 * self.session_timeout_s
            }
            if stale:
                out["stale"] = stale
        return out

    # -- QoS ----------------------------------------------------------------

    def _horizon_model(self) -> dict:
        """The dispatch-horizon model (plane lock taken; reentrant from
        the pick path): per-segment p50s from the live latency
        histograms — closed-session rollup merged with every live
        session, the same exact-merge plane view `metrics()` serves.
        Cached for `serve_latency_horizon_refresh_s`, so the scheduling
        hot path reads a dict, not quantile math. Zeros until the
        plane has history — callers must treat an all-zero model as
        "no prediction", never as "instant"."""
        now = time.monotonic()
        with self._lock:
            if (
                self._horizon_cache is not None
                and now - self._horizon_last < self.horizon_refresh_s
            ):
                return self._horizon_cache
            self._horizon_last = now
            plane = SegmentLatencies()
            plane.merge_from(self._lat_closed)
            for s in self._sessions.values():
                if s.lat is not None:
                    plane.merge_from(s.lat)
            model = {}
            for seg in (
                "request.batch_form", "request.dispatch", "request.device"
            ):
                h = plane.segment_total(seg)
                model[seg] = (
                    float(h.quantile(50) or 0.0) if h.count else 0.0
                )
            self._horizon_cache = model
            return model

    def _horizon(self, b: int) -> float:
        """Predicted seconds from "dispatch a b-frame window now" to
        its results: batch-form p50 + dispatch p50 + device p50 scaled
        by the rung's share of the full window. 0.0 with no history."""
        m = self._horizon_model()
        return (
            m["request.batch_form"]
            + m["request.dispatch"]
            + m["request.device"] * (b / max(self.B, 1))
        )

    def _predicted_wait_locked(self, sess, queued: int) -> float | None:
        """Predicted seconds until a frame admitted NOW into `sess`
        (bringing its queue to `queued`) has results: the horizon
        model's form+dispatch cost plus the whole plane's backlog —
        in-flight window entries and every session's queued frames,
        in full-window units — at device p50 each. None (never
        reject) until the plane has device history. Plane lock held."""
        m = self._horizon_model()
        dev = m["request.device"]
        if dev <= 0.0:
            return None
        total_queued = int(queued)
        for s in self._sessions.values():
            if s is not sess:
                total_queued += s.backlog()
        backlog_batches = len(self._window) + max(
            1, -(-total_queued // self.B)
        )
        return (
            m["request.batch_form"]
            + m["request.dispatch"]
            + backlog_batches * dev
        )

    def _latency_take_locked(self, sess, peek: bool = False):
        """Decide dispatch-NOW vs defer for a ready latency-class
        session (plane lock held). Returns ``(target_rung, why)`` to
        dispatch, or None to defer — positive deadline slack against
        the dispatch horizon buys time for the window to fill, which
        is what turns the pre-QoS flush-everything behavior into
        deadline-aware batching. `peek` makes it side-effect-free
        (the idle-wait preview must mirror this exactly or the loop
        busy-spins on a deferred session)."""
        n = sess.ready_count()
        if n >= self.B:
            return self.B, "full_window"
        # growth is impossible past a rolling-template boundary gate
        # or once the stream is closing — waiting would be a pure
        # latency tax with zero fill upside
        can_grow = (not sess.closing) and len(sess.pending) == n
        head = sess.head_deadline()
        if head is None:
            # no deadline signal: the pre-QoS behavior (dispatch the
            # partial immediately, padded to the full window)
            return self.B, "flush"
        target = route_batch(n, self._rungs) or self.B
        horizon = self._horizon(target)
        if horizon <= 0.0:
            # cold plane (no device history yet): deferring would wait
            # until the deadline INSTANT and then dispatch with zero
            # margin — flush instead until the model warms
            return self.B, "flush"
        slack = head - time.time()
        if slack > horizon:
            if can_grow:
                return None  # the deadline affords waiting for fill
            return self.B, "flush"
        # deadline pressure: head-of-line deadline minus horizon went
        # non-positive — dispatch the partial at the smallest covering
        # batch-ladder rung, unless the fill floor holds it
        floor_n = min(int(np.ceil(self.fill_floor * self.B)), self.B)
        if n < floor_n and slack > 0 and can_grow:
            # below the fill floor with slack remaining: hold the
            # forced dispatch (bounded — the deadline itself releases
            # it), so trickle traffic cannot collapse throughput into
            # one-frame windows
            if not peek:
                self._floor_deferred.add(sess.sid)
            return None
        why = (
            "fill_floor"
            if sess.sid in self._floor_deferred
            else "deadline_forced"
        )
        if not peek:
            self._floor_deferred.discard(sess.sid)
        return target, why

    def _get_degraded_backend(self):
        """The reduced-budget backend overload dispatches through: the
        consensus-stage knobs shrink (hypothesis budgets, refine/polish
        passes) while every reference-preparation knob stays identical,
        so a session's prepared reference is valid on both backends. A
        backend of the primary's name through the registry, on its
        device and mesh, built the way the corrector builds its
        escalation backend; it launches the same kernels. Built once
        (prewarmed from `start`; the build lock keeps the warm thread
        and the scheduler thread from racing)."""
        with self._degraded_build:
            if self._degraded_backend is None:
                cfg = self.mc.config
                dcfg = cfg.replace(
                    n_hypotheses=max(16, cfg.n_hypotheses // 4),
                    refine_iters=min(cfg.refine_iters, 1),
                    patch_hypotheses=max(8, cfg.patch_hypotheses // 4),
                    field_passes=1,
                    field_polish=min(int(cfg.field_polish), 1),
                    transform_polish=0,
                )
                backend = _twin_backend(self.mc, dcfg)
                # Tag the reduced-budget rung in its plan runtime: its
                # stamps and stats are labelled "degraded" (the config
                # digest already differs; the label makes stats and
                # stamps readable).
                plan = getattr(backend, "_plan", None)
                if plan is not None:
                    plan.rung = "degraded"
                # Publish under the PLANE lock: stats() reads the
                # handle there without ever waiting behind this
                # build; _degraded_build serializes the builds.
                with self._lock:
                    self._degraded_backend = backend
            return self._degraded_backend

    def _warm_degraded(self) -> None:
        try:
            self._get_degraded_backend()
        except Exception as e:
            advise(
                f"kcmc serve: degraded-backend prewarm failed ({e}); "
                "overloaded batches will dispatch at full budgets",
                stacklevel=2,
            )

    def _maybe_warm_degraded_shape(self, sess) -> None:
        """Kick a background compile of the degraded backend's batch
        program for `sess`'s frame shape, once per shape. Called right
        after the session's reference is prepared — the queue cannot
        reach the watermark before at least one reference exists, so
        the warm-up races only the RAMP to overload, not overload
        itself; without it, the first degraded dispatch would pay its
        first-run setup inline on the scheduler thread at peak
        backlog."""
        if self.watermark >= 1.0 or sess.ref_frame is None:
            return
        shape = tuple(sess.frame_shape)
        with self._lock:
            if shape in self._degraded_warm_started:
                return
            self._degraded_warm_started.add(shape)
        ref, ref_frame = sess.ref, sess.ref_frame
        self._spawn_warmup(
            self._warm_degraded_shape,
            "kcmc-serve-degraded-warm-shape",
            args=(shape, ref, ref_frame),
        )

    def _warm_degraded_shape(self, shape, ref, ref_frame) -> None:
        try:
            backend = self._get_degraded_backend()
            # The session's own reference content: realistic keypoints,
            # and a reference prepared by the FULL backend is valid on
            # the degraded one (reference-prep knobs are identical).
            dummy = np.broadcast_to(
                ref_frame, (self.B,) + shape
            ).astype(np.float32)
            # process_batch returns host arrays (to_host): it blocks
            # until the batch ran
            backend.process_batch(dummy, ref, np.arange(self.B))
        except Exception as e:
            advise(
                f"kcmc serve: degraded-program warm-up for frame shape "
                f"{shape} failed ({e}); the first overloaded batch of "
                "that shape compiles inline",
                stacklevel=2,
            )

    def _maybe_warm_partial_rungs(self, sess) -> None:
        """Kick a background compile of the PRIMARY backend's batch
        programs for the partial batch-ladder rungs of `sess`'s frame
        shape, once per (shape, rung). Only latency-class streams
        trigger it — they are the only ones whose deadline-forced
        dispatches pad to partial rungs — and, like the degraded warm,
        it runs right after the reference is prepared so the first
        forced partial never pays its first-run setup inline at peak
        deadline pressure."""
        if sess.qos_class != "latency" or sess.ref_frame is None:
            return
        shape = tuple(sess.frame_shape)
        with self._lock:
            todo = tuple(
                rung
                for rung in self._rungs
                if rung < self.B
                and (shape, rung) not in self._rung_warm_started
            )
            self._rung_warm_started.update((shape, r) for r in todo)
        if not todo:
            return
        ref, ref_frame = sess.ref, sess.ref_frame
        self._spawn_warmup(
            self._warm_partial_rungs,
            "kcmc-serve-rung-warm",
            args=(shape, todo, ref, ref_frame),
        )

    def _warm_partial_rungs(self, shape, rungs, ref, ref_frame) -> None:
        for rung in rungs:
            try:
                backend = self.mc.backend
                dummy = np.broadcast_to(
                    ref_frame, (rung,) + tuple(shape)
                ).astype(np.float32)
                # host outputs: blocks until the batch ran
                backend.process_batch(dummy, ref, np.arange(rung))
            except Exception as e:
                advise(
                    f"kcmc serve: partial-rung warm-up (batch {rung}, "
                    f"frame shape {shape}) failed ({e}); the first "
                    "deadline-forced dispatch at that rung compiles "
                    "inline",
                    stacklevel=2,
                )

    def _maybe_restore_locked(self, sess) -> None:
        # Hysteresis: quality restores once the backlog drains below
        # half the watermark (not the instant it dips under it).
        if sess.degraded and sess.backlog() <= (
            0.5 * self.watermark * self.queue_depth
        ):
            sess.degraded = False

    # -- the scheduler loop --------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._lock:
                if not self._running:
                    break
            try:
                self._loop_once()
            except Exception as e:
                # The scheduler thread is the whole serving plane: an
                # unexpected error must degrade to a warning, never
                # wedge every tenant behind a dead loop. (Session-
                # attributable failures are already routed to fail();
                # this is the backstop for scheduler-side bugs.)
                advise(
                    f"kcmc serve: scheduler error "
                    f"({type(e).__name__}: {e}); continuing",
                    stacklevel=2,
                )
                time.sleep(0.05)
        # Shutdown: drain in-flight work, then finalize complete streams
        # and fail incomplete ones (waiters must not hang).
        while self._window:
            self._drain_one()
        with self._lock:
            leftovers = list(self._sessions.values())
            self._sessions.clear()
            for sess in leftovers:
                self._record_closed_locked(sess)
            self._rebuild_order()
        for sess in leftovers:
            if sess.closed:
                continue
            # Graceful drain (SIGTERM / stop): every still-open stream
            # goes to its journal first — drained state is durable, so
            # a restarted server resumes it from this exact frame. After
            # a lost context the journals stay frozen at their last
            # durable snapshot: a survivor may be writing them now.
            if not self._device_lost:
                sess.maybe_journal(force=True)
            sess.keep_journal = True
            if not sess.drained_out():
                sess.fail(
                    RuntimeError(
                        "serve scheduler stopped mid-stream"
                        + (
                            " (journaled — resume_session on a "
                            "restarted server continues from the last "
                            "durable frame)"
                            if sess.journal is not None
                            else ""
                        )
                    )
                )
            sess.begin_close()
            sess.finalize()

    def _loop_once(self) -> None:
        """One scheduler-loop iteration: dispatch a ready batch, else
        drain, else idle-wait for work."""
        with self._lock:
            self._loop_beat = time.monotonic()
        if self.fault_plan is not None:
            # `scheduler` chaos surface: a stall clause wedges this
            # iteration (the stats/heartbeat wedge gauge must notice);
            # a raising clause exercises the loop's error backstop.
            # One op index per iteration, so step=N clauses target the
            # Nth loop pass deterministically (like every surface).
            step = self.fault_plan.op_index("scheduler")
            stall = self.fault_plan.take_stall("scheduler", step)
            if stall > 0:
                advise(
                    f"kcmc serve: injected scheduler stall of "
                    f"{stall:.2f}s",
                    stacklevel=2,
                )
                time.sleep(stall)
            self.fault_plan.maybe_fail("scheduler", step)
        self._reap_stale()
        self._slo_tick()
        self._prepare_references()
        with self._wake:
            picked = (
                self._pick_locked()
                if self._running and not self._device_lost
                else None
            )
        if picked is not None:
            sess, (n, batch, idx, ref, clock), degraded, why = picked
            backend = self.mc.backend
            if degraded:
                try:
                    backend = self._get_degraded_backend()
                except Exception:
                    pass  # prewarm already advised; full budgets
            entry = self._dispatch(
                sess, backend, n, batch, idx, ref, degraded, clock, why
            )
            if entry is not None:
                with self._lock:
                    # stats()/snapshot() read the window depth under
                    # the plane lock; mutations take it too (drains
                    # still materialize OUTSIDE it)
                    self._window.append(entry)
                while len(self._window) >= self.inflight_depth:
                    self._drain_one()
            self._finalize_ready()
            return
        if self._window:
            self._drain_one()
            self._finalize_ready()
            return
        self._finalize_ready()
        with self._wake:
            if self._running and self._pick_preview_locked() is None:
                self._wake.wait(timeout=0.1)

    def _reap_stale(self) -> None:
        """Journal-and-close sessions whose client has gone quiet past
        `serve_session_timeout_s` (scheduler thread). Only fully
        drained, not-closing sessions are eligible — a reap never
        abandons admitted work. The journal survives (keep_journal), so
        a client that merely slept can `resume_session` later; without
        journaling only fully-FETCHED sessions are reaped (undelivered
        spans would outlive the reap only in the bounded retention —
        an eviction would silently end the returning client's stream),
        and the freed session's final result stays fetchable through
        the recently-closed retention."""
        if self.session_timeout_s <= 0:
            return
        now = time.monotonic()
        stale = []
        with self._lock:
            for s in self._sessions.values():
                if (
                    s.error is None
                    and not s.closing
                    # a thread blocked in fetch()/result() is a LIVE
                    # client whose activity clock went stale mid-wait
                    and s.waiters == 0
                    and now - s.last_activity > self.session_timeout_s
                    and s.drained_out()
                    # no-data-loss gate: without a journal, a reaped
                    # session's undelivered spans survive only in the
                    # bounded retention — an eviction would turn them
                    # into a silent "exhausted" for the returning
                    # client. And a journal never stores corrected
                    # PIXELS, so an emit-frames session's undelivered
                    # spans would not survive a reap+resume either.
                    # Both are reaped only once everything was fetched.
                    and (
                        (s.journal is not None and not s.emit_frames)
                        or s.fully_delivered()
                    )
                ):
                    # Close atomically with the check (begin_close is
                    # reentrant on the plane lock): once closing is
                    # set no new submit can slip in, so the journal
                    # written below is the stream's final state.
                    s.keep_journal = True
                    self._stats["sessions_reaped"] += 1
                    s.begin_close()
                    # capture idle at check time: a client thread
                    # waking into fetch() after we drop the lock
                    # refreshes last_activity and would make the
                    # advisory below log a nonsensical "idle for 0s"
                    stale.append((s, now - s.last_activity))
        for sess, idle_s in stale:
            sess.maybe_journal(force=True)
            if sess.journal is not None and sess.journal.last_saved > 0:
                fate = "journaled and reaped — resume_session restores it"
            elif sess.journal is not None:
                # journaling armed but the stream never drained a frame
                # — there is nothing durable to resume
                fate = "reaped (no frames drained, nothing to journal)"
            else:
                fate = (
                    "reaped (journaling is off; its final result stays "
                    "fetchable through the recently-closed retention)"
                )
            advise(
                f"kcmc serve: session {sess.sid} idle for "
                f"{idle_s:.3g}s (> "
                f"serve_session_timeout_s={self.session_timeout_s:g}); "
                f"{fate}",
                stacklevel=2,
            )
        # finalization happens in _finalize_ready on this same thread

    def _prepare_references(self) -> None:
        """Prepare staged references OUTSIDE the lock (device compute,
        possibly a kernel library's first build — client submits must
        keep flowing on every other session meanwhile). Scheduler
        thread only."""
        with self._lock:
            needing = [
                s
                for s in self._sessions.values()
                if s.error is None and not s.closed and s.needs_reference()
            ]
        for sess in needing:
            try:
                sess.prepare_reference_now()
            except BaseException as e:
                self._fail_fatal(sess, e, None)
            else:
                self._maybe_warm_degraded_shape(sess)
                self._maybe_warm_partial_rungs(sess)

    def _pick_preview_locked(self):
        """Whether ANY session has dispatchable or finalizable work
        (idle-wait predicate; does not consume anything). Mirrors the
        pick's latency-deferral decision exactly — a deferred latency
        session must NOT read as dispatchable, or the loop busy-spins
        instead of idle-waiting (the 0.1s wait bounds the deadline-
        expiry reaction granularity; documented in PERFORMANCE.md)."""
        for sess in self._sessions.values():
            if sess.error is None and not sess.closed and (
                sess.ready_count() or sess.needs_reference()
            ):
                if sess.needs_reference() or sess.qos_class != "latency":
                    return sess
                if self._latency_take_locked(sess, peek=True) is not None:
                    return sess
                continue
            if sess.closing and not sess.closed and sess.drained_out():
                return sess
        return None

    def _ready_batch_sessions_locked(self):
        """Batch-class sessions with dispatchable frames (lock held) —
        the preemption fast path's skip set and starvation ledger."""
        return [
            s
            for s in self._sessions.values()
            if s.qos_class != "latency" and s.error is None
            and not s.closed and s.ready_count() > 0
        ]

    def _pick_locked(self):
        """The dispatch pick. Latency-class sessions with deadline
        pressure (or a full window) jump the weighted round-robin —
        earliest head-of-line deadline first — with starvation bounded
        by an aging credit counter: every batch-class session a
        preemption skips gains credit, and one at
        `serve_latency_starvation_limit` takes the slot unconditionally
        before the next jump. Everything else is the weighted
        round-robin. Returns (session, padded batch, degraded flag,
        why) or None; `why` is the dispatch-decision vocabulary
        (obs/registry.py DISPATCH_WHY_COUNTERS)."""
        order = self._order
        if not order:
            return None
        lat_ready = sorted(
            (
                s
                for s in self._sessions.values()
                if s.qos_class == "latency" and s.error is None
                and not s.closed and s.ready_count() > 0
            ),
            key=lambda s: (
                d if (d := s.head_deadline()) is not None else float("inf")
            ),
        )
        for sess in lat_ready:
            take = self._latency_take_locked(sess)
            if take is None:
                continue  # deferred: slack buys fill time
            target, why = take
            skipped = self._ready_batch_sessions_locked()
            if skipped:
                # bounded starvation: a batch session jumped past its
                # aging limit gets this slot instead of the preemption
                starved = next(
                    (
                        s for s in skipped
                        if self._starve_credit.get(s.sid, 0)
                        >= self.starvation_limit
                    ),
                    None,
                )
                if starved is not None:
                    try:
                        taken = starved.take_batch(self.B)
                    except Exception as e:
                        starved.fail(e)
                        taken = None
                    if taken is not None:
                        self._starve_credit[starved.sid] = 0
                        self._stats["starvation_grants"] += 1
                        why_b = (
                            "full_window"
                            if taken[0] >= self.B
                            else "flush"
                        )
                        return starved, taken, starved.degraded, why_b
            try:
                taken = sess.take_batch(self.B, target=target)
            except Exception as e:
                # Batch-forming failure is that ONE stream's problem
                # (fail drops its pending frames, so this cannot
                # respin) — the plane keeps serving.
                sess.fail(e)
                continue
            if taken is None:
                continue
            if skipped:
                self._stats["preemptions"] += 1
                sess.preempted_dispatches += 1
                for s in skipped:
                    self._starve_credit[s.sid] = (
                        self._starve_credit.get(s.sid, 0) + 1
                    )
                if why in ("full_window", "flush"):
                    # deadline_forced / fill_floor outrank preempted in
                    # the why vocabulary — they explain the TIMING, the
                    # jump is visible in the preemption counters either
                    # way
                    why = "preempted"
            self._floor_deferred.discard(sess.sid)
            return sess, taken, sess.degraded, why
        for i in range(len(order)):
            sid = order[(self._rr + i) % len(order)]
            sess = self._sessions.get(sid)
            if sess is None or sess.closed or sess.error is not None:
                continue
            if sess.qos_class == "latency":
                continue  # taken (or deliberately deferred) above
            if sess.ready_count() > 0:
                try:
                    taken = sess.take_batch(self.B)
                except Exception as e:
                    sess.fail(e)
                    continue
                if taken is not None:
                    self._rr = (self._rr + i + 1) % len(order)
                    # a served batch session starts its aging over
                    self._starve_credit.pop(sid, None)
                    why = (
                        "full_window" if taken[0] >= self.B else "flush"
                    )
                    return sess, taken, sess.degraded, why
        return None

    def _finalize_ready(self) -> None:
        """Finalize sessions whose streams fully drained after
        begin_close, OUTSIDE the scheduler lock (writer close blocks),
        then drop closed sessions from the schedule."""
        with self._lock:
            ready = [
                s for s in self._sessions.values()
                if s.closing and not s.closed and s.drained_out()
            ]
        for s in ready:
            s.finalize()
        with self._lock:
            done = [(sid, s) for sid, s in self._sessions.items() if s.closed]
            for sid, s in done:
                del self._sessions[sid]
                self._record_closed_locked(s)
            if done:
                self._rebuild_order()

    def _dispatch(
        self, sess, backend, n, batch, idx, ref, degraded, clock=None,
        why="full_window",
    ):
        """Dispatch one session batch; on a dispatch-time error, flush
        the window first (ordering + the ladder's synthesis template),
        then walk the session's degradation ladder. Returns a window
        entry, or None when the error path already accounted the
        batch. `clock` is the batch's RequestClock (take_batch) — the
        dispatch segment closes here, device/drain close at drain.
        `why` is the pick's dispatch-decision reason: counted in
        `stats`, mirrored as a registry-checked SpanShard counter when
        tracing is armed, and ridden on the request.dispatch span."""
        # the torch backend takes native-dtype batches (uint16 uploads at
        # half the bytes and widens on the card); a backend without the
        # asynchronous seam runs each batch in a plain process_batch
        # (scheduler.py:1833-1837)
        if not getattr(backend, "accepts_native_dtype", False) and batch.dtype != np.float32:
            batch = batch.astype(np.float32)
        dispatch = getattr(backend, "process_batch_async", None)
        with self._lock:
            # scheduler-thread QoS counters share the plane lock with
            # the stats()/snapshot() readers
            self._stats["batches"] += 1
            self._stats["occupied_frames"] += int(n)
            if degraded:
                self._stats["degraded_batches"] += 1
            self._stats["dispatch_why"]["dispatch.why." + why] += 1
        if self.trace_shard is not None:
            # the same literal vocabulary the _stats seed registers
            # (obs/registry.py DISPATCH_WHY_COUNTERS) — one counter
            # instant per dispatch decision on the span shard
            self.trace_shard.counter("dispatch.why." + why, time.time())
        pixels = sess.wants_pixels()
        kept = batch if pixels else None
        # registration-only sessions start no corrected download
        kw = {"emit_frames": pixels}
        warm = (sess.mc.config.warm_start and sess.mc.config.model != "piecewise"
                and dispatch is not None)
        if warm and sess.warm_seed is not None:
            # Temporal warm start, per SESSION: each stream's own last
            # transform seeds its next batch's consensus (streams are
            # independent temporal histories — never share seeds).
            kw["seed"] = (sess.warm_seed, True)
        # Chaos surface: the serve dispatch is the same `device` fault
        # surface the one-shot `_dispatch_batches` arms, on the
        # SESSION's own plan (per-stream deterministic step counters).
        plan = sess.mc._fault_plan
        step = plan.op_index("device") if plan is not None else None
        try:
            if plan is not None:
                plan.maybe_fail("device", step)
            if dispatch is not None:
                out = dispatch(batch, ref, idx, **kw)
            else:
                out = backend.process_batch(batch, ref, idx)
        except Exception as e:
            from kcmc_tpu_torch.utils import faults

            if not faults.classify_device_transient(
                e, getattr(backend, "transient_error_types", ())
            ):
                # probe before the window drains, so that a lost context
                # is laid to this stream's batch, the one that raised
                self._probe_context(sess, e, backend)
            while self._window:
                self._drain_one()
            self._ladder(
                sess, e, backend, batch, ref, idx, n, kept, step, clock
            )
            return None
        if clock is not None and sess.lat is not None:
            clock.rung = "degraded" if degraded else (
                "latency" if sess.qos_class == "latency" else "full"
            )
            clock.t_dispatched = time.perf_counter()
            sess.lat.observe(
                "request.dispatch", clock.t_dispatched - clock.t_formed,
                n=n, rung=clock.rung,
            )
            if clock.trace is not None:
                sess.trace_obs(
                    "request.dispatch",
                    clock.t_dispatched - clock.t_formed,
                    n, clock.rung, clock.trace,
                    args={"why": why},
                )
        if warm and "transform" in out:
            sess.warm_seed = out["transform"][n - 1]
        return (sess, n, out, kept, batch, idx, ref, backend, clock)

    def _drain_one(self) -> None:
        """Drain the oldest in-flight entry: materialize to host through
        the backend's `to_host` where it has one (`TorchBackend.to_host`
        waits on the downloads' event, where a deferred device error
        surfaces — it walks the ladder — and copies the arrays out of
        the pooled pinned buffers before they go back to the pool), then
        hand the batch to its session."""
        with self._lock:
            if not self._window:
                return
            if self._device_lost:
                # nothing downloads from a lost context: drop the window
                # (its streams were failed or released)
                dropped = list(self._window)
                self._window.clear()
            else:
                dropped = None
                sess, n, out, kept, batch, idx, ref, backend, clock = (
                    self._window.popleft()
                )
        if dropped is not None:
            for entry in dropped:
                entry[0].entry_done()
            return
        try:
            # Registration-only sessions (no emit, no server-side file,
            # no rolling template) never touch pixels: their batches
            # dispatched with emit_frames=False, so `corrected` stays on
            # the card and never downloads — the same drop the one-shot
            # registration-only path makes.
            to_host = getattr(backend, "to_host", None)
            host = {
                k: np.asarray(v)[:n]
                for k, v in (to_host(out) if to_host is not None else out).items()
                if sess.wants_pixels() or k != "corrected"
            }
            sess.mc._note_out_template(host)
        except Exception as e:
            self._ladder(sess, e, backend, batch, ref, idx, n, kept,
                         clock=clock)
            return
        if clock is not None:
            # device-execution segment ends when host arrays exist
            clock.t_host = time.perf_counter()
        if backend is self.mc.backend:
            with self._lock:
                # a clean primary drain resets the supervisor's strikes
                self._strikes = 0
        self._account_done(sess, n, host, kept, ref, clock)

    def _ladder(
        self, sess, exc, backend, batch, ref, idx, n, kept, step=None,
        clock=None,
    ) -> None:
        """Walk the session's degradation ladder for a failed batch
        and feed the backend supervisor. Transient errors walk the
        ladder (retry with backoff -> failover backend -> mark-failed)
        and count a strike against the primary (quarantine and rebuild
        at the strike limit). A FATAL error — a kernel that does not
        build or launch, any other fault of the program — raises from
        the ladder as in a one-shot run and fails this session's stream
        (its error reaches `close_session`); it strikes nothing and
        never reruns the batch on the CPU."""
        from kcmc_tpu_torch.utils import faults

        with self._lock:
            # The degraded QoS twin shares the physical device, so its
            # failures feed the same supervisor — a wedge under overload
            # is still a wedge. A RETIRED backend (an entry in flight
            # when a rebuild swapped it out) must not strike the fresh
            # primary.
            supervised = backend is not None and (
                backend is self.mc.backend or backend is self._degraded_backend
            )
        # the batch program does no I/O: the device surface's own
        # classification, as the one-shot ladder's
        transient = faults.classify_device_transient(
            exc, getattr(backend, "transient_error_types", ())
        )
        if supervised and transient and batch is not None:
            self._note_strike(exc)
        try:
            out, failed = sess.mc._ladder_batch(
                exc, backend, batch, ref, idx, None, step, n, True
            )
        except BaseException as e:
            # The entry MUST be accounted on every path, or the
            # in-flight count leaks and the stream's close waits forever.
            self._fail_fatal(sess, e, backend)
            sess.entry_done()
            return
        # the ladder's outputs are host arrays already
        host = {
            k: np.asarray(v)[:n]
            for k, v in out.items()
            if sess.wants_pixels() or k != "corrected"
        }
        kept = sess.mc._failed_kept(host, kept, failed)
        if clock is not None:
            # laddered batches close their device segment here — the
            # retry/failover walk is honest device-side time
            clock.t_host = time.perf_counter()
        self._account_done(sess, n, host, kept, ref, clock)

    # -- backend supervision (quarantine + off-path rebuild) ----------------

    def _fail_fatal(self, sess, exc, backend) -> None:
        """A fatal error ended a batch of `sess`: the stream fails, is
        listed for `stats()`, and the card is probed once. Once the
        context is lost, only the stream it was laid to fails; any other
        is released (`_probe_context`)."""
        with self._lock:
            lost, culprit = self._device_lost, self._lost_by
        if lost and sess.sid != culprit:
            sess.fail(self._lost_error())  # keeps an earlier error
            return
        sess.fail(exc)
        with self._lock:
            if sess.sid not in self._failed_sids:
                self._failed_sids.append(sess.sid)
        if not lost:
            self._probe_context(sess, exc, backend)

    def _lost_error(self) -> DeviceLostError:
        return DeviceLostError(
            "the CUDA context of this server is lost; the stream is "
            "released: resume_session on another server continues it "
            "from its journal"
        )

    def _probe_context(self, sess, exc, backend) -> None:
        """Probe the card once after a fatal error of `sess`'s batch. A
        context that no longer synchronizes is lost for the whole
        process, never recovered here: dispatch stops, `sess` is the
        stream it is laid to, and every other open stream is released
        with a `DeviceLostError` so that it migrates."""
        with self._lock:
            if self._device_lost:
                return
        device = getattr(backend or self.mc.backend, "device", "cpu")
        if not device_context_lost(device):
            return
        with self._wake:
            if self._device_lost:
                return
            self._device_lost = True
            self._lost_by = sess.sid
            others = [
                s for s in self._sessions.values()
                if s is not sess and s.error is None and not s.closed
            ]
            self._wake.notify_all()
        err = self._lost_error()
        for s in others:
            s.fail(err)
        advise(
            "kcmc serve: the CUDA context is lost after a fatal "
            f"dispatch error of session {sess.sid} "
            f"({type(exc).__name__}: {exc}); dispatch stopped, "
            f"{len(others)} other stream(s) released to resume "
            "elsewhere — restart this server",
            stacklevel=2,
        )

    # Minimum spacing between rebuild attempts: inside it a strike-out
    # skips the quarantine (batches still walk the ladder) so a fault
    # that keeps recurring cannot thrash the plane with endless
    # rebuild + re-prewarm cycles.
    REBUILD_COOLDOWN_S = 30.0

    def _note_strike(self, exc) -> None:
        """Count one transient batch failure on the supervised device
        (primary or its degraded QoS twin); at the strike limit
        quarantine the backend and kick the background rebuild."""
        if self._strike_limit <= 0:
            return
        start = False
        with self._lock:
            self._strikes += 1
            if (
                self._strikes >= self._strike_limit
                and not self._rebuilding
                and time.monotonic() - self._last_rebuild
                > self.REBUILD_COOLDOWN_S
            ):
                self._rebuilding = True
                self._stats["backend_rebuilds"] += 1
                start = True
        if start:
            advise(
                "kcmc serve: primary backend quarantined after "
                "repeated transient dispatch errors "
                f"({type(exc).__name__}: {exc}); rebuilding it off the "
                "request path — batches walk the ladder meanwhile, no "
                "session is dropped",
                stacklevel=2,
            )
            self._spawn_warmup(
                self._rebuild_backend, "kcmc-serve-backend-rebuild"
            )

    def _rebuild_backend(self) -> None:
        """Quarantine recovery (non-daemon warm-up thread, joined on
        stop): construct a FRESH primary backend of the same name on the
        same device and mesh — its kernel libraries load from the build
        directory or the persistent cache, nothing recompiles —
        pre-warm each live session's frame shape on it, then swap it in
        under the plane lock. Sessions re-stage their references so the
        scheduler re-prepares them on the new backend; in-flight
        entries dispatched on the quarantined backend re-dispatch
        through the ladder when their drain surfaces the error.

        Only transient strikes lead here, and a rebuild recovers from
        failures that leave the CUDA context usable. A sticky CUDA error
        — an illegal address, a kernel trap — is fatal: it fails its
        stream, and it poisons the context of the whole process, so the
        streams after it fail as well until a restarted process
        (resuming its journals) brings the card back."""
        try:
            # forward the mesh like the corrector's escalation backend
            # — a rebuild must not silently unshard the plane
            new = _twin_backend(self.mc, self.mc.config)
            with self._lock:
                shapes = {
                    tuple(s.frame_shape): s.ref_frame
                    for s in self._sessions.values()
                    if s.frame_shape is not None and s.ref_frame is not None
                }
            for shape, ref_frame in shapes.items():
                try:
                    ref = new.prepare_reference(
                        np.asarray(ref_frame, np.float32)
                    )
                    dummy = np.broadcast_to(
                        ref_frame, (self.B,) + shape
                    ).astype(np.float32)
                    # host outputs: blocks until the batch ran
                    new.process_batch(dummy, ref, np.arange(self.B))
                except Exception:
                    pass  # that shape compiles inline at first dispatch
        except Exception as e:
            advise(
                f"kcmc serve: backend rebuild failed "
                f"({type(e).__name__}: {e}); keeping the quarantined "
                "backend — batches keep walking the ladder",
                stacklevel=2,
            )
            with self._lock:
                self._rebuilding = False
                self._last_rebuild = time.monotonic()
            return
        with self._wake:
            self.mc.backend = new
            # The degraded QoS twin was built against the quarantined
            # device context — invalidate it so overload traffic lazily
            # rebuilds it on the fresh one instead of failing streams.
            self._degraded_backend = None
            self._degraded_warm_started.clear()
            for s in self._sessions.values():
                s.adopt_backend(new)
            self._strikes = 0
            self._rebuilding = False
            self._last_rebuild = time.monotonic()
            self._wake.notify_all()
        advise(
            "kcmc serve: rebuilt primary backend swapped in; sessions "
            "re-prepare their references on it and dispatch resumes",
            stacklevel=2,
        )

    def _account_done(self, sess, n, host, kept, ref, clock=None) -> None:
        try:
            sess.on_drained(n, host, kept, ref, clock=clock)
        except BaseException as e:
            sess.fail(e)
        finally:
            sess.entry_done()
        with self._lock:
            self._stats["frames_done"] += int(n)
            self._maybe_restore_locked(sess)


def _twin_backend(mc, config):
    """A backend of `config` under the corrector's backend name, through
    the registry, on the primary's device and mesh (the degraded rung, a
    rebuilt primary; scheduler.py:1325-1336, :2094-2102), built as the
    corrector builds its escalation backend."""
    from kcmc_tpu_torch.corrector import twin_options

    return get_backend(mc.backend_name, config, **twin_options(mc.backend))
