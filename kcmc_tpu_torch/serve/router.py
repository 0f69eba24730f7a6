"""FleetRouter: the `python -m kcmc_tpu_torch router` front door over N
serve replicas (the port's copy of kcmc_tpu/serve/router.py).

Speaks the line-delimited JSON protocol (serve/proto.py) to clients — a
`ServeClient` of either package pointed at a router is none the wiser —
and fans out to a fleet of `serve` replicas, of the port or of the
reference (docs/SERVING.md "Running a fleet", docs/ROBUSTNESS.md
"Fleet failures"):

* **Placement**: sessions land on replicas by rendezvous hashing over
  the HEALTHY set (serve/fleet.py) — the same key always picks the
  same replica under a stable ring, and a join/leave moves only the
  minimal key share.
* **Health**: a prober thread scrapes every replica's `metrics`/
  `stats` verbs each `fleet_probe_interval_s`, with the whole scrape
  hard-capped at the probe budget (the `timeout=` of
  `ServeClient.metrics`). Missed scrapes and the scheduler-wedge gauge
  are HARD evidence, a supervisor rebuild in progress is SOFT;
  both feed the HEALTHY -> SUSPECT -> DEAD machine with hysteresis. A
  lost CUDA context (`device_lost` in the replica's supervisor block)
  kills the replica at once, as an exited process does.
* **Migration**: when a replica dies (or is drained), its sessions
  `resume_session` on survivors over the SHARED journal directory,
  and the router replays its per-session tail buffer (frames newer
  than the last durable journal snapshot) so the end client sees only
  a bounded retry — never a lost or duplicated frame. Each migration
  records a `fleet.migrate` duration span (obs/registry.py). A stream
  that a fatal dispatch error failed on its replica (listed in the
  replica's `failed_sessions`) is never migrated: it fails to its
  client as it would on a single server, so one poisoning input
  cannot walk through the fleet.
* **Admission**: a fleet-wide queue-depth watermark over the
  per-replica degradation ladder — new sessions are rejected
  429-style with a predicted-wait hint from the fleet-merged latency
  histograms once global backlog passes `fleet_queue_watermark`.
* **Chaos**: every router->replica call is a `fleet` fault surface
  (utils/faults.py): a raising clause blackholes the call (forward,
  scrape, or migration resume), a ``stall=`` clause stalls a scrape
  past its budget.

Threading: handler threads (one per client connection) forward ops
through a per-thread upstream-client pool; ONE prober thread owns
health state transitions and proactive migration; the router lock
guards only in-memory maps (bindings, buffers, scrape snapshots) and
is never held across a network call. The router is host code: it
runs no kernel and never touches a card.
"""

from __future__ import annotations

import json
import socketserver
import threading
import time
import uuid

import numpy as np

from kcmc_tpu_torch.obs.latency import SegmentLatencies
from kcmc_tpu_torch.obs.log import advise
from kcmc_tpu_torch.serve import proto
from kcmc_tpu_torch.serve.client import ServeClient, ServeError
from kcmc_tpu_torch.serve.fleet import (
    DEAD,
    DRAINING,
    HEALTHY,
    SUSPECT,
    Replica,
    merge_fleet_metrics,
    place,
    predicted_wait_s,
    rank,
    stop_replica,
)
from kcmc_tpu_torch.utils.faults import FaultError

# Tail-buffer cap per session, in frames, for fleets WITHOUT a shared
# journal directory (with journaling, buffers prune to the journal
# cursor and stay small). Past the cap the oldest frames drop and a
# migration needing them fails loudly instead of silently gapping.
BUFFER_CAP_FRAMES = 4096

# Bounded candidate list per migration attempt: how many survivors
# (in rendezvous order) a migration tries before giving up.
MIGRATE_CANDIDATES = 3


def _enc_nframes(enc: dict) -> int:
    """Frame count of an encoded frames payload (2D = one frame)."""
    shape = enc.get("shape") or ()
    return int(shape[0]) if len(shape) >= 3 else 1


def _enc_slice(enc: dict, lo: int) -> dict:
    """Drop the first `lo` frames of an encoded frames payload."""
    arr = proto.decode_array(enc)
    if arr.ndim == 2:
        arr = arr[None]
    return proto.encode_array(arr[lo:])


class _UpstreamPool:
    """Cache of ServeClients keyed by replica id. Each thread (handler
    / prober / autoscaler) builds its own pool — the lock is for the
    cache map only (uncontended in practice) and is never held across
    the network I/O of building a connection. `close()` runs in the
    owning thread's finally block — the leak checker sees every
    upstream socket closed."""

    def __init__(self, connect_timeout: float = 5.0):
        self._connect_timeout = connect_timeout
        self._clients: dict[str, ServeClient] = {}
        self._lock = threading.Lock()

    def get(self, replica: Replica) -> ServeClient:
        with self._lock:
            c = self._clients.get(replica.rid)
        if c is None:
            try:
                c = ServeClient(
                    host=replica.host,
                    port=replica.port,
                    connect_timeout=self._connect_timeout,
                    io_timeout=replica.ready.get("io_timeout_s") or None,
                    reconnect_attempts=2,
                    reconnect_backoff_s=0.1,
                )
            except OSError as e:
                raise ServeError(
                    f"replica {replica.rid} unreachable "
                    f"({type(e).__name__}: {e})",
                    code=503,
                )
            with self._lock:
                self._clients[replica.rid] = c
        return c

    def drop(self, rid: str) -> None:
        with self._lock:
            c = self._clients.pop(rid, None)
        if c is not None:
            c.close()

    def close(self) -> None:
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.close()


class _RouterHandler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        router: "FleetRouter" = self.server.kcmc_router  # type: ignore[attr-defined]
        pool = _UpstreamPool()
        try:
            while True:
                try:
                    msg = proto.recv_msg(self.rfile)
                except (ValueError, OSError) as e:
                    try:
                        proto.send_msg(
                            self.wfile,
                            {
                                "ok": False,
                                "error": f"bad message: {e}",
                                "code": 400,
                            },
                        )
                    except OSError:
                        pass
                    return
                if msg is None:
                    return  # client closed the connection
                try:
                    resp = router.handle_op(msg, pool)
                except ServeError as e:
                    resp = {
                        "ok": False,
                        "error": str(e),
                        "code": e.code,
                        **{
                            k: v
                            for k, v in e.info.items()
                            if isinstance(v, (int, float, str, bool))
                        },
                    }
                except (KeyError, ValueError, TypeError, TimeoutError) as e:
                    resp = {"ok": False, "error": str(e), "code": 400}
                except Exception as e:  # one stream must not kill the router
                    resp = {
                        "ok": False,
                        "error": f"{type(e).__name__}: {e}",
                        "code": 500,
                    }
                try:
                    proto.send_msg(self.wfile, resp)
                except OSError:
                    return
                if msg.get("op") == "shutdown":
                    router.request_shutdown()
                    return
        finally:
            pool.close()


class _RouterTCP(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class FleetRouter:
    """The fleet front door (see module docstring). Construct with the
    initial replica set, `start()`, speak the serve protocol at
    `host:port`; `add_replica`/`drain_replica` reshape the fleet live
    (the autoscaler's two verbs)."""

    def __init__(
        self,
        replicas,
        host: str = "127.0.0.1",
        port: int = 7744,
        config=None,
        fault_plan=None,
        journal_dir: str | None = None,
    ):
        if config is None:
            from kcmc_tpu_torch.config import CorrectorConfig

            config = CorrectorConfig()
        self.config = config
        self.fault_plan = fault_plan
        self._replicas: dict[str, Replica] = {
            r.rid: r for r in (replicas or [])
        }
        # session -> replica-id binding, the open_session request
        # fields (the no-journal-yet migration fallback), the
        # idempotent tail buffer (sorted (first, n, encoded) triples),
        # and the delivery cursor for post-migration span dedup.
        self._bind: dict[str, str] = {}
        self._open_fields: dict[str, dict] = {}
        self._buffers: dict[str, list[tuple[int, int, dict]]] = {}
        self._delivered: dict[str, int] = {}
        # The fleet's SHARED journal directory (the migration
        # substrate). None = discover per replica from its ready
        # record / scraped stats.
        self._journal_dir = journal_dir
        # Results spans synthesized from the journal during a
        # migration: a rehydrated replica marks journaled spans
        # delivered, so frames the END CLIENT had not fetched yet
        # would otherwise vanish from the incremental stream. The
        # router rebuilds them from the journal's own per-batch
        # outputs and serves them before forwarding results again.
        self._pending_spans: dict[str, list[dict]] = {}
        self._migrate_locks: dict[str, threading.Lock] = {}
        # Streams a fatal dispatch error failed on their replica (its
        # scraped `failed_sessions`): session -> the replica id. They
        # are never migrated — the error reaches the client instead.
        self._failed: dict[str, str] = {}
        self._counters = {
            "sessions_routed": 0,
            "sessions_rejected": 0,
            "migrations_total": 0,
            "migration_failures": 0,
            "migration_reopens": 0,
            "replicas_spawned": 0,
            "replicas_drained": 0,
            "probes": 0,
            "probe_failures": 0,
        }
        self._migrations: list[dict] = []  # recent migration records
        self._lock = threading.Lock()
        self._lat = SegmentLatencies()  # fleet.migrate spans
        # Distributed tracing (obs/tracing.py; docs/OBSERVABILITY.md
        # "Distributed tracing"): the router's own span shard holds
        # its `rpc.router` forward spans and `fleet.migrate` link
        # spans; `_session_trace` remembers the last traced context
        # seen per session so a migrated session's replayed frames —
        # and the migration link span itself — continue the SAME
        # trace on the survivor replica.
        self._trace_shard = None
        if getattr(config, "trace_shard_dir", ""):
            import os

            from kcmc_tpu_torch.obs.tracing import SpanShard

            self._trace_shard = SpanShard(
                os.path.join(
                    config.trace_shard_dir,
                    f"spans-router-{os.getpid()}-"
                    f"{uuid.uuid4().hex[:8]}.jsonl",
                ),
                cap=int(getattr(config, "trace_shard_cap", 4096)),
            )
        self._session_trace: dict[str, dict] = {}
        # Fleet-level SLO burn-rate engine (obs/slo.py) over the
        # exact-merged fleet histograms; gauges ride fleet_metrics(),
        # alert TRANSITIONS land once in the router's advise log.
        self._slo = None
        self._slo_alerted: set[str] = set()
        if getattr(config, "slo_objectives", ""):
            from kcmc_tpu_torch.obs.slo import SLOEngine

            self._slo = SLOEngine(config.slo_objectives)
        self._tcp = _RouterTCP((host, port), _RouterHandler)
        self._tcp.kcmc_router = self  # type: ignore[attr-defined]
        self._tcp_thread: threading.Thread | None = None
        self._probe_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._shutdown = threading.Event()

    # -- addresses ---------------------------------------------------------

    @property
    def host(self) -> str:
        return self._tcp.server_address[0]

    @property
    def port(self) -> int:
        return self._tcp.server_address[1]

    # -- fault surface -----------------------------------------------------

    def _inject(self) -> None:
        """One `fleet`-surface attempt: a raising clause blackholes
        whatever upstream call follows."""
        plan = self.fault_plan
        if plan is not None:
            plan.maybe_fail("fleet", plan.op_index("fleet"))

    # -- replica set -------------------------------------------------------

    def add_replica(self, replica: Replica) -> None:
        with self._lock:
            self._replicas[replica.rid] = replica
            self._counters["replicas_spawned"] += replica.proc is not None
        advise(
            f"kcmc router: replica {replica.rid} joined the fleet",
            stacklevel=2,
        )

    def replica_states(self) -> dict[str, str]:
        with self._lock:
            return {rid: r.state for rid, r in self._replicas.items()}

    def _snapshot(self) -> list[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def _placeable_rids(self) -> list[str]:
        with self._lock:
            return [r.rid for r in self._replicas.values() if r.placeable]

    def fleet_load(self) -> dict:
        """Aggregate backlog vs capacity (the admission + autoscaler
        input), from the last scrape snapshots."""
        with self._lock:
            live = [
                r
                for r in self._replicas.values()
                if r.state in (HEALTHY, SUSPECT)
            ]
            queued = sum(
                (r.last_metrics or {}).get("gauges", {}).get(
                    "queued_frames", 0
                )
                for r in live
            )
            capacity = sum(
                r.queue_depth() for r in live if r.state == HEALTHY
            )
            n_owned = sum(
                1
                for r in self._replicas.values()
                if r.proc is not None and r.state != DEAD
            )
        merged = self.fleet_metrics()
        tot = (merged.get("plane") or {}).get("totals") or {}
        p99 = (tot.get("request.total") or {}).get("p99_s")
        return {
            "queued_frames": int(queued),
            "capacity": int(capacity),
            "n_live": len(live),
            "n_owned": n_owned,
            "e2e_p99_s": p99,
        }

    # -- health probing ----------------------------------------------------

    def _probe_one(self, replica: Replica, pool: _UpstreamPool) -> None:
        budget = float(self.config.fleet_probe_interval_s)
        plan = self.fault_plan
        ok, hard = True, True
        metrics = stats = None
        if replica.process_exited():
            replica.health.kill()
            return
        stalled = 0.0
        if plan is not None:
            step = plan.op_index("fleet")
            stalled = plan.take_stall("fleet", step)
        if stalled > 0.0:
            # injected scrape stall: burn (a bounded slice of) the
            # budget, then count the scrape as missed — exactly what a
            # wedged replica transport looks like from the prober.
            time.sleep(min(stalled, budget))
            ok, hard = False, True
        else:
            try:
                self._inject()
                client = pool.get(replica)
                metrics = client.metrics(timeout=budget)
                stats = client.stats(timeout=budget)
            except (ServeError, FaultError, OSError) as e:
                ok, hard = False, True
                pool.drop(replica.rid)
                with self._lock:
                    self._counters["probe_failures"] += 1
                advise(
                    f"kcmc router: scrape of {replica.rid} failed "
                    f"({type(e).__name__}: {e})",
                    stacklevel=2,
                )
        if ok and stats is not None:
            sup = stats.get("supervisor") or {}
            self._note_failed(replica.rid, sup.get("failed_sessions"))
            wedge = float(sup.get("loop_beat_age_s", 0.0))
            if sup.get("device_lost"):
                # a sticky CUDA error poisoned the replica's context: it
                # dispatches nothing again — as definitive as an exited
                # process, so its released streams migrate now
                prev = replica.state
                if replica.health.kill() != prev:
                    advise(
                        f"kcmc router: replica {replica.rid} {prev} -> "
                        f"{DEAD} (CUDA context lost)",
                        stacklevel=2,
                    )
                return
            if wedge > float(self.config.fleet_wedge_threshold_s):
                # transport answered but the scheduler loop is wedged:
                # the replica cannot serve — hard evidence.
                ok, hard = False, True
            elif sup.get("backend_rebuilding") or sup.get(
                "backend_strikes", 0
            ):
                # supervisor strikes / rebuild in progress: suspend
                # placement (soft) while the replica heals itself.
                ok, hard = False, False
        prev = replica.state
        state = replica.health.observe(ok, hard=hard)
        if ok:
            with self._lock:
                replica.last_metrics = metrics
                replica.last_stats = stats
            self._prune_buffers(stats)
        if state != prev:
            advise(
                f"kcmc router: replica {replica.rid} {prev} -> {state}",
                stacklevel=2,
            )

    def _note_failed(self, rid: str, sids) -> None:
        """Record the streams a replica reports failed by a fatal
        dispatch error, so no migration ever resumes them elsewhere."""
        if not sids:
            return
        with self._lock:
            for sid in sids:
                if self._bind.get(sid) == rid:
                    self._failed.setdefault(sid, rid)

    def _refuse_failed(self, sid: str) -> None:
        """Raise the stream's failure instead of migrating it."""
        with self._lock:
            rid = self._failed.get(sid)
        if rid is not None:
            raise ServeError(
                f"session {sid!r} failed on replica {rid} (a fatal "
                "dispatch error); a failed stream is not migrated",
                code=500,
            )

    def _prune_buffers(self, stats: dict) -> None:
        """Drop tail-buffer frames at or below each session's durable
        journal cursor — after a hard kill the journal has them, so
        the router no longer needs to."""
        journal = (stats or {}).get("journal") or {}
        if not journal:
            return
        with self._lock:
            for sid, j in journal.items():
                saved = int(j.get("last_saved", -1))
                buf = self._buffers.get(sid)
                if saved <= 0 or not buf:
                    continue
                self._buffers[sid] = [
                    e for e in buf if e[0] + e[1] > saved
                ]

    def _probe_pass(self, pool: _UpstreamPool) -> None:
        for replica in self._snapshot():
            if replica.state == DEAD:
                continue
            with self._lock:
                self._counters["probes"] += 1
            self._probe_one(replica, pool)
        # Proactive migration: every session still bound to a DEAD
        # replica moves now, not at its client's next op — the client
        # may be blocked in a long results poll.
        with self._lock:
            stranded = [
                (sid, rid)
                for sid, rid in self._bind.items()
                if self._replicas.get(rid) is not None
                and self._replicas[rid].state == DEAD
                and sid not in self._failed
            ]
        for sid, rid in stranded:
            try:
                self._migrate_session(sid, rid, pool)
            except ServeError as e:
                advise(
                    f"kcmc router: migration of {sid} off dead "
                    f"{rid} failed, will retry ({e})",
                    stacklevel=2,
                )

    def _probe_loop(self) -> None:
        pool = _UpstreamPool()
        try:
            while not self._stop.wait(
                float(self.config.fleet_probe_interval_s)
            ):
                try:
                    self._probe_pass(pool)
                except Exception as e:  # the prober must never die
                    advise(
                        f"kcmc router: probe pass failed "
                        f"({type(e).__name__}: {e})",
                        stacklevel=2,
                    )
        finally:
            pool.close()

    # -- migration ---------------------------------------------------------

    def _session_lock(self, sid: str) -> threading.Lock:
        with self._lock:
            lock = self._migrate_locks.get(sid)
            if lock is None:
                lock = self._migrate_locks[sid] = threading.Lock()
            return lock

    def _migrate_session(
        self, sid: str, from_rid: str, pool: _UpstreamPool
    ) -> str:
        """Move one session off `from_rid`: resume from its journal on
        the best survivor (rendezvous order), replay the buffered tail
        past the journal cursor, rebind. Single-flight per session;
        raises ServeError(503) when no survivor can take it, and
        ServeError(500) for a stream that failed on its replica."""
        self._refuse_failed(sid)
        with self._session_lock(sid):
            with self._lock:
                cur = self._bind.get(sid)
                if cur is None:
                    raise ServeError(
                        f"unknown session {sid!r}", code=400
                    )
                if cur != from_rid:
                    r = self._replicas.get(cur)
                    if r is not None and r.state != DEAD:
                        return cur  # a racing caller already moved it
                    from_rid = cur
                candidates = [
                    r.rid
                    for r in self._replicas.values()
                    if r.state == HEALTHY and r.rid != from_rid
                ]
                if not candidates:
                    # a degraded fleet beats a dead stream: fall back
                    # to SUSPECT survivors, then to the source itself
                    # (it may have merely restarted).
                    candidates = [
                        r.rid
                        for r in self._replicas.values()
                        if r.state in (SUSPECT, DRAINING)
                        and r.rid != from_rid
                    ] or [from_rid]
            t0 = time.perf_counter()
            last_err: Exception | None = None
            for rid in rank(sid, candidates)[:MIGRATE_CANDIDATES]:
                with self._lock:
                    replica = self._replicas.get(rid)
                if replica is None or replica.state == DEAD:
                    continue
                try:
                    self._inject()
                    info = pool.get(replica).resume_session_info(sid)
                    cursor = int(info["cursor"])
                except (ServeError, FaultError, OSError) as e:
                    reopened = False
                    if (
                        isinstance(e, ServeError)
                        and e.code == 400
                        and (
                            "no journal" in str(e)
                            or "no open session" in str(e)
                        )
                    ):
                        # Died before its first journal snapshot: re-
                        # open from the recorded open fields and let
                        # the buffer replay rebuild the whole stream.
                        with self._lock:
                            of = self._open_fields.get(sid)
                        if of is not None:
                            try:
                                pool.get(replica).call(
                                    "open_session",
                                    **{**of, "session": sid},
                                )
                                cursor, info, reopened = 0, {}, True
                                with self._lock:
                                    self._counters[
                                        "migration_reopens"
                                    ] += 1
                            except (ServeError, OSError) as e2:
                                last_err = e2
                    if not reopened and not isinstance(e, ServeError):
                        pool.drop(rid)
                    if not reopened:
                        last_err = last_err or e
                        continue
                try:
                    self._replay_buffer(sid, cursor, replica, pool)
                except (ServeError, OSError) as e:
                    last_err = e
                    continue
                self._stash_journal_spans(sid, cursor, replica)
                dur = time.perf_counter() - t0
                self._lat.observe("fleet.migrate", dur)
                if self._trace_shard is not None:
                    with self._lock:
                        link = self._session_trace.get(sid)
                    if link:
                        # migration LINK span: this move — and the
                        # survivor's continued segments — stitch into
                        # the session's ORIGINAL trace id
                        self._trace_shard.complete(
                            "fleet.migrate", time.time() - dur, dur,
                            trace_id=link.get("trace_id"),
                            parent_id=link.get("span_id"),
                            args={
                                "from": from_rid,
                                "to": rid,
                                "cursor": int(cursor),
                            },
                        )
                with self._lock:
                    self._bind[sid] = rid
                    self._counters["migrations_total"] += 1
                    self._migrations.append(
                        {
                            "session": sid,
                            "from": from_rid,
                            "to": rid,
                            "cursor": int(cursor),
                            "duration_s": round(dur, 4),
                            # warm-vs-cold landing (satellite: plan-
                            # cache counts ride the resume response)
                            "plan_cache": info.get("plan_cache"),
                        }
                    )
                    del self._migrations[:-64]
                advise(
                    f"kcmc router: migrated session {sid} "
                    f"{from_rid} -> {rid} at cursor {cursor} "
                    f"({dur * 1e3:.0f}ms)",
                    stacklevel=2,
                )
                return rid
            with self._lock:
                self._counters["migration_failures"] += 1
            why = (
                f"{type(last_err).__name__}: {last_err}"
                if last_err is not None
                else "no candidates"
            )
            raise ServeError(
                f"session {sid!r} could not be migrated off "
                f"{from_rid} ({why})",
                code=503,
            )

    def _journal_dir_for(self, replica: Replica) -> str | None:
        if self._journal_dir:
            return self._journal_dir
        return replica.ready.get("journal_dir") or (
            (replica.last_stats or {})
            .get("resilience", {})
            .get("journal_dir")
        )

    def _stash_journal_spans(
        self, sid: str, cursor: int, replica: Replica
    ) -> None:
        """Rebuild the results spans the end client had not fetched
        before the migration. A rehydrated replica marks everything up
        to the resume cursor delivered, but the journal holds those
        batches' per-frame outputs (everything except corrected
        pixels) — merge, slice [delivered, cursor), and queue for the
        next results forward. Failure degrades to the documented
        PR-14 single-replica behavior (spans restart at the cursor;
        close_session still returns the full stream) — it must never
        fail the migration itself."""
        with self._lock:
            delivered = self._delivered.get(sid)
        if delivered is None or cursor <= delivered:
            return
        jdir = self._journal_dir_for(replica)
        if not jdir:
            return
        try:
            from kcmc_tpu_torch.corrector import merge_outputs
            from kcmc_tpu_torch.serve import journal as journal_mod

            loaded = journal_mod.load_session_journal(
                journal_mod.journal_path(jdir, sid)
            )
            if loaded is None:
                return
            _, segments, _ = loaded
            if not segments:
                return
            merged = merge_outputs([dict(s) for s in segments])
            total = min(
                len(next(iter(merged.values()))) if merged else 0,
                cursor,
            )
            if total <= delivered:
                return
            span: dict = {}
            for k, v in merged.items():
                arr = np.asarray(v)
                if arr.ndim >= 1 and arr.shape[0] == total:
                    span[k] = proto.encode_array(arr[delivered:total])
            span["first_frame"] = int(delivered)
            span["n"] = int(total - delivered)
            with self._lock:
                self._pending_spans.setdefault(sid, []).append(span)
        except Exception as e:
            advise(
                f"kcmc router: could not rebuild pre-migration spans "
                f"for {sid} ({type(e).__name__}: {e}); results resume "
                "at the cursor",
                stacklevel=2,
            )

    def _replay_buffer(
        self, sid: str, cursor: int, replica: Replica, pool: _UpstreamPool
    ) -> None:
        """Re-submit buffered frames past the resume cursor to the new
        replica, in order, with their original `first` indices (the
        idempotent-replay contract absorbs any overlap)."""
        with self._lock:
            entries = sorted(
                self._buffers.get(sid) or [], key=lambda e: e[0]
            )
            trace_ctx = self._session_trace.get(sid)
        # replayed frames carry the session's remembered trace context
        # — the survivor's segment spans stitch into the SAME trace
        trace_kw = {"trace": trace_ctx} if trace_ctx else {}
        next_needed = int(cursor)
        for first, n, enc, abs_dl in entries:
            if first + n <= next_needed:
                continue
            if first > next_needed:
                raise ServeError(
                    f"migration gap for session {sid!r}: frames "
                    f"{next_needed}..{first} are neither journaled "
                    "nor buffered",
                    code=500,
                )
            lo = next_needed - first
            payload = _enc_slice(enc, lo) if lo else enc
            dl_kw = {}
            if abs_dl is not None:
                # back to relative-remaining: whatever budget survived
                # the migration is what the new replica schedules to
                # (0 floors an already-blown deadline rather than
                # rejecting the replay)
                dl_kw["deadline_ms"] = max(
                    0.0, (abs_dl - time.time()) * 1000.0
                )
            pool.get(replica).call(
                "submit_frames",
                session=sid,
                frames=payload,
                first=next_needed,
                idempotent=True,
                # re-delivery, not new work: predictive admission must
                # not 429 a stream mid-migration
                replay=True,
                **trace_kw,
                **dl_kw,
            )
            next_needed = first + n

    # -- op handling -------------------------------------------------------

    def handle_op(self, msg: dict, pool: _UpstreamPool) -> dict:
        op = msg.get("op")
        if op == "ping":
            return {"ok": True}
        if op == "stats":
            return {"ok": True, "stats": self.stats()}
        if op == "metrics":
            return {"ok": True, "metrics": self.fleet_metrics()}
        if op == "trace":
            return {"ok": True, "spans": self.trace_dump(pool)}
        if op == "shutdown":
            return {"ok": True, "stats": self.stats()}
        if op == "open_session":
            return self._op_open(msg, pool)
        if op == "submit_frames":
            return self._op_submit(msg, pool)
        if op == "results":
            return self._op_results(msg, pool)
        if op == "close_session":
            return self._op_close(msg, pool)
        if op == "resume_session":
            return self._op_resume(msg, pool)
        raise ValueError(f"unknown op {op!r}")

    def _forward(
        self,
        sid: str,
        msg: dict,
        pool: _UpstreamPool,
        deadline: float | None = None,
        idempotent: bool = True,
    ) -> dict:
        """Forward one op to the session's replica; on transport death
        (or a replica that lost the session), migrate and retry once.
        The end client sees at most added latency."""
        fields = {k: v for k, v in msg.items() if k != "op"}
        ctx = None
        if self._trace_shard is not None:
            from kcmc_tpu_torch.obs.tracing import child_context, valid_context

            parent = valid_context(fields.get("trace"))
            if parent is not None:
                # re-parent: the replica's rpc.server span hangs under
                # the router's rpc.router span, which hangs under the
                # client's — one causal tree per request
                ctx = child_context(parent)
                fields["trace"] = ctx
        t_wall, t0 = time.time(), time.perf_counter()
        last: Exception | None = None
        for attempt in (0, 1):
            with self._lock:
                rid = self._bind.get(sid)
                replica = self._replicas.get(rid) if rid else None
            if rid is None:
                raise ServeError(
                    f"unknown session {sid!r} (open it through the "
                    "router first, or resume_session to re-bind it)",
                    code=400,
                )
            migrate = replica is None or replica.state == DEAD
            if not migrate:
                try:
                    self._inject()
                    resp = pool.get(replica).call(
                        msg["op"],
                        deadline=deadline,
                        idempotent=idempotent,
                        **fields,
                    )
                    if ctx is not None:
                        # the span covers any migrate-and-retry too —
                        # router-added latency is what it measures
                        self._trace_shard.complete(
                            "rpc.router", t_wall,
                            time.perf_counter() - t0,
                            trace_id=ctx["trace_id"],
                            span_id=ctx["span_id"],
                            parent_id=ctx.get("parent_id"),
                            args={"op": str(msg["op"])},
                        )
                    return resp
                except (FaultError, OSError) as e:
                    pool.drop(rid)
                    migrate, last = True, e
                except ServeError as e:
                    if e.code == 503:
                        pool.drop(rid)
                        migrate, last = True, e
                    elif e.code == 400 and "no open session" in str(e):
                        # the replica restarted underneath us: its
                        # journal can still resurrect the stream
                        migrate, last = True, e
                    else:
                        raise
            if migrate:
                if attempt:
                    raise ServeError(
                        f"session {sid!r}: replica failed after "
                        f"migration retry ({last})",
                        code=503,
                    )
                self._migrate_session(sid, rid, pool)
        raise AssertionError("unreachable")  # pragma: no cover

    def _op_open(self, msg: dict, pool: _UpstreamPool) -> dict:
        reject = self._admission_reject(
            qos_class=msg.get("qos_class") or None
        )
        if reject is not None:
            return reject
        sid = str(msg.get("session") or f"fr-{uuid.uuid4().hex[:12]}")
        placeable = self._placeable_rids()
        if not placeable:
            raise ServeError(
                "no healthy replicas to place the session on",
                code=503,
            )
        with self._lock:
            bound = self._bind.get(sid)
        if bound is not None:
            # idempotent replayed open of a session the router already
            # placed: forward to its replica (the server-side
            # collision contract takes it from there)
            rid = bound
        else:
            rid = place(sid, placeable)
            if msg.get("qos_class") == "latency":
                # latency-class streams chase the replica with the
                # lowest per-class predicted wait; rendezvous placement
                # stands when no replica has an estimate yet (cold
                # fleet), so pre-QoS behavior is unchanged
                best = self._lowest_wait_rid(placeable, "latency")
                if best is not None:
                    rid = best
        with self._lock:
            replica = self._replicas[rid]
        fields = {k: v for k, v in msg.items() if k != "op"}
        fields["session"] = sid
        self._inject()
        resp = pool.get(replica).call(
            "open_session",
            idempotent=msg.get("session") is not None,
            **fields,
        )
        with self._lock:
            self._bind[sid] = rid
            self._open_fields[sid] = dict(fields)
            self._buffers.setdefault(sid, [])
            self._delivered.setdefault(sid, 0)
            self._counters["sessions_routed"] += 1
        return resp

    def _lowest_wait_rid(
        self, placeable: list[str], qos_class: str
    ) -> str | None:
        """Rank placeable replicas by their OWN per-class predicted
        wait (scrape-snapshot histograms x local backlog). Returns None
        when no replica has a usable estimate — the caller keeps its
        rendezvous pick, so a cold fleet places exactly as before."""
        want = set(placeable)
        with self._lock:
            snaps = [
                (r.rid, r.last_metrics, r.queue_depth())
                for r in self._replicas.values()
                if r.rid in want and r.last_metrics is not None
            ]
        best_rid, best_wait = None, None
        for rid, metrics, depth in snaps:
            queued = int(
                (metrics.get("gauges") or {}).get("queued_frames", 0)
            )
            wait = predicted_wait_s(
                metrics, queued, max(int(depth), 1), qos_class=qos_class
            )
            if wait is None:
                continue
            if best_wait is None or wait < best_wait:
                best_rid, best_wait = rid, wait
        return best_rid

    def _admission_reject(
        self, qos_class: str | None = None
    ) -> dict | None:
        watermark = float(self.config.fleet_queue_watermark)
        if watermark >= 1.0:
            return None
        load = self.fleet_load()
        queued, capacity = load["queued_frames"], load["capacity"]
        limit = int(watermark * capacity)
        if capacity <= 0 or queued <= limit:
            return None
        hint = predicted_wait_s(
            self.fleet_metrics(), queued, capacity, qos_class=qos_class
        )
        with self._lock:
            self._counters["sessions_rejected"] += 1
        resp = {
            "ok": False,
            "code": 429,
            "error": (
                f"fleet at admission watermark: {queued} frames "
                f"queued across the fleet (limit {limit} of "
                f"{capacity} capacity) — retry shortly"
            ),
            "queued": queued,
            "limit": limit,
        }
        if hint is not None:
            resp["predicted_wait_s"] = hint
        return resp

    def _op_submit(self, msg: dict, pool: _UpstreamPool) -> dict:
        sid = str(msg["session"])
        tr = msg.get("trace")
        if isinstance(tr, dict) and tr.get("trace_id"):
            # remembered for migration: replayed frames and the
            # fleet.migrate link span continue this trace
            with self._lock:
                self._session_trace[sid] = tr
        first = msg.get("first")
        if first is not None:
            # the buffer stamps deadlines ABSOLUTE: a migration replay
            # happens later, and the client's budget keeps draining
            # while the router recovers the stream
            dl = msg.get("deadline_ms")
            abs_dl = (
                time.time() + float(dl) / 1000.0 if dl is not None
                else None
            )
            self._buffer_frames(sid, int(first), msg["frames"], abs_dl)
        return self._forward(
            sid, msg, pool, idempotent=first is not None
        )

    def _buffer_frames(
        self,
        sid: str,
        first: int,
        enc: dict,
        abs_deadline: float | None = None,
    ) -> None:
        n = _enc_nframes(enc)
        with self._lock:
            buf = self._buffers.setdefault(sid, [])
            # replace a replayed duplicate instead of stacking it
            buf[:] = [e for e in buf if e[0] != first]
            buf.append((first, n, enc, abs_deadline))
            buf.sort(key=lambda e: e[0])
            total = sum(e[1] for e in buf)
            while buf and total > BUFFER_CAP_FRAMES:
                total -= buf[0][1]
                del buf[0]

    def _op_results(self, msg: dict, pool: _UpstreamPool) -> dict:
        sid = str(msg["session"])
        timeout = float(msg.get("timeout", 60.0))
        t_end = time.monotonic() + timeout
        # Spans rebuilt from the journal during a migration come first:
        # the rehydrated replica considers everything before its resume
        # cursor delivered, but THIS client may not have fetched it yet.
        span = trim = None
        with self._lock:
            pending = self._pending_spans.get(sid)
            if pending:
                cand = pending.pop(0)
                if not pending:
                    del self._pending_spans[sid]
                delivered = self._delivered.get(sid, 0)
                lo, n = int(cand["first_frame"]), int(cand["n"])
                if lo + n > delivered:  # else fully stale: forward
                    self._delivered[sid] = lo + n
                    span, trim = cand, max(0, delivered - lo)
        if span is not None:
            if trim:
                span = self._trim_span(span, trim, int(span["n"]))
            return {"ok": True, **span}
        while True:
            resp = self._forward(
                sid, msg, pool, deadline=timeout, idempotent=True
            )
            if resp.get("exhausted"):
                return resp
            first = resp.get("first_frame")
            n = int(resp.get("n", 0))
            with self._lock:
                delivered = self._delivered.get(sid)
            if first is None or delivered is None:
                return resp
            first = int(first)
            if first + n <= delivered:
                # a whole span the client already has (re-delivered by
                # a migrated replica recomputing from its journal
                # cursor): swallow it and poll again within budget —
                # forwarding it would be a duplicated frame.
                if time.monotonic() >= t_end:
                    raise TimeoutError(
                        f"no results within {timeout}s for session "
                        f"{sid} (migration replay in progress)"
                    )
                continue
            if first < delivered:
                resp = self._trim_span(resp, delivered - first, n)
                first, n = delivered, n - (delivered - first)
            with self._lock:
                self._delivered[sid] = first + n
            return resp

    @staticmethod
    def _trim_span(resp: dict, lo: int, n: int) -> dict:
        """Drop the first `lo` frames of a results span (the part the
        client already received before a migration)."""
        out = dict(resp)
        for k, v in resp.items():
            if proto.is_array(v):
                arr = proto.decode_array(v)
                if arr.ndim >= 1 and arr.shape[0] == n:
                    out[k] = proto.encode_array(arr[lo:])
            elif isinstance(v, list) and len(v) == n:
                out[k] = v[lo:]
        out["first_frame"] = int(resp["first_frame"]) + lo
        out["n"] = n - lo
        return out

    def _op_close(self, msg: dict, pool: _UpstreamPool) -> dict:
        sid = str(msg["session"])
        try:
            resp = self._forward(
                sid,
                msg,
                pool,
                deadline=float(msg.get("timeout", 300.0)),
                idempotent=True,
            )
        except ServeError:
            with self._lock:
                failed = sid in self._failed
            if failed:
                # the stream's error has reached its client: unbind
                self._unbind(sid)
            raise
        self._unbind(sid)
        return resp

    def _unbind(self, sid: str) -> None:
        with self._lock:
            self._bind.pop(sid, None)
            self._open_fields.pop(sid, None)
            self._buffers.pop(sid, None)
            self._delivered.pop(sid, None)
            self._pending_spans.pop(sid, None)
            self._migrate_locks.pop(sid, None)
            self._session_trace.pop(sid, None)
            self._failed.pop(sid, None)

    def _op_resume(self, msg: dict, pool: _UpstreamPool) -> dict:
        sid = str(msg["session"])
        self._refuse_failed(sid)
        with self._lock:
            rid = self._bind.get(sid)
            replica = self._replicas.get(rid) if rid else None
        if replica is None or replica.state == DEAD:
            # not bound here (router restart, or its replica died):
            # bind by placement and let the replica's journal decide
            placeable = self._placeable_rids()
            if not placeable:
                raise ServeError(
                    "no healthy replicas to resume the session on",
                    code=503,
                )
            rid = place(sid, placeable)
            with self._lock:
                replica = self._replicas[rid]
        self._inject()
        resp = pool.get(replica).call(
            "resume_session", session=sid, idempotent=True
        )
        with self._lock:
            self._bind[sid] = rid
            self._buffers.setdefault(sid, [])
            # the replica's cursor is what the CLIENT will re-submit
            # from; span delivery also restarts there, and any spans
            # the router rebuilt for the OLD client are obsolete
            self._delivered[sid] = int(resp.get("cursor", 0))
            self._pending_spans.pop(sid, None)
        return resp

    # -- observability -----------------------------------------------------

    def fleet_metrics(self) -> dict:
        """The router's `metrics` verb: exact-merged replica payloads
        plus the router's own `fleet.migrate` spans — schema-
        compatible with a single replica's payload, so `top`
        and `render_prometheus` work unchanged."""
        with self._lock:
            payloads = {
                rid: r.last_metrics
                for rid, r in self._replicas.items()
                if r.last_metrics is not None and r.state != DEAD
            }
            states = {rid: r.state for rid, r in self._replicas.items()}
        merged = merge_fleet_metrics(
            payloads, extra_hists=self._lat.hist_dicts(), states=states
        )
        merged["latency_telemetry"] = True
        if self._slo is not None:
            # burn rates over the fleet-merged histograms/counters —
            # the engine's own lock serializes concurrent scrapers
            self._slo.tick(
                (merged.get("plane") or {}).get("histograms") or {},
                merged.get("counters") or {},
            )
            slo = self._slo.gauges()
            merged["slo"] = slo
            alerts = set(slo.get("alerts") or [])
            with self._lock:
                new = sorted(alerts - self._slo_alerted)
                self._slo_alerted = alerts
            for line in new:
                # alert TRANSITION, logged once per firing
                advise(f"kcmc router: SLO {line}", stacklevel=2)
        return merged

    def trace_dump(self, pool: _UpstreamPool) -> list[dict]:
        """The router's `trace` verb: recent spans from every live
        replica's in-memory ring plus the router's own forward and
        migration spans — the live stitched-fleet source for
        `python -m kcmc_tpu_torch trace <addr>`."""
        spans: list[dict] = []
        for replica in self._snapshot():
            if replica.state == DEAD:
                continue
            try:
                self._inject()
                resp = pool.get(replica).call("trace", idempotent=True)
                spans.extend(resp.get("spans") or [])
            except (ServeError, FaultError, OSError):
                continue  # an unreachable ring loses only ITS spans
        if self._trace_shard is not None:
            spans.extend(self._trace_shard.tail())
        return spans

    def stats(self) -> dict:
        with self._lock:
            replicas = {
                rid: {
                    "state": r.state,
                    "spawned": r.proc is not None,
                    "probes": r.health.probes,
                    "sessions": sum(
                        1 for v in self._bind.values() if v == rid
                    ),
                }
                for rid, r in self._replicas.items()
            }
            out = {
                "router": True,
                "replicas": replicas,
                "sessions": dict(self._bind),
                "buffered_frames": {
                    sid: sum(e[1] for e in buf)
                    for sid, buf in self._buffers.items()
                    if buf
                },
                "migrations": list(self._migrations),
                **dict(self._counters),
            }
        return out

    # -- drain / lifecycle -------------------------------------------------

    def drain_replica(
        self, rid: str, pool: _UpstreamPool | None = None
    ) -> dict:
        """Scale-down / operator drain: stop placing on `rid`, stop it
        gracefully (SIGTERM journals every open session), migrate its
        sessions to survivors, and remove it from the fleet."""
        own_pool = pool is None
        if own_pool:
            pool = _UpstreamPool()
        try:
            with self._lock:
                replica = self._replicas.get(rid)
                if replica is None:
                    raise KeyError(f"unknown replica {rid!r}")
                replica.health.state = DRAINING
            if replica.proc is not None:
                stop_replica(replica)
            else:
                try:
                    pool.get(replica).shutdown()
                except (ServeError, OSError):
                    pass
                pool.drop(rid)
            replica.health.kill()
            with self._lock:
                stranded = [
                    sid for sid, b in self._bind.items() if b == rid
                ]
            moved, failed = [], []
            for sid in stranded:
                try:
                    moved.append(
                        (sid, self._migrate_session(sid, rid, pool))
                    )
                except ServeError as e:
                    failed.append((sid, str(e)))
            with self._lock:
                self._replicas.pop(rid, None)
                self._counters["replicas_drained"] += 1
            advise(
                f"kcmc router: drained replica {rid} "
                f"({len(moved)} sessions migrated)",
                stacklevel=2,
            )
            return {"replica": rid, "migrated": moved, "failed": failed}
        finally:
            if own_pool:
                pool.close()

    def start(self) -> "FleetRouter":
        self._tcp_thread = threading.Thread(
            target=self._tcp.serve_forever,
            name="kcmc-router-tcp",
            daemon=True,
        )
        self._tcp_thread.start()
        self._probe_thread = threading.Thread(
            target=self._probe_loop,
            name="kcmc-fleet-probe",
            daemon=True,
        )
        self._probe_thread.start()
        return self

    def request_shutdown(self) -> None:
        self._shutdown.set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._shutdown.wait(timeout)

    def stop(self, stop_owned: bool = False) -> None:
        self._stop.set()
        self._tcp.shutdown()
        self._tcp.server_close()
        if self._tcp_thread is not None:
            self._tcp_thread.join(timeout=10.0)
            self._tcp_thread = None
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=10.0)
            self._probe_thread = None
        if self._trace_shard is not None:
            self._trace_shard.close()
        if stop_owned:
            for replica in self._snapshot():
                stop_replica(replica)

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- CLI body --------------------------------------------------------------


def router_main(args) -> int:
    """`python -m kcmc_tpu_torch router` body (argparse args from
    __main__.py): spawn/adopt replicas, serve the fleet, drain clean.
    The first stdout line is a machine-readable ready record
    (`{"routing": true, "port": N, ...}`), mirroring `serve`. Spawned
    replicas run on `args.device` (the top-level `--device`: None is
    the card), passed on as their own top-level flag."""
    import shlex
    import tempfile

    from kcmc_tpu_torch.config import CorrectorConfig
    from kcmc_tpu_torch.serve.autoscale import Autoscaler
    from kcmc_tpu_torch.serve.fleet import spawn_replica
    from kcmc_tpu_torch.utils.faults import resolve_fault_plan

    cfg_kw = {}
    for field, arg in (
        ("fleet_probe_interval_s", "probe_interval"),
        ("fleet_suspect_probes", "suspect_probes"),
        ("fleet_dead_probes", "dead_probes"),
        ("fleet_wedge_threshold_s", "wedge_threshold"),
        ("fleet_queue_watermark", "watermark"),
        ("fleet_scale_cooldown_s", "scale_cooldown"),
        ("trace_shard_dir", "trace_shards"),
        ("slo_objectives", "slo"),
    ):
        v = getattr(args, arg, None)
        if v is not None:
            cfg_kw[field] = v
    config = CorrectorConfig(**cfg_kw)
    fault_plan = resolve_fault_plan(getattr(args, "inject_faults", None))

    journal_dir = args.journal_dir
    if args.spawn and not journal_dir:
        # migration REQUIRES a shared journal directory; default one
        # so a spawned fleet is always migratable
        journal_dir = tempfile.mkdtemp(prefix="kcmc-fleet-journal-")
    serve_args = list(shlex.split(args.serve_args or ""))
    if journal_dir and "--journal-dir" not in serve_args:
        serve_args += ["--journal-dir", journal_dir]
    # tracing/SLO flags propagate to spawned replicas: every process
    # of the fleet shards spans into the same directory, so `python -m kcmc_tpu_torch
    # trace DIR` stitches one fleet trace
    ts = getattr(args, "trace_shards", None)
    if ts and "--trace-shards" not in serve_args:
        serve_args += ["--trace-shards", ts]
    slo_spec = getattr(args, "slo", None)
    if slo_spec and "--slo" not in serve_args:
        serve_args += ["--slo", slo_spec]
    if "--port" not in serve_args:
        serve_args = ["--port", "0", *serve_args]

    device = getattr(args, "device", None)
    replicas: list[Replica] = []
    try:
        for _ in range(int(args.spawn or 0)):
            replicas.append(
                spawn_replica(
                    serve_args,
                    suspect_probes=config.fleet_suspect_probes,
                    dead_probes=config.fleet_dead_probes,
                    device=device,
                )
            )
        for spec in (args.replicas or "").split(","):
            spec = spec.strip()
            if not spec:
                continue
            host, _, port = spec.rpartition(":")
            replicas.append(
                Replica(
                    host or "127.0.0.1",
                    int(port),
                    suspect_probes=config.fleet_suspect_probes,
                    dead_probes=config.fleet_dead_probes,
                )
            )
        if not replicas:
            raise SystemExit(
                "kcmc router: no replicas (pass --spawn N and/or "
                "--replicas host:port,...)"
            )
        router = FleetRouter(
            replicas,
            host=args.host,
            port=args.port,
            config=config,
            fault_plan=fault_plan,
            journal_dir=journal_dir,
        )
        router.start()
    except BaseException:
        for r in replicas:
            stop_replica(r)
        raise

    scaler = None
    if getattr(args, "autoscale", False):
        def _spawn():
            return spawn_replica(
                serve_args,
                suspect_probes=config.fleet_suspect_probes,
                dead_probes=config.fleet_dead_probes,
                device=device,
            )

        scaler = Autoscaler(
            router,
            spawn_fn=_spawn,
            min_replicas=int(args.min_replicas or len(replicas)),
            max_replicas=int(args.max_replicas or len(replicas)),
            cooldown_s=config.fleet_scale_cooldown_s,
        )
        scaler.start()

    try:
        import signal

        signal.signal(signal.SIGTERM, lambda *_: router.request_shutdown())
    except ValueError:
        pass
    print(
        json.dumps(
            {
                "routing": True,
                "host": router.host,
                "port": router.port,
                "replicas": sorted(r.rid for r in replicas),
                "journal_dir": journal_dir,
                "autoscale": scaler is not None,
            }
        ),
        flush=True,
    )
    try:
        while not router.wait(timeout=0.5):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        if scaler is not None:
            scaler.stop()
        stats = router.stats()
        router.stop(stop_owned=True)
        print(json.dumps({"routed": True, "stats": stats}), flush=True)
    return 0
