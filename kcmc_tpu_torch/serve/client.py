"""ServeClient: the bundled Python client for `python -m kcmc_tpu_torch
serve` (the port's copy of kcmc_tpu/serve/client.py).

A thin wrapper over the line-delimited JSON protocol (serve/proto.py;
numpy and the standard library, no torch) used by the tests and
`chip_smoke.py`. The protocol is the reference's, so this client also
drives the JAX package's server, and the JAX package's client drives
this one:

    from kcmc_tpu_torch.serve.client import ServeClient

    with ServeClient(port=7733) as c:
        sid = c.open_session(tenant="scope-A")
        c.submit(sid, frames)           # any number of times
        final = c.close_session(sid)    # {"transforms": (T,3,3), ...}

One socket per client; calls are serialized with a lock (the protocol
is strict request/response). Open several clients for concurrent
streams — the server multiplexes them onto its one warm backend.

Resilience (docs/ROBUSTNESS.md "Serve-plane failures"): every socket
operation carries a deadline — connects bound by `connect_timeout`,
reads by a per-op deadline derived from `io_timeout` (matching the
server's `serve_io_timeout_s` default), so a half-open socket surfaces
as a retryable timeout instead of a forever-block. On a transport
failure the client reconnects with exponential backoff and REPLAYS the
request when it is idempotent: submits carry monotonic frame indices
(the server deduplicates the overlap), opens carry the client-chosen
session id, `close_session`/`resume_session`/`stats` are idempotent by
server contract, and `results` replays are gap-GUARDED — a span whose
reply died in transit raises ServeError(code=410) naming the lost
frames instead of silently skipping. A server restart looks like
latency, not data loss: `resume_session` re-syncs the cursor and the
client re-submits from it. When reconnection is exhausted, calls raise
``ServeError`` with ``code == 503`` ("server gone") — distinct from a
drained stream, which `results` reports as ``None``.
"""

from __future__ import annotations

import os
import socket
import threading
import time

import numpy as np

from kcmc_tpu_torch.serve import proto


class ServeError(RuntimeError):
    """Server-reported failure; `.code` carries the protocol code
    (429 = admission rejection, 400 = bad request, 500 = stream
    failure, 503 = transport down — the server is unreachable after
    bounded reconnect attempts)."""

    def __init__(self, message: str, code: int = 500, **info):
        super().__init__(message)
        self.code = int(code)
        self.info = info


class ServeClient:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 7733,
        timeout: float = 600.0,
        connect_timeout: float = 10.0,
        io_timeout: float | None = None,
        reconnect_attempts: int = 4,
        reconnect_backoff_s: float = 0.25,
        trace: bool = True,
        trace_shard=None,
    ):
        """`timeout` bounds long blocking ops (close_session's default
        wait) and CAPS the transport deadlines below — the historical
        `timeout=` callers bounded every socket op with it, and a small
        value must keep meaning "fail fast on a dead transport".
        `io_timeout` is the per-read deadline floor — None derives it
        from `CorrectorConfig.serve_io_timeout_s`'s default (the serve
        plane's transport-deadline baseline; the server's ready record
        advertises its configured value for operator tooling);
        `connect_timeout` bounds each (re)connect;
        `reconnect_attempts`/`reconnect_backoff_s` shape the
        exponential-backoff reconnect loop.

        `trace` (default on): every call mints a 128-bit trace id +
        root span id (obs/tracing.py) and sends them as the message's
        ``trace`` field, so any request can be followed client →
        server → device. Minting is two `os.urandom` reads per call.
        `trace_shard` (a path or an `obs.tracing.SpanShard`)
        additionally records one client-side `rpc.client` span per
        call, giving the stitched trace its root."""
        if io_timeout is None:
            from kcmc_tpu_torch.config import CorrectorConfig

            io_timeout = CorrectorConfig.__dataclass_fields__[
                "serve_io_timeout_s"
            ].default
        self._addr = (host, port)
        self._timeout = float(timeout)
        self._connect_timeout = min(float(connect_timeout), self._timeout)
        self._io_timeout = min(float(io_timeout), self._timeout)
        self._reconnect_attempts = max(int(reconnect_attempts), 1)
        self._reconnect_backoff_s = float(reconnect_backoff_s)
        # The shared retry-policy machinery (capped exponential backoff
        # + jitter): many clients reconnecting to a restarted server
        # must not thundering-herd it, so each client jitters
        # from its own seed.
        from kcmc_tpu_torch.utils.faults import RetryPolicy

        self._reconnect_policy = RetryPolicy(
            attempts=self._reconnect_attempts,
            backoff_s=self._reconnect_backoff_s,
            seed=(os.getpid() << 16) ^ (id(self) & 0xFFFF),
        )
        # RLock: ops like submit read-modify-write the idempotency
        # cursors around their _call (which takes the lock itself) —
        # the whole op must be atomic or two threads sharing a session
        # would send the same `first` and the server would dedup one
        # thread's REAL frames away.
        self._lock = threading.RLock()
        # close() is terminal: without this flag the reconnect layer
        # would transparently resurrect a closed client on its next
        # call, leaking a connection and hiding use-after-close bugs.
        self._closed = False
        self._sock: socket.socket | None = None
        self._rfile = None
        self._wfile = None
        # Whether the most recent _call tore down/reopened the socket —
        # open_session uses it to tell a replayed-own-open collision
        # (benign) from a genuine session-id collision (an error).
        self._last_call_reconnected = False
        # Idempotent-submit cursors: session id -> next frame index.
        # Maintained automatically by open/resume/submit so every
        # submit carries its `first` idempotency key.
        self._next: dict[str, int] = {}
        # Results-delivery cursors: session id -> expected first_frame
        # of the next span. A replayed `results` whose reply was lost
        # AFTER the server released the span would otherwise silently
        # gap the stream — the mismatch raises instead (code 410).
        self._results_next: dict[str, int] = {}
        self._trace = bool(trace)
        # The context of the most recent traced call — tests read the
        # trace id of the request they just made.
        self.last_trace: dict | None = None
        self._trace_shard = None
        if trace_shard is not None:
            from kcmc_tpu_torch.obs.tracing import SpanShard

            self._trace_shard = (
                trace_shard
                if isinstance(trace_shard, SpanShard)
                else SpanShard(str(trace_shard))
            )
        self._connect_locked()

    # -- plumbing ----------------------------------------------------------

    def _connect_locked(self, timeout: float | None = None) -> None:
        self._sock = socket.create_connection(
            self._addr,
            timeout=(
                self._connect_timeout
                if timeout is None
                else min(self._connect_timeout, max(timeout, 0.001))
            ),
        )
        self._sock.settimeout(self._io_timeout)
        self._rfile = self._sock.makefile("rb")
        self._wfile = self._sock.makefile("wb")

    def _teardown_locked(self) -> None:
        for f in (self._rfile, self._wfile):
            try:
                if f is not None:
                    f.close()
            except OSError:
                pass
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._sock = self._rfile = self._wfile = None

    def _call(
        self,
        op: str,
        _deadline: float | None = None,
        _idempotent: bool = True,
        _budget: float | None = None,
        **fields,
    ) -> dict:
        """One request/response round-trip with the resilience layer.

        The read deadline is ``max(io_timeout, _deadline) + io_timeout``
        — ops that legitimately block server-side (results/close) pass
        their op timeout so the socket deadline is always LONGER than
        the server-side wait (io_timeout of grace on top); a deadline
        that still fires means a dead or half-open transport, not a
        slow result. Idempotent requests are replayed across
        reconnects; non-idempotent ones surface the transport error
        after the first send attempt.

        `_budget` is a hard wall-clock cap on the WHOLE call —
        connects, reads, backoff sleeps, and every reconnect replay
        together. The first attempt always runs (with its socket
        deadlines clipped to the budget), later attempts are skipped
        once the budget is spent, so a wedged server can never hold a
        budgeted caller (a health probe) past its budget."""
        deadline = max(self._io_timeout, _deadline or 0.0) + self._io_timeout
        t_end = (
            None if _budget is None else time.monotonic() + float(_budget)
        )
        msg = {"op": op, **fields}
        ctx = None
        if self._trace and "trace" not in msg:
            # Mint ONCE per call, before the retry loop: a reconnect
            # replay re-sends the same trace/span ids, so the server's
            # idempotent dedup and the trace tree agree on identity.
            from kcmc_tpu_torch.obs.tracing import new_context

            ctx = new_context()
            msg["trace"] = ctx
        t_wall = time.time()
        t_perf = time.perf_counter()
        last: Exception | None = None
        resp: dict | None = None
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    "ServeClient is closed; create a new client"
                )
            if ctx is not None:
                # under the call lock: embedders share clients across
                # threads, and last_trace must pair with THIS call
                self.last_trace = ctx
            self._last_call_reconnected = False
            tried = 0
            for attempt in range(self._reconnect_attempts):
                if attempt:
                    if t_end is not None and time.monotonic() >= t_end:
                        break  # budget spent: no more replays
                    sleep_s = self._reconnect_policy.delay(attempt - 1)
                    if t_end is not None:
                        sleep_s = min(
                            sleep_s, max(t_end - time.monotonic(), 0.0)
                        )
                    self._reconnect_policy.sleep(sleep_s)
                try:
                    tried = attempt + 1
                    remaining = (
                        None
                        if t_end is None
                        else max(t_end - time.monotonic(), 0.001)
                    )
                    if self._sock is None:
                        # Entering with no socket means a PREVIOUS call
                        # (or disconnect()) tore the transport down —
                        # this call's request may be a replay of one
                        # the server already processed, so the lost-
                        # reply guards (open collision, results 410)
                        # must see it as a reconnect even when the
                        # connect itself succeeds first try.
                        self._last_call_reconnected = True
                        self._connect_locked(timeout=remaining)
                    self._sock.settimeout(
                        deadline
                        if remaining is None
                        else min(deadline, remaining)
                    )
                    proto.send_msg(self._wfile, msg)
                    resp = proto.recv_msg(self._rfile, max_line=None)
                    if resp is None:
                        raise ConnectionError(
                            "server closed the connection mid-request"
                        )
                except (OSError, ValueError, ConnectionError) as e:
                    # OSError covers socket.timeout; ValueError covers a
                    # line truncated by a dying peer.
                    last = e
                    resp = None
                    self._teardown_locked()
                    self._last_call_reconnected = True
                    if not _idempotent:
                        break
                    continue
                finally:
                    if self._sock is not None:
                        self._sock.settimeout(self._io_timeout)
                break
            if resp is None:
                raise ServeError(
                    f"server {self._addr[0]}:{self._addr[1]} unreachable "
                    f"after {tried} attempt(s) "
                    f"({type(last).__name__}: {last})",
                    code=503,
                )
        if ctx is not None and self._trace_shard is not None:
            self._trace_shard.complete(
                "rpc.client",
                t_wall,
                time.perf_counter() - t_perf,
                trace_id=ctx["trace_id"],
                span_id=ctx["span_id"],
                args={"op": op},
            )
        if not resp.get("ok"):
            raise ServeError(
                resp.get("error", "unknown server error"),
                code=int(resp.get("code", 500)),
                **{
                    k: v
                    for k, v in resp.items()
                    if k not in ("ok", "error", "code")
                },
            )
        return resp

    def disconnect(self) -> None:
        """Drop the transport but keep the client usable: the next
        call reconnects (with backoff) and replays if idempotent.
        Chaos/test seam — lets a caller force the reconnect path
        without waiting for a real transport failure."""
        with self._lock:
            self._teardown_locked()

    def close(self) -> None:
        """Terminal: tear down the socket and refuse further calls —
        the reconnect layer must not silently resurrect a client its
        owner closed."""
        with self._lock:
            self._closed = True
            self._teardown_locked()
        if self._trace_shard is not None:
            self._trace_shard.close()

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- ops ----------------------------------------------------------------

    def ping(self) -> bool:
        return bool(self._call("ping").get("ok"))

    def open_session(
        self,
        tenant: str = "default",
        weight: int = 1,
        reference: np.ndarray | None = None,
        template_update: int | None = None,
        emit: bool = False,
        output: str | None = None,
        expected_frames: int | None = None,
        output_dtype: str = "float32",
        compression: str = "none",
        session_id: str | None = None,
        qos_class: str = "batch",
        deadline_ms: float | None = None,
    ) -> str:
        """Open a stream. Pass `session_id` (a client-chosen id) to
        make the open idempotent across reconnect retries — a retry
        whose first attempt actually succeeded server-side re-attaches
        instead of double-opening.

        `qos_class` ("latency" | "batch", default "batch") declares
        the session's scheduling class (docs/SERVING.md "Latency
        QoS"): latency-class sessions may preempt the dispatch window
        and dispatch partial windows against their deadlines.
        `deadline_ms` sets a session-default per-frame deadline
        (milliseconds from submit); per-submit values override it."""
        fields: dict = {
            "tenant": tenant,
            "weight": weight,
            "emit": emit,
            "output_dtype": output_dtype,
            "compression": compression,
            "qos_class": str(qos_class),
        }
        if deadline_ms is not None:
            fields["deadline_ms"] = float(deadline_ms)
        if reference is not None:
            fields["reference"] = proto.encode_array(
                np.asarray(reference, np.float32)
            )
        if template_update is not None:
            fields["template_update"] = int(template_update)
        if output is not None:
            fields["output"] = output
            fields["expected_frames"] = int(expected_frames)
        if session_id is not None:
            fields["session"] = str(session_id)
        with self._lock:
            try:
                sid = self._call(
                    "open_session",
                    _idempotent=session_id is not None,
                    **fields,
                )["session"]
            except ServeError as e:
                # Reconnect-retry race ONLY: the first attempt opened
                # the session, the reply was lost in the teardown, and
                # the replay collided with our own id — that IS a
                # successful open. Without a reconnect during this
                # call, "already open" is a genuine id collision with
                # someone else's live stream and must surface.
                if (
                    session_id is not None
                    and e.code == 400
                    and "already open" in str(e)
                    and self._last_call_reconnected
                ):
                    sid = str(session_id)
                    # A reconnect makes the collision AMBIGUOUS, not
                    # ours: confirm via the live session's cursor. Our
                    # replayed open has 0 submitted frames; a foreign
                    # stream with frames would otherwise silently
                    # dedup this client's real submits away as
                    # "replays" of frames it never sent.
                    cursor = int(
                        self._call("resume_session", session=sid)["cursor"]
                    )
                    if cursor != 0:
                        raise ServeError(
                            f"session {sid!r} is already open with "
                            f"{cursor} submitted frames — an id "
                            "collision with another client's live "
                            "stream, not this call's replayed open",
                            code=400,
                        ) from e
                else:
                    raise
            self._next[sid] = 0
            self._results_next[sid] = 0
        return sid

    def resume_session(self, session_id: str) -> int:
        """Re-attach to `session_id` — live on this server, or
        rehydrated from its journal on a restarted one — and return
        the resume cursor: the index of the first frame the server
        does NOT have durably. Re-submit frames from there (the
        automatic `first` indices make overlap harmless)."""
        return int(self.resume_session_info(session_id)["cursor"])

    def resume_session_info(self, session_id: str) -> dict:
        """`resume_session` returning the FULL response record:
        ``cursor``, ``resumed``, and — when the server rehydrated the
        stream from a journal — ``plan_cache`` (the rehydrating
        replica's plan-cache hit/miss counts for the session's live
        shapes), so a caller can tell a warm landing from a cold one. Updates the client's idempotency cursors exactly
        like `resume_session`."""
        with self._lock:
            resp = self._call("resume_session", session=str(session_id))
            cursor = int(resp["cursor"])
            self._next[str(session_id)] = cursor
            if resp.get("resumed"):
                # Journal rehydrate: the restored server marks the
                # journaled spans delivered, so results resume exactly
                # at the cursor.
                self._results_next[str(session_id)] = cursor
            # Live re-attach (resumed=False): cursor is the SUBMIT
            # high-water mark, not the delivery cursor — rebasing
            # _results_next to it would blind the 410 lost-span guard
            # to any span released to the dropped connection. Keep the
            # existing delivery cursor (or stay unguarded if this
            # client never tracked one).
        return {k: v for k, v in resp.items() if k != "ok"}

    def submit(
        self,
        session: str,
        frames: np.ndarray,
        deadline_ms: float | None = None,
    ) -> dict:
        """Submit frames; returns the admission decision
        ``{"accepted", "queued", "degraded", "deduped", "next"}``.
        Raises ServeError with ``code == 429`` when the session queue
        is full — or when predictive admission rejects a `deadline_ms`
        the horizon model already predicts will be missed (the error's
        ``.info["predicted_wait_s"]`` carries the hint). Idempotent:
        every call carries the session-global index of its first
        frame, so a reconnect-retried submit never double-processes a
        frame. The cursor read-send-update is atomic under the client
        lock, so threads sharing one client interleave whole submits,
        never halves."""
        fields: dict = {
            "session": session,
            "frames": proto.encode_array(np.asarray(frames)),
        }
        if deadline_ms is not None:
            fields["deadline_ms"] = float(deadline_ms)
        with self._lock:
            first = self._next.get(session)
            if first is not None:
                fields["first"] = int(first)
            # Without a cursor (a session this client neither opened
            # nor resumed) the server appends unconditionally — a
            # replay would double-process, so only cursored submits
            # are retried.
            resp = self._call(
                "submit_frames", _idempotent=first is not None, **fields
            )
            if first is not None and "next" in resp:
                # Advance only a cursor this client ESTABLISHED via
                # open/resume. Caching the server's cursor for a
                # session someone else writes to would turn our next
                # uncursored append into a `first=` submit and dedup
                # the other writer's interleaved real frames away.
                self._next[session] = int(resp["next"])
        return {k: v for k, v in resp.items() if k != "ok"}

    def results(self, session: str, timeout: float = 60.0) -> dict | None:
        """Fetch the next undelivered span of per-frame outputs (blocks
        server-side until some are ready). None once the stream is
        closed and EXHAUSTED — distinct from a dead server, which
        raises ServeError(code=503) after bounded reconnects.

        Replayed across reconnects, with a guard: the server releases
        a span when it hands it over, so a reply lost mid-transport
        loses that span's incremental arrays. The client tracks the
        expected next frame and raises ServeError(code=410) naming the
        gap instead of silently skipping; a reply lost when no later
        span can expose the gap (the replay finds the stream
        exhausted) raises the same 410 conservatively. The full
        stream's transforms/diagnostics remain available via
        close_session either way."""
        with self._lock:
            resp = self._call(
                "results", _deadline=float(timeout),
                session=session, timeout=float(timeout),
            )
            if resp.get("exhausted"):
                if (
                    self._last_call_reconnected
                    and self._results_next.get(session) is not None
                ):
                    # The reply that died with the dropped connection
                    # may have carried the stream's FINAL span — no
                    # later span can ever expose the gap, so a silent
                    # None here could be data loss. Surface it as the
                    # same recoverable 410; close_session returns the
                    # full stream's outputs either way.
                    expected = self._results_next.pop(session)
                    raise ServeError(
                        "results reply lost across a reconnect and the "
                        "stream is now exhausted: frames from "
                        f"{expected} may have been released to the "
                        "dropped connection — close_session still "
                        "returns the full stream's outputs",
                        code=410,
                        lost_first=expected,
                    )
                return None
            out = proto.decode_arrays(
                {k: v for k, v in resp.items() if k != "ok"}
            )
            expected = self._results_next.get(session)
            first = out.get("first_frame")
            if first is not None:
                if expected is not None and int(first) > expected:
                    # advance past the gap so a caller catching the
                    # error can keep consuming subsequent spans; the
                    # span THIS reply carried rides along in .info —
                    # raising must not lose it too
                    self._results_next[session] = int(first) + int(
                        out.get("n", 0)
                    )
                    raise ServeError(
                        f"results span lost across a reconnect: frames "
                        f"{expected}..{int(first)} were delivered to a "
                        "dropped connection (this error's .info['span'] "
                        "carries the current span "
                        f"{int(first)}..{int(first) + int(out.get('n', 0))}; "
                        "close_session still returns the full stream's "
                        "outputs)",
                        code=410,
                        lost_first=expected,
                        lost_until=int(first),
                        span=out,
                    )
                self._results_next[session] = int(first) + int(
                    out.get("n", 0)
                )
        return out

    def close_session(self, session: str, timeout: float | None = None) -> dict:
        """Finish the stream; returns the final merged outputs —
        ``transforms``/``fields``, ``diagnostics`` (decoded arrays),
        ``timing``, ``frames``, and ``corrected`` when the session was
        opened with ``emit=True``. Retryable by server contract: a
        close replayed after a lost reply still returns the final
        result."""
        timeout = self._timeout if timeout is None else float(timeout)
        with self._lock:
            resp = self._call(
                "close_session", _deadline=timeout,
                session=session, timeout=timeout,
            )
            self._next.pop(session, None)
            self._results_next.pop(session, None)
        out = {k: v for k, v in resp.items() if k != "ok"}
        for key in ("transforms", "fields", "corrected"):
            if key in out:
                out[key] = proto.decode_array(out[key])
        if "diagnostics" in out:
            out["diagnostics"] = proto.decode_arrays(out["diagnostics"])
        return out

    def stats(self, timeout: float | None = None) -> dict:
        """Scheduler gauges. `timeout` is a hard cap on the WHOLE
        round-trip (connects + reads + reconnect backoff together) —
        a health prober's budget, not a per-socket-op deadline."""
        return self._call("stats", _budget=timeout)["stats"]

    def metrics(self, timeout: float | None = None) -> dict:
        """The request-latency telemetry payload (`metrics` verb):
        per-segment latency summaries, mergeable histogram state,
        counters and gauges — see docs/OBSERVABILITY.md "Request
        latency". Idempotent read, replayed across reconnects.
        `timeout` hard-caps the whole round-trip like `stats`."""
        return self._call("metrics", _budget=timeout)["metrics"]

    def trace_dump(self, timeout: float | None = None) -> list[dict]:
        """Recent finished spans from the server's bounded in-memory
        span ring (`trace` verb). The live source for `python -m
        kcmc_tpu_torch trace HOST:PORT`; empty when tracing is
        unarmed."""
        return list(self._call("trace", _budget=timeout).get("spans") or [])

    def call(
        self,
        op: str,
        *,
        deadline: float | None = None,
        idempotent: bool = True,
        budget: float | None = None,
        **fields,
    ) -> dict:
        """Raw protocol passthrough: one `op` round-trip with `fields`
        sent VERBATIM (already-encoded arrays included) under the full
        resilience layer. Does NOT touch the idempotency/delivery cursors; callers that
        need them use the typed ops above."""
        return self._call(
            op,
            _deadline=deadline,
            _idempotent=idempotent,
            _budget=budget,
            **fields,
        )

    def shutdown(self) -> dict:
        """Ask the server process to exit cleanly; returns final stats.
        Not replayed across reconnects — a lost reply after a
        successful shutdown would otherwise spin on a dead address."""
        return self._call("shutdown", _idempotent=False).get("stats", {})
