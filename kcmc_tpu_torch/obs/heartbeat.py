"""Heartbeat: periodic liveness + progress lines for unattended runs
(the port's copy of kcmc_tpu/obs/heartbeat.py).

A multi-hour streaming run's only live signal used to be `--progress`
frame counts (stdout, chatty) or nothing. The heartbeat thread samples
the run every `interval_s` seconds and emits ONE line to stderr —
frames done / total, fps, stall fractions, robustness counters — so a
supervisor (or a human tailing the log) can distinguish "slow but
alive" from "wedged" without attaching a debugger. Complements the
`_StallWatchdog` (which hard-exits on zero progress): the watchdog
acts, the heartbeat narrates.

Lifecycle: `start()` spawns one daemon thread; `stop()` signals and
JOINS it (bounded by one interval), so tests can assert no thread
leaks. Sampling failures are swallowed after one diagnostic — a
telemetry bug must never take down the run it observes.
"""

from __future__ import annotations

import logging
import sys
import threading


def _default_emit(message: str) -> None:
    """Log through `kcmc_tpu_torch.heartbeat` when a handler is attached AND
    the record would actually pass level filtering; plain stderr
    otherwise. Whoever set heartbeat_s>0 asked for the output — an
    embedder who attached a handler to `kcmc_tpu_torch` but left the default
    WARNING level must still see the liveness line, not have INFO
    records silently filtered away."""
    logger = logging.getLogger("kcmc_tpu_torch.heartbeat")
    if logging.getLogger("kcmc_tpu_torch").handlers and logger.isEnabledFor(
        logging.INFO
    ):
        logger.info(message)
    else:
        print(f"[kcmc heartbeat] {message}", file=sys.stderr, flush=True)


class Heartbeat:
    """Emit `sample()`'s message every `interval_s` seconds on a
    background thread. `sample` returns the line to emit (str) or None
    to skip a beat."""

    def __init__(self, interval_s: float, sample, emit=None):
        if interval_s <= 0:
            raise ValueError(
                f"heartbeat interval must be positive seconds, got {interval_s}"
            )
        self.interval_s = float(interval_s)
        self._sample = sample
        self._emit = emit if emit is not None else _default_emit
        self._stop = threading.Event()
        # start/stop are a cross-thread handoff in serving: a session's
        # heartbeat starts on the client thread (session construction)
        # and stops on the scheduler thread (finalize) — the handle
        # swap is guarded so the joiner always sees the started thread.
        self._lifecycle = threading.Lock()
        self._thread: threading.Thread | None = None
        self.beats = 0  # emitted lines (lifecycle tests)

    def start(self) -> "Heartbeat":
        with self._lifecycle:
            if self._thread is not None:
                return self  # already running (idempotent)
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="kcmc-heartbeat", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        warned = False
        while not self._stop.wait(self.interval_s):
            try:
                msg = self._sample()
            except Exception as e:
                if not warned:
                    warned = True
                    self._emit(f"heartbeat sampler failed ({e!r}); muting")
                continue
            if msg:
                self._emit(msg)
                self.beats += 1

    def stop(self) -> None:
        """Signal and join the thread (idempotent; bounded wait)."""
        with self._lifecycle:
            # set INSIDE the lock: a stop racing a start must not have
            # its signal cleared by the start it lost the race to
            self._stop.set()
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=self.interval_s + 5.0)

    @property
    def running(self) -> bool:
        with self._lifecycle:
            t = self._thread
        return t is not None and t.is_alive()

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def aggregate_sampler(snapshot):
    """Build a `Heartbeat` sample() over MANY live sessions.

    A single run's heartbeat narrates one progress counter; the serving
    layer has N concurrent streams plus a scheduler, so its liveness
    line aggregates: per-session frames/fps, totals, scheduler queue
    depths, and admission decisions. `snapshot()` returns a dict:

    * ``sessions`` — list of ``{"name", "frames", "fps"}`` (required;
      an empty list emits an idle line); entries may carry ``idle_s``
      (client-liveness age) and a per-session ``robustness`` counter
      dict;
    * ``queues`` — optional ``{session name: queued frames}``;
    * ``admission`` — optional counters dict (e.g. ``accepted``,
      ``degraded``, ``rejected``) — rendered only when any is nonzero;
    * ``robustness`` — optional aggregate recovery counters (retries,
      failovers, rescued frames, journal saves) — rendered only when
      any is nonzero, so a healthy plane's line stays short;
    * ``latency`` — optional end-to-end request-latency digest
      (``{"p50_ms", "p99_ms"}`` of the plane's ``request.total``
      histogram) — the liveness line's tail-latency pulse;
    * ``slo`` — optional pre-formatted SLO burn-rate line from
      the serve plane's SLO engine — rendered verbatim
      between the latency pulse and the staleness list;
    * ``stale`` — optional ``{session name: idle seconds}`` of clients
      approaching the staleness reap;
    * ``loop_beat_age_s`` — optional scheduler-loop liveness age; ages
      beyond 30 s are flagged as a WEDGE (the scheduler-queue-wedge
      watchdog's narration — heavy device batches legitimately hold
      the loop for seconds, a wedged queue holds it forever);
    * ``extra`` — optional pre-formatted string appended verbatim.

    Returns the sample callable to hand to ``Heartbeat``.
    """

    def sample() -> str:
        snap = snapshot()
        sessions = snap.get("sessions") or []
        if not sessions:
            parts = ["0 sessions (idle)"]
        else:
            total = sum(int(s.get("frames", 0)) for s in sessions)
            fps = sum(float(s.get("fps", 0.0)) for s in sessions)
            parts = [
                f"{len(sessions)} session(s), {total} frames total, "
                f"{fps:.1f} fps",
                " ".join(
                    f"{s.get('name', '?')}={int(s.get('frames', 0))}"
                    f"@{float(s.get('fps', 0.0)):.1f}fps"
                    for s in sessions
                ),
            ]
        queues = snap.get("queues")
        if queues:
            parts.append(
                "queued "
                + " ".join(f"{k}={int(v)}" for k, v in sorted(queues.items()))
            )
        admission = snap.get("admission")
        if admission and any(admission.values()):
            parts.append(
                "admission "
                + " ".join(f"{k}={v}" for k, v in sorted(admission.items()))
            )
        robustness = snap.get("robustness")
        if robustness and any(robustness.values()):
            parts.append(
                "robustness "
                + " ".join(
                    f"{k}={v}"
                    for k, v in sorted(robustness.items())
                    if v
                )
            )
        lat = snap.get("latency")
        if lat and lat.get("p99_ms") is not None:
            parts.append(
                f"latency p50={float(lat.get('p50_ms', 0.0)):.0f}ms "
                f"p99={float(lat['p99_ms']):.0f}ms"
            )
        slo = snap.get("slo")
        if slo:
            parts.append(str(slo))
        stale = snap.get("stale")
        if stale:
            parts.append(
                "stale "
                + " ".join(
                    f"{k}={float(v):.0f}s" for k, v in sorted(stale.items())
                )
            )
        beat_age = snap.get("loop_beat_age_s")
        if beat_age is not None and float(beat_age) > 30.0:
            parts.append(f"SCHEDULER WEDGED {float(beat_age):.0f}s")
        extra = snap.get("extra")
        if extra:
            parts.append(str(extra))
        return ", ".join(parts)

    return sample
