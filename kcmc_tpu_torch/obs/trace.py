"""Thread-aware span tracing with Chrome trace-event JSON export.

`Tracer` collects *complete* duration events ("ph": "X"), instants, and
counters from every thread of a run — the consumer thread's stage/stall
spans (`StageTimer` emits into an attached tracer), the dispatch seam's
per-batch spans, and the background writer thread's per-batch
encode+write spans — and exports the Chrome trace-event format that
`chrome://tracing` and Perfetto (ui.perfetto.dev) load directly.

Cost model: a disabled run carries no tracer at all (`timer.tracer is
None` is the only check on the hot path); an enabled run pays one
`time.perf_counter()` pair and one small dict append per span, behind
one lock (spans are tens-per-batch, not per-pixel).

Every exported event carries ``name``/``ph``/``ts``/``dur``/``pid``/
``tid`` (``dur`` is 0 for non-duration phases) — the invariant the
golden-schema tests pin. Timestamps are microseconds since tracer
construction.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time


class Tracer:
    """Collect spans across threads; export Chrome trace-event JSON."""

    def __init__(self, metadata: dict | None = None):
        self._t0 = time.perf_counter()
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._thread_names: dict[int, str] = {}
        self.metadata: dict = dict(metadata or {})

    # -- recording ---------------------------------------------------------

    def _append(self, ev: dict) -> None:
        tid = threading.get_ident()
        tname = threading.current_thread().name
        ev["pid"] = self._pid
        ev["tid"] = tid
        with self._lock:
            # thread-name registration shares the event lock — it is
            # already being taken, and the export-side iteration must
            # not race a first-sighting insert
            if tid not in self._thread_names:
                self._thread_names[tid] = tname
            self._events.append(ev)

    def complete(
        self,
        name: str,
        t0: float,
        dur_s: float,
        cat: str = "stage",
        args: dict | None = None,
        trace_id: str | None = None,
        span_id: str | None = None,
        parent_id: str | None = None,
    ) -> None:
        """Record a finished span: `t0` is its start as a
        `time.perf_counter()` value, `dur_s` its duration in seconds.
        Distributed-trace identity (`trace_id`/`span_id`/`parent_id`,
        obs/tracing.py) rides in `args` so Perfetto shows which fleet
        request a process-local span served — the golden event schema
        (name/ph/ts/dur/pid/tid) is untouched."""
        ev = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": (t0 - self._t0) * 1e6,
            "dur": dur_s * 1e6,
        }
        if trace_id or span_id or parent_id:
            args = dict(args or {})
            for k, v in (
                ("trace_id", trace_id),
                ("span_id", span_id),
                ("parent_id", parent_id),
            ):
                if v:
                    args[k] = v
        if args:
            ev["args"] = args
        self._append(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "stage", args: dict | None = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.complete(
                name, t0, time.perf_counter() - t0, cat=cat, args=args
            )

    def instant(self, name: str, cat: str = "event", args: dict | None = None):
        """A zero-duration marker (checkpoint saves, escalation flips)."""
        ev = {
            "name": name,
            "cat": cat,
            "ph": "i",
            "s": "t",  # thread-scoped instant
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "dur": 0,
        }
        if args:
            ev["args"] = args
        self._append(ev)

    def counter(self, name: str, values: dict) -> None:
        """A counter sample (e.g. frames_done over time); `values` maps
        series name -> number."""
        self._append(
            {
                "name": name,
                "cat": "counter",
                "ph": "C",
                "ts": (time.perf_counter() - self._t0) * 1e6,
                "dur": 0,
                "args": {k: float(v) for k, v in values.items()},
            }
        )

    # -- export ------------------------------------------------------------

    def events(self) -> list[dict]:
        """Snapshot of recorded events plus per-thread name metadata."""
        with self._lock:
            evs = list(self._events)
            names = sorted(self._thread_names.items())
        for tid, tname in names:
            evs.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "ts": 0,
                    "dur": 0,
                    "pid": self._pid,
                    "tid": tid,
                    "args": {"name": tname},
                }
            )
        return evs

    def to_json(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "metadata": self.metadata,
        }

    def write(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_json(), f)
            f.write("\n")
