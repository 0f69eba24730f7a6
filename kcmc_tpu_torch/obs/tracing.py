"""Distributed tracing: span shards and the stitched trace (the port's
copy of kcmc_tpu/obs/tracing.py).

The per-process `Tracer` (obs/trace.py) answers "where did *this
process* spend time"; a fleet of serve processes needs the
cross-process cut — "where did *this request* spend time". This module
is the substrate, stdlib only:

* **Ids** — `mint_trace_id` (128-bit) / `mint_span_id` (64-bit), hex
  strings from `os.urandom`, so concurrent sessions and threads never
  collide (no shared counter, no lock).
* **Context** — ``{"trace_id", "span_id"}`` where `span_id` is the
  sender's span, i.e. the parent of whatever the receiver records.
  `child_context` advances the tree one hop.
* **Span shards** — each process appends finished spans to a bounded
  JSONL shard (`SpanShard`), torn-tail tolerant exactly like
  `obs/records.py`: a header line, one JSON object per span, and a
  reader (`read_span_shard`) that yields only complete spans even
  after kill -9 mid-write. A bounded in-memory ring keeps the newest.
* **Collection** — `collect_spans` merges shards (files, dirs, or
  already-loaded lists); `stitch` groups them into per-trace causal
  trees; `critical_path` names the dominant lifecycle segment of each
  request; `chrome_trace` exports a stitched multi-process Chrome
  trace (wall-clock timestamps, one pid row per producing process).
* **Exemplars** — `ExemplarStore` attaches real trace ids to the
  latency histogram buckets (bounded, last-wins per bucket) without
  touching `LatencyHistogram.to_dict`, whose exact merge is the
  fleet aggregator's contract.

`obs/report.py` reads shards through `collect_spans`, `stitch` and
`critical_path`; the serve plane's scheduler, server and client
(serve/, with `trace_shard_dir` set) write the shards. Span names recorded here are literals from
`obs/registry.py`.
"""

from __future__ import annotations

import json
import os
import socket
import threading
from bisect import bisect_left
from collections import deque

from .latency import _EDGES_NS, DEFAULT_RUNG

SHARD_KIND = "kcmc_span_shard"
SHARD_VERSION = 1

# Default bound on spans kept per process (ring + file). A request
# emits ~1 span per hop plus ~5 per batch, so 4096 covers hundreds of
# requests; older spans age out of the ring, later spans are dropped
# from the file (counted, never torn).
DEFAULT_SHARD_CAP = 4096

# The per-request lifecycle segments a critical path is computed over
# (request.total excluded: it IS the whole path, not a part of it).
_PATH_SEGMENTS = (
    "request.admission",
    "request.queue_wait",
    "request.batch_form",
    "request.dispatch",
    "request.device",
    "request.drain",
    "request.delivery",
    "fleet.migrate",
)


# -- id minting --------------------------------------------------------------


def mint_trace_id() -> str:
    """128-bit trace id as 32 lowercase hex chars (W3C-width)."""
    return os.urandom(16).hex()


def mint_span_id() -> str:
    """64-bit span id as 16 lowercase hex chars."""
    return os.urandom(8).hex()


def new_context() -> dict:
    """Root context a client mints per call: fresh trace, root span."""
    return {"trace_id": mint_trace_id(), "span_id": mint_span_id()}


def child_context(parent: dict | None) -> dict | None:
    """Advance the causal tree one hop: same trace, fresh span id,
    the parent's span id preserved as `parent_id`. None in, None out
    (untraced callers stay untraced)."""
    if not parent or not parent.get("trace_id"):
        return None
    return {
        "trace_id": str(parent["trace_id"]),
        "span_id": mint_span_id(),
        "parent_id": str(parent.get("span_id") or ""),
    }


def valid_context(trace) -> dict | None:
    """Validate a wire-side `trace` field: a dict with a non-empty
    string trace_id, or None. Garbage never propagates."""
    if not isinstance(trace, dict):
        return None
    tid = trace.get("trace_id")
    if not isinstance(tid, str) or not tid:
        return None
    out = {"trace_id": tid}
    for k in ("span_id", "parent_id"):
        v = trace.get(k)
        if isinstance(v, str) and v:
            out[k] = v
    return out


# -- span shard (bounded, torn-tail-tolerant JSONL) --------------------------


class SpanShard:
    """Bounded per-process span sink: an in-memory ring (the live
    `trace` verb's source) plus an optional append-only JSONL file
    (the collector's source). Thread-safe; every line is one complete
    JSON object flushed whole, so a kill -9 tears at most the final
    line and `read_span_shard` recovers everything before it.
    """

    def __init__(self, path: str | None = None, cap: int = DEFAULT_SHARD_CAP):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(cap)))
        self._cap = max(1, int(cap))
        self._written = 0
        self.dropped = 0
        self._path = path
        self._fh = None
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(path, "a", encoding="utf-8")
            if self._fh.tell() == 0:
                header = {
                    "kind": SHARD_KIND,
                    "version": SHARD_VERSION,
                    "pid": os.getpid(),
                    "host": socket.gethostname(),
                }
                self._fh.write(
                    json.dumps(header, allow_nan=False) + "\n"
                )
                self._fh.flush()

    @property
    def path(self) -> str | None:
        return self._path

    # The emitter is named `complete` on purpose: it is the same
    # registry-checked emitter vocabulary as Tracer.complete, so the
    # span-registry pass verifies every literal span name used here.
    def complete(
        self,
        name: str,
        t0: float,
        dur_s: float,
        *,
        trace_id: str | None = None,
        span_id: str | None = None,
        parent_id: str | None = None,
        args: dict | None = None,
    ) -> None:
        """Record one finished span. `t0` is wall-clock epoch seconds
        (time.time) so shards from different processes stitch."""
        span = {
            "name": name,
            "t0": round(float(t0), 6),
            "dur_s": round(float(dur_s), 6),
            "trace_id": trace_id,
            "span_id": span_id or mint_span_id(),
            "parent_id": parent_id,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if args:
            span["args"] = args
        with self._lock:
            self._ring.append(span)
            if self._fh is not None:
                if self._written < self._cap:
                    try:
                        self._fh.write(
                            json.dumps(span, allow_nan=False) + "\n"
                        )
                        self._fh.flush()
                        self._written += 1
                    except (OSError, ValueError):
                        pass  # a full disk must never fail serving
                else:
                    self.dropped += 1

    # Registry-checked counter emitter (same contract as `complete`):
    # a zero-duration span carrying an increment, so counter series —
    # the dispatch-`why` vocabulary — ride the shard and the span-
    # registry pass verifies every literal name used here.
    def counter(
        self,
        name: str,
        t0: float,
        n: int = 1,
        *,
        trace_id: str | None = None,
        args: dict | None = None,
    ) -> None:
        """Record one counter increment as a zero-duration span."""
        self.complete(
            name,
            t0,
            0.0,
            trace_id=trace_id,
            args={**(args or {}), "n": int(n)},
        )

    def tail(self, n: int | None = None) -> list[dict]:
        """Most recent spans from the in-memory ring (newest last)."""
        with self._lock:
            spans = list(self._ring)
        return spans if n is None else spans[-n:]

    def close(self) -> None:
        with self._lock:
            fh, self._fh = self._fh, None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass


def read_span_shard(path: str) -> list[dict]:
    """Read one span shard, tolerating a torn tail: yields only
    complete span lines. Raises ValueError only when the header (line
    0) is unparseable — same contract as `obs/records.read_jsonl`."""
    spans: list[dict] = []
    with open(path, "r", encoding="utf-8") as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                if i == 0:
                    raise ValueError(
                        f"{path}: not a span shard (unparseable header)"
                    )
                continue  # torn tail / partial write: skip
            if not isinstance(obj, dict):
                continue
            if obj.get("kind"):
                continue  # header / metadata lines
            if "name" in obj and "dur_s" in obj:
                spans.append(obj)
    return spans


# -- collection / stitching --------------------------------------------------


def collect_spans(sources) -> list[dict]:
    """Merge spans from shard files, directories of shards (every
    ``*.jsonl`` inside), or already-loaded span lists."""
    spans: list[dict] = []
    for src in sources:
        if isinstance(src, list):
            spans.extend(s for s in src if isinstance(s, dict))
        elif os.path.isdir(src):
            for fn in sorted(os.listdir(src)):
                if fn.endswith(".jsonl"):
                    spans.extend(read_span_shard(os.path.join(src, fn)))
        else:
            spans.extend(read_span_shard(src))
    return spans


def stitch(spans) -> dict[str, list[dict]]:
    """Group spans into per-trace causal trees:
    ``{trace_id: [spans sorted by t0]}``. Untraced spans (no
    trace_id) are dropped — they belong to no request."""
    traces: dict[str, list[dict]] = {}
    for s in spans:
        tid = s.get("trace_id")
        if tid:
            traces.setdefault(tid, []).append(s)
    for tid in traces:
        traces[tid].sort(key=lambda s: (s.get("t0") or 0.0))
    return traces


def _span_weight(s: dict) -> float:
    """A span's total contribution: batch-level spans carry
    args={"n": frames}, matching SegmentLatencies.observe(n=...) so
    span sums telescope exactly against the histogram sums."""
    n = 1
    args = s.get("args")
    if isinstance(args, dict):
        try:
            n = max(1, int(args.get("n", 1)))
        except (TypeError, ValueError):
            n = 1
    return float(s.get("dur_s") or 0.0) * n


def critical_path(trace_spans) -> dict:
    """Per-request attribution: summed duration per lifecycle
    segment, the dominant one, and the end-to-end total. Device vs
    queue vs migration in one dict."""
    by_seg: dict[str, float] = {}
    total = 0.0
    for s in trace_spans:
        name = s.get("name")
        if name in _PATH_SEGMENTS:
            by_seg[name] = by_seg.get(name, 0.0) + _span_weight(s)
        elif name == "request.total":
            total += _span_weight(s)
    dominant = max(by_seg, key=by_seg.get) if by_seg else None
    if total <= 0.0:
        total = sum(by_seg.values())
    return {"segments": by_seg, "dominant": dominant, "total_s": total}


def slowest(traces: dict[str, list[dict]], n: int = 10) -> list[dict]:
    """Slowest-N requests: ``[{"trace_id", "total_s", "dominant",
    "n_spans"}]`` sorted slowest first."""
    rows = []
    for tid, spans in traces.items():
        cp = critical_path(spans)
        rows.append(
            {
                "trace_id": tid,
                "total_s": cp["total_s"],
                "dominant": cp["dominant"],
                "n_spans": len(spans),
            }
        )
    rows.sort(key=lambda r: -r["total_s"])
    return rows[: max(0, int(n))]


def chrome_trace(spans) -> dict:
    """Stitched multi-process Chrome trace: wall-clock microsecond
    timestamps, the producing process as the pid row, span/trace ids
    in args. Loadable in Perfetto / chrome://tracing."""
    events: list[dict] = []
    pids = set()
    for s in spans:
        pid = int(s.get("pid") or 0)
        pids.add(pid)
        args = dict(s.get("args") or {})
        for k in ("trace_id", "span_id", "parent_id"):
            if s.get(k):
                args[k] = s[k]
        events.append(
            {
                "name": s.get("name"),
                "ph": "X",
                "ts": float(s.get("t0") or 0.0) * 1e6,
                "dur": float(s.get("dur_s") or 0.0) * 1e6,
                "pid": pid,
                "tid": int(s.get("tid") or 0),
                "cat": "trace",
                "args": args,
            }
        )
    for pid in sorted(pids):
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "ts": 0,
                "dur": 0,
                "pid": pid,
                "tid": 0,
                "args": {"name": f"kcmc pid {pid}"},
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- exemplars ---------------------------------------------------------------


class ExemplarStore:
    """Bounded last-wins exemplar map: (segment, rung, bucket) →
    {"trace_id", "value_s"}. Lives BESIDE the latency histograms —
    never inside `LatencyHistogram.to_dict`, whose bit-identity is
    the fleet merge contract. Export shape:
    ``{segment: {rung: {bucket_index: {"trace_id", "value_s"}}}}``.
    """

    def __init__(self, cap: int = 256):
        self._lock = threading.Lock()
        self._cap = max(1, int(cap))
        self._by_key: dict[tuple[str, str, int], dict] = {}

    def note(
        self,
        segment: str,
        seconds: float,
        trace_id: str | None,
        rung: str = DEFAULT_RUNG,
    ) -> None:
        """O(1): bucket the observation exactly as LatencyHistogram
        does, then last-wins overwrite. No-op without a trace id."""
        if not trace_id:
            return
        ns = int(seconds * 1e9)
        if ns < 0:
            ns = 0
        idx = bisect_left(_EDGES_NS, ns)
        key = (segment, rung, idx)
        with self._lock:
            if key not in self._by_key and len(self._by_key) >= self._cap:
                # bounded: evict the oldest-inserted entry
                self._by_key.pop(next(iter(self._by_key)))
            self._by_key[key] = {
                "trace_id": trace_id,
                "value_s": round(seconds, 6),
            }

    def export(self) -> dict:
        with self._lock:
            items = list(self._by_key.items())
        out: dict = {}
        for (seg, rung, idx), ex in items:
            out.setdefault(seg, {}).setdefault(rung, {})[str(idx)] = dict(ex)
        return out

    @staticmethod
    def merge_exports(exports) -> dict:
        """Fold exemplar exports last-wins (iteration order wins) —
        the fleet aggregator's exemplar counterpart to the exact
        histogram merge."""
        out: dict = {}
        for exp in exports:
            if not isinstance(exp, dict):
                continue
            for seg, rungs in exp.items():
                if not isinstance(rungs, dict):
                    continue
                for rung, buckets in rungs.items():
                    if not isinstance(buckets, dict):
                        continue
                    dst = out.setdefault(seg, {}).setdefault(rung, {})
                    for idx, ex in buckets.items():
                        if isinstance(ex, dict) and ex.get("trace_id"):
                            dst[str(idx)] = dict(ex)
        return out


def top_exemplar(exemplars: dict, segment: str) -> dict | None:
    """The exemplar from the highest populated bucket of a segment
    (any rung) — the one living next to p99 on a top dashboard."""
    best_idx, best = -1, None
    rungs = exemplars.get(segment) or {}
    if not isinstance(rungs, dict):
        return None
    for buckets in rungs.values():
        if not isinstance(buckets, dict):
            continue
        for idx, ex in buckets.items():
            try:
                i = int(idx)
            except (TypeError, ValueError):
                continue
            if i > best_idx and isinstance(ex, dict) and ex.get("trace_id"):
                best_idx, best = i, ex
    return best


__all__ = [
    "DEFAULT_SHARD_CAP",
    "ExemplarStore",
    "SpanShard",
    "child_context",
    "chrome_trace",
    "collect_spans",
    "critical_path",
    "mint_span_id",
    "mint_trace_id",
    "new_context",
    "read_span_shard",
    "slowest",
    "stitch",
    "top_exemplar",
    "valid_context",
]
