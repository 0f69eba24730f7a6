"""Request-latency telemetry: mergeable log-bucket histograms (the
port's copy of `LatencyHistogram`, `merge_histograms`, `RequestClock`,
`SegmentLatencies` and `render_prometheus` from
kcmc_tpu/obs/latency.py).

`LatencyHistogram` is a fixed log-scale-bucket histogram: bucket edges
are a deterministic integer-nanosecond geometric ladder (2^(1/4)
spacing from 1 µs to ~134 s), recording is O(1) (one bisect and three
integer adds), and two histograms with the same scheme merge EXACTLY
(integer counts, integer nanosecond sums) — associative and
commutative, across threads and processes. The object store's per-URL
read state keeps one (io/objectstore.py), and hedged reads fire past
its live p95.

Quantiles are estimated at the geometric midpoint of the covering
bucket: with 2^(1/4) ≈ 1.19 bucket spacing the relative error of any
reported percentile is bounded by 2^(1/8) - 1 ≈ 9%.

`SegmentLatencies` is a thread-safe recorder keyed by (lifecycle
segment, QoS rung): every serve session records the whole request
lifecycle into one (admission, queue wait, batch forming, dispatch,
device, drain, delivery and the end-to-end `request.total`, each batch
carried by a `RequestClock`), and a one-shot run with telemetry armed
records the `request.dispatch` / `request.device` / `request.drain`
subset (corrector._dispatch_batches), which `RunTelemetry.finish`
reports as `timing["latency"]`.
`render_prometheus` turns a dumped `metrics` payload into Prometheus
text (`python -m kcmc_tpu_torch metrics FILE --text`).

Stdlib only: decode-pool workers that open object-store sources import
it without torch.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from math import ceil, sqrt

# -- bucket scheme ---------------------------------------------------------
#
# Upper bucket edges in integer nanoseconds: T0 * 2^(i / PER_OCTAVE),
# rounded — a pure function of the index, so every process computes the
# identical ladder and cross-process merges line up bucket for bucket.
# 1 µs resolution floor; 27 octaves tops out at ~134 s (a request
# slower than that is a wedge, not a latency).
T0_NS = 1_000
PER_OCTAVE = 4
N_OCTAVES = 27

_EDGES_NS: tuple[int, ...] = tuple(
    round(T0_NS * 2.0 ** (i / PER_OCTAVE))
    for i in range(N_OCTAVES * PER_OCTAVE + 1)
)
_N_BUCKETS = len(_EDGES_NS) + 1  # + overflow

_SCHEME = {"t0_ns": T0_NS, "per_octave": PER_OCTAVE, "octaves": N_OCTAVES}

# The QoS rung a record lands under when the caller doesn't say:
# dispatches at full consensus budgets.
DEFAULT_RUNG = "full"


class LatencyHistogram:
    """Fixed log-bucket histogram of durations (seconds in, exact
    integer-nanosecond state inside).

    NOT internally locked: a single owner thread may record freely;
    concurrent producers hold their own lock around it (the object
    store's per-URL state does). All state is integers, so `merge` is
    exact — associative, commutative, order-independent.
    """

    __slots__ = ("counts", "count", "sum_ns", "max_ns")

    def __init__(self):
        self.counts = [0] * _N_BUCKETS
        self.count = 0
        self.sum_ns = 0
        self.max_ns = 0

    # -- recording ---------------------------------------------------------

    def record(self, seconds: float, n: int = 1) -> None:
        """O(1): one bisect over the precomputed integer edges plus
        integer adds. `n` records the same duration n times (a batch
        of frames sharing one measured seam)."""
        ns = int(seconds * 1e9)
        if ns < 0:
            ns = 0
        idx = bisect_left(_EDGES_NS, ns)
        self.counts[idx] += n
        self.count += n
        self.sum_ns += ns * n
        if ns > self.max_ns:
            self.max_ns = ns

    # -- merge (exact) -----------------------------------------------------

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold `other` into self (exact integer addition); returns
        self. Histograms always share the module's fixed scheme, so
        any two merge."""
        sc, oc = self.counts, other.counts
        for i, c in enumerate(oc):
            if c:
                sc[i] += c
        self.count += other.count
        self.sum_ns += other.sum_ns
        if other.max_ns > self.max_ns:
            self.max_ns = other.max_ns
        return self

    def clone(self) -> "LatencyHistogram":
        h = LatencyHistogram()
        h.counts = list(self.counts)
        h.count = self.count
        h.sum_ns = self.sum_ns
        h.max_ns = self.max_ns
        return h

    # -- quantiles ---------------------------------------------------------

    def quantile(self, q: float) -> float | None:
        """Estimated q-quantile (q in [0, 100]) in seconds: geometric
        midpoint of the covering bucket, clamped to the observed max —
        relative error bounded by the bucket ratio (≈9%). None when
        empty."""
        if self.count <= 0:
            return None
        rank = max(1, ceil(q / 100.0 * self.count))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                est = self._bucket_value_ns(i)
                return min(est, self.max_ns) / 1e9
        return self.max_ns / 1e9  # unreachable; defensive

    @staticmethod
    def _bucket_value_ns(i: int) -> float:
        if i == 0:
            return _EDGES_NS[0] / 2.0
        if i >= len(_EDGES_NS):
            return float(_EDGES_NS[-1])
        return sqrt(float(_EDGES_NS[i - 1]) * float(_EDGES_NS[i]))

    # -- export ------------------------------------------------------------

    def summary(self) -> dict:
        """The reference's per-histogram schema: count / sum_s /
        p50_s / p90_s / p99_s / max_s."""

        def _r(v):
            return None if v is None else round(v, 6)

        return {
            "count": int(self.count),
            "sum_s": round(self.sum_ns / 1e9, 6),
            "p50_s": _r(self.quantile(50)),
            "p90_s": _r(self.quantile(90)),
            "p99_s": _r(self.quantile(99)),
            "max_s": round(self.max_ns / 1e9, 6),
        }

    def to_dict(self) -> dict:
        """JSON state: sparse bucket counts + integer sums. Two
        histograms fed the same samples in any split produce the SAME
        dict — the bit-identity contract a cross-process merge needs."""
        return {
            "scheme": dict(_SCHEME),
            "counts": {
                str(i): c for i, c in enumerate(self.counts) if c
            },
            "count": int(self.count),
            "sum_ns": int(self.sum_ns),
            "max_ns": int(self.max_ns),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LatencyHistogram":
        if d.get("scheme") != _SCHEME:
            raise ValueError(
                f"incompatible latency-histogram scheme {d.get('scheme')!r}"
                f" (this build uses {_SCHEME})"
            )
        h = cls()
        for k, c in (d.get("counts") or {}).items():
            h.counts[int(k)] = int(c)
        h.count = int(d.get("count", 0))
        h.sum_ns = int(d.get("sum_ns", 0))
        h.max_ns = int(d.get("max_ns", 0))
        return h


def merge_histograms(*hists: LatencyHistogram) -> LatencyHistogram:
    """Pure merge of any number of histograms (exact; empty in, empty
    out)."""
    out = LatencyHistogram()
    for h in hists:
        out.merge(h)
    return out


class RequestClock:
    """Per-batch lifecycle timestamps the serve scheduler threads from
    `take_batch` through dispatch to drain. `t_submit` holds each
    frame's submit-entry `perf_counter()` stamp (the anchor of
    `request.total`); the remaining fields are batch-level."""

    __slots__ = (
        "t_submit", "t_formed", "t_dispatched", "t_host", "rung", "trace",
    )

    def __init__(self, t_submit, t_formed: float, trace: dict | None = None):
        self.t_submit = t_submit
        self.t_formed = t_formed
        self.t_dispatched: float | None = None
        self.t_host: float | None = None
        self.rung: str = DEFAULT_RUNG
        # the distributed-trace context of the batch's requests
        # (obs/tracing.py): device spans and exemplars name its trace id
        self.trace = trace


class SegmentLatencies:
    """Thread-safe latency recorder keyed by (segment, QoS rung).

    One lock guards the key map and every record — records are
    tens-per-batch integer adds, never per-pixel. Segment names at
    `observe` call sites are literals from `obs/registry.py`.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: dict[tuple[str, str], LatencyHistogram] = {}

    def observe(
        self, segment: str, seconds: float, n: int = 1,
        rung: str = DEFAULT_RUNG,
    ) -> None:
        key = (segment, rung)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = LatencyHistogram()
            h.record(seconds, n=n)

    @property
    def count(self) -> int:
        with self._lock:
            return sum(h.count for h in self._hists.values())

    # -- merge / snapshot --------------------------------------------------

    def _snapshot(self) -> dict[tuple[str, str], LatencyHistogram]:
        with self._lock:
            return {k: h.clone() for k, h in self._hists.items()}

    def merge_from(self, other: "SegmentLatencies") -> "SegmentLatencies":
        """Fold `other`'s histograms into self, exactly. Snapshots
        `other` under its own lock first, so the two locks are never
        held together."""
        snap = other._snapshot()
        with self._lock:
            for key, h in snap.items():
                mine = self._hists.get(key)
                if mine is None:
                    self._hists[key] = h
                else:
                    mine.merge(h)
        return self

    def segment_total(self, segment: str) -> LatencyHistogram:
        """All rungs of one segment merged (exact)."""
        with self._lock:
            hists = [
                h.clone()
                for (seg, _), h in self._hists.items()
                if seg == segment
            ]
        return merge_histograms(*hists)

    # -- export ------------------------------------------------------------

    def report(self) -> dict:
        """The shared latency-section schema:
        ``{"segments": {segment: {rung: summary}},
        "totals": {segment: summary}}`` — `totals` merges a segment's
        rungs. Deterministically ordered."""
        snap = self._snapshot()
        segments: dict = {}
        totals: dict[str, LatencyHistogram] = {}
        for (seg, rung) in sorted(snap):
            h = snap[(seg, rung)]
            segments.setdefault(seg, {})[rung] = h.summary()
            t = totals.get(seg)
            totals[seg] = h.clone() if t is None else t.merge(h)
        return {
            "segments": segments,
            "totals": {seg: totals[seg].summary() for seg in sorted(totals)},
        }

    def hist_dicts(self) -> dict:
        """Full bucket state per (segment, rung) —
        ``{segment: {rung: LatencyHistogram.to_dict()}}`` — the
        exact-merge transport."""
        snap = self._snapshot()
        out: dict = {}
        for (seg, rung) in sorted(snap):
            out.setdefault(seg, {})[rung] = snap[(seg, rung)].to_dict()
        return out


# -- Prometheus text exposition --------------------------------------------


def _prom_escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n"
    )


def _fmt_le(ns: int) -> str:
    return f"{ns / 1e9:.9g}"


def render_prometheus(metrics: dict) -> str:
    """Prometheus text exposition (version 0.0.4) of a `metrics` verb
    payload: request-latency histograms (cumulative buckets + sum +
    count per segment/rung), serve counters, serve gauges, SLO burn
    gauges, and — when the payload carries an `exemplars` section —
    OpenMetrics ``# {trace_id=...}`` exemplar suffixes on the matching
    bucket lines. Works on a dumped snapshot — pure dict in, text out,
    the reference's text byte for byte. Every `# TYPE` line has a
    matching `# HELP` line."""
    lines: list[str] = []

    exemplars = metrics.get("exemplars") or {}
    hists = (metrics.get("plane") or {}).get("histograms") or {}
    if hists:
        lines.append(
            "# HELP kcmc_request_latency_seconds Per-request lifecycle"
            " segment latency (log-bucket histogram)."
        )
        lines.append("# TYPE kcmc_request_latency_seconds histogram")
        for seg in sorted(hists):
            for rung in sorted(hists[seg]):
                d = hists[seg][rung]
                labels = (
                    f'segment="{_prom_escape(seg)}",'
                    f'rung="{_prom_escape(rung)}"'
                )
                counts = [0] * _N_BUCKETS
                for k, c in (d.get("counts") or {}).items():
                    counts[int(k)] = int(c)
                total = int(d.get("count", 0))
                acc = 0
                seg_ex = (exemplars.get(seg) or {}).get(rung) or {}
                for i, edge in enumerate(_EDGES_NS):
                    acc += counts[i]
                    # render populated prefixes only (a subset of le's
                    # plus +Inf is valid exposition); stop once the
                    # cumulative count is complete
                    if counts[i]:
                        line = (
                            "kcmc_request_latency_seconds_bucket"
                            f'{{{labels},le="{_fmt_le(edge)}"}} {acc}'
                        )
                        ex = seg_ex.get(str(i))
                        if isinstance(ex, dict) and ex.get("trace_id"):
                            line += (
                                " # {trace_id=\""
                                f"{_prom_escape(ex['trace_id'])}\"}} "
                                f"{float(ex.get('value_s', 0.0)):.9g}"
                            )
                        lines.append(line)
                    if acc >= total - counts[-1]:
                        break
                lines.append(
                    "kcmc_request_latency_seconds_bucket"
                    f'{{{labels},le="+Inf"}} {total}'
                )
                lines.append(
                    "kcmc_request_latency_seconds_sum"
                    f"{{{labels}}} {int(d.get('sum_ns', 0)) / 1e9:.9g}"
                )
                lines.append(
                    "kcmc_request_latency_seconds_count"
                    f"{{{labels}}} {total}"
                )

    for name, value in sorted((metrics.get("counters") or {}).items()):
        metric = f"kcmc_serve_{name}_total"
        lines.append(f"# HELP {metric} Serve counter `{name}`.")
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {int(value)}")

    gauges = dict(metrics.get("gauges") or {})
    queues = gauges.pop("queues", None)
    for name, value in sorted(gauges.items()):
        metric = f"kcmc_serve_{name}"
        lines.append(f"# HELP {metric} Serve gauge `{name}`.")
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {float(value):.9g}")
    if queues:
        lines.append(
            "# HELP kcmc_serve_queue_frames Undispatched frames"
            " queued per open session."
        )
        lines.append("# TYPE kcmc_serve_queue_frames gauge")
        for sid in sorted(queues):
            lines.append(
                "kcmc_serve_queue_frames"
                f'{{session="{_prom_escape(sid)}"}} {int(queues[sid])}'
            )

    slo = metrics.get("slo")
    if slo:
        from .slo import render_slo_prometheus  # lazy: slo imports this module

        lines.extend(render_slo_prometheus(slo))
    return "\n".join(lines) + "\n"

