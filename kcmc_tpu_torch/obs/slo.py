"""SLO engine: declarative objectives + multi-window burn rate (the
port's copy of kcmc_tpu/obs/slo.py).

The latency histograms (obs/latency.py) already merge EXACTLY —
integer bucket counts, associative, commutative — which means "what
fraction of requests beat threshold T in window W" is computable by
*subtracting two cumulative snapshots*, with no sampling error and no
float drift. This module turns that into alerting:

* `Objective` — a declarative target parsed from the config's
  `slo_objectives` spec string. Two kinds:
  - latency: ``rung:threshold_s:fraction`` — "fraction of requests
    on this QoS rung complete under threshold_s" (measured on the
    `request.total` segment);
  - availability: ``avail:fraction`` — "fraction of submitted frames
    are served, not rejected".
  Objectives are ';'-separated: ``"full:0.25:0.99;avail:0.999"``.
* `SLOEngine` — per-window rings of (timestamp, good, total)
  cumulative snapshots. The burn rate over window W is
  ``bad_fraction(W) / error_budget`` where error_budget =
  1 - target fraction: burn 1.0 consumes the budget exactly at the
  sustainable rate, burn 14.4 exhausts a 30-day budget in 2 days.
  Windows follow the standard multi-window pattern: fast 5m/1h pages
  on sudden burn, slow 6h/3d catches slow leaks.
* Surfacing — `gauges()` becomes the `slo` section of the `metrics`
  verb (rendered as `kcmc_slo_*` in the Prometheus exposition),
  `heartbeat()` is one short line for the aggregate heartbeat, and
  `alerts()` yields page/ticket lines (both windows of a pair must
  burn — the standard AND — so a blip never pages).

The serve scheduler builds the engine when `slo_objectives` is set,
ticks it from its loop at most once a second and on every `metrics`
scrape, and puts its line on the aggregate heartbeat.

Stdlib-only; the engine never touches the scheduler's locks — it is
fed already-snapshotted histogram dicts.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_right
from collections import deque

from .latency import _EDGES_NS

# Multi-window ladder (seconds). Fast windows page, slow windows
# ticket; pairs are ANDed in `alerts()`.
WINDOWS: dict[str, float] = {
    "5m": 300.0,
    "1h": 3600.0,
    "6h": 21600.0,
    "3d": 259200.0,
}

# Burn thresholds per window pair (Google SRE workbook defaults,
# scaled to a 30-day budget): page when both fast windows burn at
# 14.4x, ticket when both slow windows burn at 1x.
PAGE_BURN = 14.4
TICKET_BURN = 1.0

_SAMPLES_PER_WINDOW = 64  # ring resolution: W/64 between snapshots

# The segment latency objectives measure: end-to-end, submit→fetched.
_LATENCY_SEGMENT = "request.total"


class Objective:
    """One declarative target. kind is "latency" (rung + threshold_s
    + target) or "availability" (target only). Latency objectives
    carry a `qos_class`: the "latency" rung IS the latency scheduling
    class (serve/session.py records latency-class streams under it),
    and every other rung — "full", "degraded", or the "batch"
    pseudo-rung that folds both — measures batch-class traffic, so
    per-class SLOs need no grammar beyond the existing rung slot."""

    __slots__ = (
        "kind", "rung", "threshold_s", "target", "name", "qos_class"
    )

    def __init__(self, kind, target, rung=None, threshold_s=None):
        self.kind = kind
        self.target = float(target)
        self.rung = rung
        self.threshold_s = threshold_s
        self.qos_class = None
        if kind == "latency":
            self.name = f"latency_{rung}_lt_{threshold_s:g}s"
            self.qos_class = "latency" if rung == "latency" else "batch"
        else:
            self.name = "availability"

    def budget(self) -> float:
        return max(1e-9, 1.0 - self.target)

    def describe(self) -> dict:
        d = {"name": self.name, "kind": self.kind, "target": self.target}
        if self.kind == "latency":
            d["rung"] = self.rung
            d["threshold_s"] = self.threshold_s
            d["qos_class"] = self.qos_class
        return d


def parse_objectives(spec: str) -> list[Objective]:
    """Parse the `slo_objectives` config spec. ';'-separated entries,
    each ``rung:threshold_s:fraction`` (latency) or
    ``avail:fraction`` (availability). Raises ValueError with the
    offending entry on malformed input — config `__post_init__`
    calls this so a bad spec fails at construction, not at alert
    time."""
    objectives: list[Objective] = []
    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = [p.strip() for p in entry.split(":")]
        try:
            if parts[0] == "avail":
                if len(parts) != 2:
                    raise ValueError
                target = float(parts[1])
                if not 0.0 < target < 1.0:
                    raise ValueError
                objectives.append(Objective("availability", target))
            else:
                if len(parts) != 3:
                    raise ValueError
                rung, threshold_s, target = (
                    parts[0], float(parts[1]), float(parts[2]),
                )
                if threshold_s <= 0 or not 0.0 < target < 1.0:
                    raise ValueError
                objectives.append(
                    Objective("latency", target, rung, threshold_s)
                )
        except (ValueError, IndexError):
            raise ValueError(
                f"malformed slo_objectives entry {entry!r} (want"
                f" 'rung:threshold_s:fraction' or 'avail:fraction')"
            ) from None
    return objectives


# The "batch" pseudo-rung: batch-class traffic spans the healthy and
# degraded rungs (a degraded stream is still batch-class work), so a
# batch-class objective folds both — exact, bucket counts are
# integers. The "latency" rung needs no fold: latency-class streams
# record under it natively.
_BATCH_FOLD = ("full", "degraded")


def _good_total_latency(hists: dict, rung: str, threshold_s: float):
    """(good, total) cumulative counts for one latency objective from
    a `plane.histograms`-shaped dict — exact, because bucket counts
    are integers and the threshold is resolved to a bucket edge. A
    request is "good" when its bucket's upper edge ≤ threshold. The
    "batch" pseudo-rung folds the full + degraded rungs (the batch
    QoS class); any concrete rung reads its own series."""
    rungs = hists.get(_LATENCY_SEGMENT) or {}
    sources = _BATCH_FOLD if rung == "batch" else (rung,)
    thr_ns = int(threshold_s * 1e9)
    k = bisect_right(_EDGES_NS, thr_ns)  # buckets [0, k) are good
    good = total = 0
    for r in sources:
        d = rungs.get(r)
        if not isinstance(d, dict):
            continue
        for idx, c in (d.get("counts") or {}).items():
            if int(idx) < k:
                good += int(c)
        total += int(d.get("count", 0))
    return good, total


def _good_total_availability(counters: dict):
    done = int(counters.get("frames_done", 0) or 0)
    rejected = int(counters.get("rejected_frames", 0) or 0)
    return done, done + rejected


class SLOEngine:
    """Multi-window burn-rate engine over cumulative (good, total)
    snapshots. `tick` is cheap (a handful of integer folds, bounded
    rings) and lock-cheap; feed it the already-exported histogram
    dicts from `metrics`/`snapshot`."""

    def __init__(self, objectives, now=None):
        if isinstance(objectives, str):
            objectives = parse_objectives(objectives)
        self.objectives: list[Objective] = list(objectives)
        self._lock = threading.Lock()
        self._now = now or time.monotonic
        t0 = self._now()
        # Per (objective, window): ring of (t, good, total). Seeded
        # with the zero state so burn is defined from the first tick.
        self._rings: dict[tuple[str, str], deque] = {}
        for obj in self.objectives:
            for w in WINDOWS:
                ring = deque(maxlen=_SAMPLES_PER_WINDOW + 2)
                ring.append((t0, 0, 0))
                self._rings[(obj.name, w)] = ring
        self._last: dict[str, tuple[int, int]] = {
            obj.name: (0, 0) for obj in self.objectives
        }

    def tick(self, hists: dict | None, counters: dict | None) -> None:
        """Fold the current cumulative state into every window ring
        (rate-limited per ring to W/64 so a 3d ring costs the same as
        a 5m ring)."""
        if not self.objectives:
            return
        hists = hists or {}
        counters = counters or {}
        t = self._now()
        with self._lock:
            for obj in self.objectives:
                if obj.kind == "latency":
                    good, total = _good_total_latency(
                        hists, obj.rung, obj.threshold_s
                    )
                else:
                    good, total = _good_total_availability(counters)
                self._last[obj.name] = (good, total)
                for w, w_s in WINDOWS.items():
                    ring = self._rings[(obj.name, w)]
                    min_dt = w_s / _SAMPLES_PER_WINDOW
                    if ring and t - ring[-1][0] < min_dt:
                        continue
                    ring.append((t, good, total))

    def burn_rates(self) -> dict:
        """``{objective: {window: burn}}``. Burn for window W is the
        bad fraction of requests in the last W seconds divided by the
        error budget; 0.0 when the window saw no traffic. The window
        delta uses the newest snapshot at least W old (or the oldest
        held), then adds everything since the last tick via the
        cumulative `_last` state — exact integer subtraction."""
        t = self._now()
        out: dict = {}
        with self._lock:
            for obj in self.objectives:
                cur_good, cur_total = self._last[obj.name]
                per_w: dict = {}
                for w, w_s in WINDOWS.items():
                    ring = self._rings[(obj.name, w)]
                    base = ring[0]
                    for sample in reversed(ring):
                        if t - sample[0] >= w_s:
                            base = sample
                            break
                    d_total = cur_total - base[2]
                    d_good = cur_good - base[1]
                    if d_total <= 0:
                        per_w[w] = 0.0
                    else:
                        bad_frac = (d_total - d_good) / d_total
                        per_w[w] = round(bad_frac / obj.budget(), 4)
                out[obj.name] = per_w
        return out

    # -- surfacing ---------------------------------------------------------

    def gauges(self) -> dict:
        """The `slo` section of the metrics payload: objectives,
        per-window burn rates, and current alert lines."""
        burns = self.burn_rates()
        return {
            "objectives": [o.describe() for o in self.objectives],
            "burn_rates": burns,
            "alerts": self._alerts(burns),
        }

    def _alerts(self, burns: dict) -> list[str]:
        alerts: list[str] = []
        for obj in self.objectives:
            b = burns.get(obj.name) or {}
            if (
                b.get("5m", 0.0) >= PAGE_BURN
                and b.get("1h", 0.0) >= PAGE_BURN
            ):
                alerts.append(
                    f"PAGE slo={obj.name} burn 5m={b['5m']:g}"
                    f" 1h={b['1h']:g} (>= {PAGE_BURN:g})"
                )
            elif (
                b.get("6h", 0.0) >= TICKET_BURN
                and b.get("3d", 0.0) >= TICKET_BURN
            ):
                alerts.append(
                    f"TICKET slo={obj.name} burn 6h={b['6h']:g}"
                    f" 3d={b['3d']:g} (>= {TICKET_BURN:g})"
                )
        return alerts

    def alerts(self) -> list[str]:
        return self._alerts(self.burn_rates())

    def heartbeat(self) -> str:
        """One short line for the aggregate heartbeat: the worst
        (fast, slow) burn across objectives."""
        burns = self.burn_rates()
        if not burns:
            return ""
        fast = max(b.get("5m", 0.0) for b in burns.values())
        slow = max(b.get("6h", 0.0) for b in burns.values())
        n_alerts = len(self._alerts(burns))
        line = f"slo burn 5m={fast:g} 6h={slow:g}"
        if n_alerts:
            line += f" ALERTS={n_alerts}"
        return line


def render_slo_prometheus(slo: dict) -> list[str]:
    """Prometheus lines for an `slo` metrics section: one
    `kcmc_slo_burn_rate` gauge per (objective, window), one
    `kcmc_slo_target` per objective, one `kcmc_slo_alerts` count.
    Returns [] for payloads without the section."""
    if not isinstance(slo, dict) or not slo.get("objectives"):
        return []
    # objective -> qos_class, for the per-class labels below (absent
    # on availability objectives — those lines
    # simply omit the label, so old scrapes keep parsing)
    classes = {
        obj.get("name"): obj.get("qos_class")
        for obj in slo.get("objectives") or []
        if isinstance(obj, dict)
    }

    def _labels(name: str, extra: str = "") -> str:
        qc = classes.get(name)
        cls = f',qos_class="{qc}"' if qc else ""
        return f'objective="{name}"{cls}{extra}'

    lines = [
        "# HELP kcmc_slo_burn_rate Error-budget burn rate per"
        " objective and window (1.0 = sustainable).",
        "# TYPE kcmc_slo_burn_rate gauge",
    ]
    burns = slo.get("burn_rates") or {}
    for name in sorted(burns):
        for w in WINDOWS:
            v = (burns[name] or {}).get(w)
            if v is None:
                continue
            window = f',window="{w}"'
            lines.append(
                f"kcmc_slo_burn_rate{{{_labels(name, window)}}}"
                f" {float(v):.9g}"
            )
    lines.append(
        "# HELP kcmc_slo_target Objective target fraction."
    )
    lines.append("# TYPE kcmc_slo_target gauge")
    for obj in slo.get("objectives") or []:
        if isinstance(obj, dict) and obj.get("name"):
            lines.append(
                f'kcmc_slo_target{{{_labels(obj["name"])}}}'
                f" {float(obj.get('target', 0.0)):.9g}"
            )
    lines.append(
        "# HELP kcmc_slo_alerts Number of currently firing SLO alerts."
    )
    lines.append("# TYPE kcmc_slo_alerts gauge")
    lines.append(f"kcmc_slo_alerts {len(slo.get('alerts') or [])}")
    return lines


__all__ = [
    "PAGE_BURN",
    "TICKET_BURN",
    "WINDOWS",
    "Objective",
    "SLOEngine",
    "parse_objectives",
    "render_slo_prometheus",
]
