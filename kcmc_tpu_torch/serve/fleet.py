"""Fleet plane: replica handles, the health state machine, placement, and
the fleet-wide metrics rollup (the port's copy of kcmc_tpu/serve/fleet.py;
docs/SERVING.md "Running a fleet").

The single-replica serve plane (server.py/scheduler.py) already
survives its own failures — durable journals, supervised backends,
idempotent reconnect. This module holds the *horizontal* primitives
the `python -m kcmc_tpu_torch router` front door composes over N such
replicas:

* **Replica** — one `serve` process the router knows about: its
  address, its (optional, router-owned) subprocess, the last scraped
  `metrics`/`stats` payloads, and its health state.
* **ReplicaHealth** — the HEALTHY -> SUSPECT -> DEAD state machine
  with hysteresis (docs/ROBUSTNESS.md "Fleet failures"): bad probes
  demote, a run of good probes is required to promote back, and only
  HARD evidence (unreachable, wedged, or a lost CUDA context — never a
  soft supervisor signal) advances SUSPECT to DEAD.
* **rendezvous placement** (`place`/`rank`) — highest-random-weight
  hashing of session keys over the placeable replica set, with the
  reference's hash, so a fleet mixing both packages' routers places a
  key the same way.
* **merge_fleet_metrics** — folds N replicas' `metrics` payloads (plus
  the router's own spans) into one schema-compatible payload through
  the exact-merge histogram contract, so `top` pointed at a router —
  or at several replicas — renders the fleet as if it were one plane.
* **spawn_replica** — warm-boot one serve replica as a subprocess and
  parse its ready record; the autoscaler's scale-up primitive.

Everything here is host code that imports no torch; the replicas
`spawn_replica` starts run on the device the caller named (`device=`,
the top-level `--device` of the CLI).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

from kcmc_tpu_torch.obs.latency import LatencyHistogram

# Health states. DRAINING is an administrative state (autoscaler
# scale-down / operator drain): excluded from placement like SUSPECT,
# but reached by choice, not evidence.
HEALTHY = "HEALTHY"
SUSPECT = "SUSPECT"
DEAD = "DEAD"
DRAINING = "DRAINING"


class ReplicaHealth:
    """Per-replica probe evidence accumulator with hysteresis.

    `observe(ok, hard=...)` folds one probe in and returns the state.
    Demotion: `suspect_probes` consecutive bad probes (hard or soft)
    take HEALTHY to SUSPECT; `dead_probes` consecutive HARD-bad probes
    take SUSPECT to DEAD (soft signals — a backend rebuild in
    progress — can suspend placement but never kill a replica).
    Promotion needs the same run length in reverse: `suspect_probes`
    consecutive good probes take SUSPECT back to HEALTHY, so one lucky
    scrape of a flapping replica doesn't resume placement. DEAD is
    sticky — a returned process registers as a NEW replica.
    """

    def __init__(self, suspect_probes: int = 2, dead_probes: int = 4):
        self.suspect_probes = max(int(suspect_probes), 1)
        self.dead_probes = max(int(dead_probes), self.suspect_probes)
        self.state = HEALTHY
        self.bad = 0  # consecutive bad probes (hard or soft)
        self.hard_bad = 0  # consecutive hard-bad probes
        self.good = 0  # consecutive good probes
        self.probes = 0

    def observe(self, ok: bool, hard: bool = True) -> str:
        self.probes += 1
        if self.state == DEAD:
            return self.state  # sticky
        if ok:
            self.good += 1
            self.bad = self.hard_bad = 0
            if self.state == SUSPECT and self.good >= self.suspect_probes:
                self.state = HEALTHY
        else:
            self.bad += 1
            self.good = 0
            self.hard_bad = self.hard_bad + 1 if hard else 0
            if self.state == HEALTHY and self.bad >= self.suspect_probes:
                self.state = SUSPECT
            if (
                self.state in (SUSPECT, DRAINING)
                and self.hard_bad >= self.dead_probes
            ):
                self.state = DEAD
        return self.state

    def kill(self) -> str:
        """Direct evidence of death (the spawned process exited):
        skip the probe ladder."""
        self.state = DEAD
        return self.state


class Replica:
    """One serve replica the router fans out to.

    `proc` is non-None only for router-owned (spawned) replicas — the
    autoscaler may SIGTERM those; externally managed replicas are
    probed and routed to but never signalled. `last_metrics` /
    `last_stats` are the most recent successful scrape payloads (the
    rollup, admission, and buffer-pruning inputs); they are replaced
    whole by the prober, never mutated in place."""

    def __init__(
        self,
        host: str,
        port: int,
        proc: subprocess.Popen | None = None,
        ready: dict | None = None,
        suspect_probes: int = 2,
        dead_probes: int = 4,
    ):
        self.host = str(host)
        self.port = int(port)
        self.proc = proc
        self.ready = dict(ready or {})
        self.health = ReplicaHealth(suspect_probes, dead_probes)
        self.last_metrics: dict | None = None
        self.last_stats: dict | None = None

    @property
    def rid(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def state(self) -> str:
        return self.health.state

    @property
    def placeable(self) -> bool:
        return self.health.state == HEALTHY

    def process_exited(self) -> bool:
        return self.proc is not None and self.proc.poll() is not None

    def queue_depth(self) -> int:
        """The replica's per-session admission bound, from its ready
        record (falls back to the config default)."""
        qd = self.ready.get("queue_depth")
        if qd:
            return int(qd)
        from kcmc_tpu_torch.config import CorrectorConfig

        return int(
            CorrectorConfig.__dataclass_fields__["serve_queue_depth"].default
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Replica({self.rid}, {self.state})"


# -- rendezvous (highest-random-weight) placement --------------------------


def _score(key: str, rid: str) -> int:
    digest = hashlib.sha256(f"{key}|{rid}".encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big")


def rank(key: str, rids) -> list[str]:
    """Replica ids ordered by rendezvous preference for `key` (best
    first). Deterministic: ties (cryptographically negligible) break
    by id. The tail of the list is the migration failover order — the
    same for every router instance, so two routers over one fleet
    would agree."""
    return sorted(rids, key=lambda r: (-_score(key, str(r)), str(r)))


def place(key: str, rids) -> str | None:
    """The winning replica for a session key, or None when the
    placeable set is empty. Minimal-movement by construction: a
    replica joining or leaving only changes the winner for keys whose
    top score it held (~1/N of the keyspace)."""
    best = None
    best_score = -1
    for r in rids:
        r = str(r)
        s = _score(key, r)
        if s > best_score or (s == best_score and (best is None or r < best)):
            best, best_score = r, s
    return best


# -- fleet metrics rollup --------------------------------------------------


def merge_fleet_metrics(
    payloads: dict[str, dict],
    extra_hists: dict | None = None,
    states: dict[str, str] | None = None,
) -> dict:
    """Exact-merge N replicas' `metrics` payloads into one.

    `payloads` maps replica id -> its scraped `metrics` payload
    (schema kcmc_metrics/1); `extra_hists` is an optional extra
    histogram source in `SegmentLatencies.hist_dicts()` form (the
    router's own `fleet.migrate` spans). The result keeps the
    kcmc_metrics/1 shape — plane segments/totals/histograms, sessions,
    counters, gauges — so every single-replica consumer (`top`,
    `render_prometheus`) renders a fleet unchanged, plus a `fleet`
    block with per-replica health states and gauges. Merging the
    per-replica histogram exports reproduces what one process
    observing every request would have recorded.
    """
    merged: dict[tuple[str, str], LatencyHistogram] = {}

    def _fold(hist_dicts: dict) -> None:
        for seg, rungs in (hist_dicts or {}).items():
            for rung, d in (rungs or {}).items():
                h = LatencyHistogram.from_dict(d)
                key = (str(seg), str(rung))
                if key in merged:
                    merged[key].merge(h)
                else:
                    merged[key] = h

    counters: dict[str, int] = {}
    gauges: dict[str, float] = {}
    sessions: dict[str, dict] = {}
    per_replica: dict[str, dict] = {}
    exemplar_payloads: list[dict] = []
    for rid in sorted(payloads):
        m = payloads[rid] or {}
        _fold((m.get("plane") or {}).get("histograms") or {})
        if m.get("exemplars"):
            exemplar_payloads.append(m["exemplars"])
        for k, v in (m.get("counters") or {}).items():
            if isinstance(v, (int, float)):
                counters[k] = counters.get(k, 0) + v
        g = m.get("gauges") or {}
        for k in ("sessions_open", "inflight_batches", "queued_frames"):
            if isinstance(g.get(k), (int, float)):
                gauges[k] = gauges.get(k, 0) + g[k]
        for sid, entry in (m.get("sessions") or {}).items():
            sessions[sid] = {**entry, "replica": rid}
        per_replica[rid] = {
            "state": (states or {}).get(rid, HEALTHY),
            "gauges": g,
        }
    for rid, state in (states or {}).items():
        # replicas with no scrape yet (just joined, or dead) still
        # belong in the fleet block — operators need to SEE them
        per_replica.setdefault(rid, {"state": state, "gauges": {}})
    if extra_hists:
        _fold(extra_hists)

    segments: dict = {}
    totals: dict[str, LatencyHistogram] = {}
    hist_out: dict = {}
    for (seg, rung) in sorted(merged):
        h = merged[(seg, rung)]
        segments.setdefault(seg, {})[rung] = h.summary()
        hist_out.setdefault(seg, {})[rung] = h.to_dict()
        t = totals.get(seg)
        totals[seg] = h.clone() if t is None else t.merge(h)
    fleet_exemplars: dict = {}
    if exemplar_payloads:
        # exemplars fold last-wins (they are pointers, not counts — the
        # histogram bit-exact merge contract does not apply to them)
        from kcmc_tpu_torch.obs.tracing import ExemplarStore

        fleet_exemplars = ExemplarStore.merge_exports(exemplar_payloads)
    return {
        "schema": "kcmc_metrics/1",
        "plane": {
            "segments": segments,
            "totals": {s: totals[s].summary() for s in sorted(totals)},
            "histograms": hist_out,
        },
        "sessions": sessions,
        "counters": counters,
        "gauges": gauges,
        **({"exemplars": fleet_exemplars} if fleet_exemplars else {}),
        "fleet": {
            "replicas": per_replica,
            "n_replicas": len(per_replica),
            "n_healthy": sum(
                1
                for r in per_replica.values()
                if r["state"] == HEALTHY
            ),
        },
    }


def predicted_wait_s(
    merged_metrics: dict, queued: int, capacity: int,
    qos_class: str | None = None,
):
    """Admission-rejection hint: a rough expected wait for new work
    given the fleet's merged end-to-end latency and current backlog.
    p50(request.total) scaled by the backlog fraction — deliberately a
    HINT, not a promise; None when the fleet has no latency history
    yet.

    `qos_class` scopes the p50 to one scheduling class (docs/
    SERVING.md "Latency QoS"): "latency" reads the latency rung's
    histogram, "batch" folds full + degraded — both exact merges of
    the per-rung series `merge_fleet_metrics` already carries. A class
    with no history (or a payload without classes) falls back to the
    class-blind total."""
    plane = ((merged_metrics or {}).get("plane") or {})
    p50 = None
    if qos_class is not None:
        rungs = (plane.get("histograms") or {}).get("request.total") or {}
        fold = (
            ("latency",) if qos_class == "latency"
            else ("full", "degraded")
        )
        h = None
        for r in fold:
            d = rungs.get(r)
            if not isinstance(d, dict):
                continue
            hr = LatencyHistogram.from_dict(d)
            h = hr if h is None else h.merge(hr)
        if h is not None and h.count:
            p50 = h.quantile(50)
    if p50 is None:
        tot = (plane.get("totals") or {}).get("request.total") or {}
        p50 = tot.get("p50_s")
    if p50 is None or capacity <= 0:
        return None
    return round(float(p50) * (1.0 + queued / capacity), 4)


# -- replica spawning ------------------------------------------------------


def spawn_replica(
    serve_args: list[str],
    env: dict | None = None,
    suspect_probes: int = 2,
    dead_probes: int = 4,
    device: str | None = None,
) -> Replica:
    """Warm-boot one serve replica: ``python -m kcmc_tpu_torch [--device
    DEVICE] serve <serve_args>`` as a subprocess, wait for its machine-
    readable ready record on stdout, and wrap it as a router-owned
    Replica. `device` is the replica's top-level `--device` (None: the
    card, and the replica exits without one unless `serve_args` ask
    for `--backend numpy`), so a replica never runs on a device its
    caller did not name. `serve_args` should pass ``--port 0``
    (ephemeral) and the shared ``--journal-dir`` — migration requires
    every replica to see the same journal directory. Raises
    RuntimeError when the process dies before becoming ready."""
    dev = ["--device", str(device)] if device else []
    cmd = [sys.executable, "-m", "kcmc_tpu_torch", *dev, "serve", *serve_args]
    proc = subprocess.Popen(
        cmd,
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
        env=dict(os.environ, **(env or {})),
    )
    try:
        line = proc.stdout.readline()
        ready = json.loads(line) if line else None
    except (ValueError, OSError):
        ready = None
    if not ready or not ready.get("serving"):
        try:
            proc.kill()
            proc.wait(timeout=10.0)
        except (OSError, subprocess.TimeoutExpired):
            pass
        if proc.stdout is not None:
            proc.stdout.close()
        raise RuntimeError(
            f"replica failed to become ready (cmd: {' '.join(cmd)})"
        )
    return Replica(
        host=ready.get("host", "127.0.0.1"),
        port=int(ready["port"]),
        proc=proc,
        ready=ready,
        suspect_probes=suspect_probes,
        dead_probes=dead_probes,
    )


def stop_replica(replica: Replica, timeout_s: float = 30.0) -> None:
    """SIGTERM a router-owned replica (the serve process journals
    every open session on SIGTERM — the drain half of scale-down) and
    reap it; escalates to SIGKILL past the timeout. External replicas
    (no proc) are left alone."""
    proc = replica.proc
    if proc is None:
        return
    try:
        if proc.poll() is None:
            proc.terminate()
        proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        try:
            proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:  # pragma: no cover
            pass
    except OSError:
        pass
    if proc.stdout is not None:
        proc.stdout.close()
