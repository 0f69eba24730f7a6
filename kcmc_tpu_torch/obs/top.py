"""`python -m kcmc_tpu_torch top`: a live terminal dashboard over serve
replicas (the port's copy of kcmc_tpu/obs/top.py).

Polls the `metrics` and `stats` verbs every refresh interval and
renders a compact view — per-session frames/fps/queue depth, the
supervisor state (strikes, rebuild, scheduler-wedge age), and the
plane's per-segment latency p50/p99 — so an operator watching a
replica sees queue pressure and tail latency move in real time
without Prometheus in the loop. `--once` renders a single frame and
exits (the CI smoke and scripting hook). The `metrics` and `trace`
subcommands read their `host:port` sources through `parse_addr`.

Fleet mode: pass several `host:port` targets (or one router address —
a router's `metrics` payload is already fleet-merged) and top scrapes
each and exact-merges the payloads via the serve/fleet.py histogram
contract into ONE dashboard, with a per-replica health block.

Pure stdlib + the bundled ServeClient: no torch, no extra threads (the
poll loop IS the program), safe to point at a production replica —
both verbs are read-only.
"""

from __future__ import annotations

import time

# ANSI: clear screen + home. Plain writes otherwise — no curses, so
# output also behaves piped into a file or CI log.
_CLEAR = "\x1b[2J\x1b[H"

# Render order for the segment table: the lifecycle ladder first, the
# durability spans last. Anything else (future segments) sorts after.
_SEGMENT_ORDER = (
    "request.admission",
    "request.queue_wait",
    "request.batch_form",
    "request.dispatch",
    "request.device",
    "request.drain",
    "request.delivery",
    "request.total",
    "journal.save",
    "journal.resume",
    "fleet.migrate",
)


def parse_addr(addr: str, default_port: int = 7733) -> tuple[str, int]:
    """'host:port' | 'host' | ':port' -> (host, port)."""
    addr = (addr or "").strip()
    if ":" in addr:
        host, _, port = addr.rpartition(":")
        return host or "127.0.0.1", int(port)
    return addr or "127.0.0.1", default_port


def _ms(v) -> str:
    if v is None:
        return "—"
    return f"{float(v) * 1e3:.1f}ms"


def _seg_rank(seg: str) -> tuple[int, str]:
    try:
        return (_SEGMENT_ORDER.index(seg), seg)
    except ValueError:
        return (len(_SEGMENT_ORDER), seg)


def render(metrics: dict, stats: dict, addr: str) -> str:
    """One dashboard frame (pure dict -> str; unit-testable)."""
    lines: list[str] = []
    g = metrics.get("gauges") or {}
    c = metrics.get("counters") or {}
    sup = stats.get("supervisor") or {}
    lines.append(
        f"kcmc_tpu_torch top — {addr}   "
        f"{time.strftime('%H:%M:%S')}   "
        f"sessions={g.get('sessions_open', 0)} "
        f"inflight={g.get('inflight_batches', 0)} "
        f"queued={g.get('queued_frames', 0)} "
        f"occupancy={g.get('batch_occupancy', 0.0)}"
    )
    wedge = float(sup.get("loop_beat_age_s", g.get("loop_beat_age_s", 0.0)))
    sup_bits = [
        f"frames_done={c.get('frames_done', 0)}",
        f"strikes={sup.get('backend_strikes', g.get('backend_strikes', 0))}",
        "rebuilding="
        + ("yes" if sup.get("backend_rebuilding") else "no"),
        f"rebuilds={sup.get('backend_rebuilds', 0)}",
        f"wedge_age={wedge:.1f}s" + (" WEDGED" if wedge > 30.0 else ""),
    ]
    if c.get("rejected_frames"):
        sup_bits.append(f"rejected={c['rejected_frames']}")
    if c.get("degraded_batches"):
        sup_bits.append(f"degraded_batches={c['degraded_batches']}")
    lines.append("supervisor: " + " ".join(sup_bits))

    # Deadline QoS header line — only when the plane has QoS activity
    # (pre-QoS replicas and idle batch-only planes stay one line
    # shorter). Stats block preferred; flat counters are the fleet
    # fallback (merge_fleet_metrics sums them across replicas).
    dq = stats.get("deadline_qos") or {}
    pre = int(dq.get("preemptions", c.get("preemptions", 0)))
    starve = int(
        dq.get("starvation_grants", c.get("starvation_grants", 0))
    )
    rej = int(
        dq.get(
            "rejected_deadline_submits",
            c.get("rejected_deadline_submits", 0),
        )
    )
    hits = int(dq.get("deadline_hits", c.get("deadline_hits", 0)))
    misses = int(dq.get("deadline_misses", c.get("deadline_misses", 0)))
    if pre or starve or rej or hits or misses:
        rate = (
            f"{100.0 * hits / (hits + misses):.1f}%"
            if (hits + misses) else "—"
        )
        lines.append(
            "deadline qos: "
            f"hit_rate={rate} ({hits}/{hits + misses}) "
            f"preemptions={pre} starvation_grants={starve} "
            f"admission_rejects={rej}"
        )

    # Fleet block: present when the payload came from a router (or
    # was merged from several replicas by the multi-target poll).
    fleet = metrics.get("fleet")
    if fleet and fleet.get("replicas"):
        lines.append(
            f"fleet: {fleet.get('n_replicas', 0)} replicas, "
            f"{fleet.get('n_healthy', 0)} healthy"
        )
        for rid in sorted(fleet["replicas"]):
            r = fleet["replicas"][rid]
            rg = r.get("gauges") or {}
            lines.append(
                f"  {rid:<22} {str(r.get('state', '?')):<10}"
                f" sessions={rg.get('sessions_open', 0)}"
                f" queued={rg.get('queued_frames', 0)}"
                f" inflight={rg.get('inflight_batches', 0)}"
            )

    totals = (metrics.get("plane") or {}).get("totals") or {}
    exemplars = metrics.get("exemplars") or {}
    lines.append("")
    if totals:
        header = (
            f"  {'segment':<22} {'count':>8} {'p50':>10} {'p99':>10}"
            f" {'max':>10}"
        )
        if exemplars:
            header += "  exemplar"
        lines.append(header)
        for seg in sorted(totals, key=_seg_rank):
            s = totals[seg]
            row = (
                f"  {seg:<22} {s.get('count', 0):>8}"
                f" {_ms(s.get('p50_s')):>10} {_ms(s.get('p99_s')):>10}"
                f" {_ms(s.get('max_s')):>10}"
            )
            if exemplars:
                # a trace id FROM the segment's slowest populated
                # bucket — copy it into `python -m kcmc_tpu_torch trace` to
                # see why
                from kcmc_tpu_torch.obs.tracing import top_exemplar

                ex = top_exemplar(exemplars, seg)
                row += f"  {ex['trace_id']}" if ex else "  —"
            lines.append(row)
    else:
        lines.append(
            "  (no request latency yet"
            + (
                ""
                if metrics.get("latency_telemetry", True)
                else " — latency_telemetry is OFF on this server"
            )
            + ")"
        )

    sessions = metrics.get("sessions") or {}
    lines.append("")
    lines.append(
        f"  {'session':<12} {'tenant':<12} {'class':<8} {'frames':>8}"
        f" {'fps':>8} {'queued':>7} {'deg':>4} {'dl-hit':>7}"
        f" {'p50':>10} {'p99':>10}"
    )
    for sid in sorted(sessions):
        s = sessions[sid]
        tot = (s.get("totals") or {}).get("request.total") or {}
        # pre-QoS payloads carry neither field: render "—", never crash
        klass = str(s.get("qos_class") or "—")
        dh = int(s.get("deadline_hits", 0))
        dm = int(s.get("deadline_misses", 0))
        dl_hit = f"{100.0 * dh / (dh + dm):.0f}%" if (dh + dm) else "—"
        lines.append(
            f"  {sid:<12} {str(s.get('tenant', '?')):<12}"
            f" {klass:<8}"
            f" {s.get('frames', 0):>8} {s.get('fps', 0.0):>8.1f}"
            f" {s.get('queued', 0):>7}"
            f" {'yes' if s.get('degraded') else 'no':>4}"
            f" {dl_hit:>7}"
            f" {_ms(tot.get('p50_s')):>10} {_ms(tot.get('p99_s')):>10}"
        )
    if not sessions:
        lines.append("  (no live sessions)")
    return "\n".join(lines) + "\n"


def _merge_stats(stats_by: dict) -> dict:
    """Fleet view of N replicas' `stats` supervisor blocks: worst-case
    rollup (max wedge age, summed strikes/rebuilds, any rebuilding) —
    the dashboard header should show the sickest replica's numbers."""
    sup = {
        "backend_strikes": 0,
        "backend_rebuilds": 0,
        "backend_rebuilding": False,
        "loop_beat_age_s": 0.0,
    }
    dq = {
        "preemptions": 0,
        "starvation_grants": 0,
        "rejected_deadline_submits": 0,
        "deadline_hits": 0,
        "deadline_misses": 0,
    }
    for st in stats_by.values():
        s = (st or {}).get("supervisor") or {}
        sup["backend_strikes"] += int(s.get("backend_strikes", 0))
        sup["backend_rebuilds"] += int(s.get("backend_rebuilds", 0))
        sup["backend_rebuilding"] |= bool(s.get("backend_rebuilding"))
        sup["loop_beat_age_s"] = max(
            sup["loop_beat_age_s"], float(s.get("loop_beat_age_s", 0.0))
        )
        d = (st or {}).get("deadline_qos") or {}
        for k in dq:
            dq[k] += int(d.get(k, 0))
    return {"supervisor": sup, "deadline_qos": dq}


def main(args) -> int:
    """`python -m kcmc_tpu_torch top` body (argparse args from __main__): poll
    metrics+stats, render, repeat. One target renders that replica
    (or router — a router's payload already carries the fleet block);
    several targets are scraped individually and exact-merged
    client-side (serve/fleet.py merge contract) into one fleet
    dashboard. `--once` prints one frame (exit 1 when every target is
    unreachable); the live loop keeps retrying flapping targets and
    exits 0 on Ctrl-C."""
    import sys

    from kcmc_tpu_torch.serve.client import ServeClient, ServeError

    raw = getattr(args, "addrs", None) or [args.addr]
    targets = [parse_addr(a) for a in raw]
    addrs = [f"{h}:{p}" for h, p in targets]
    label = addrs[0] if len(addrs) == 1 else (
        f"fleet({len(addrs)}): " + ",".join(addrs)
    )
    interval = max(float(args.interval), 0.2)
    clients: dict[str, ServeClient] = {}
    try:
        while True:
            payloads: dict[str, dict] = {}
            stats_by: dict[str, dict] = {}
            down: dict[str, str] = {}
            for (host, port), addr in zip(targets, addrs):
                try:
                    c = clients.get(addr)
                    if c is None:
                        c = clients[addr] = ServeClient(
                            host=host, port=port
                        )
                    payloads[addr] = c.metrics()
                    stats_by[addr] = c.stats()
                except (ServeError, OSError) as e:
                    c = clients.pop(addr, None)
                    if c is not None:
                        c.close()
                    down[addr] = str(e)
            if not payloads:
                err = "; ".join(f"{a}: {e}" for a, e in down.items())
                if args.once:
                    print(f"kcmc top: unreachable: {err}",
                          file=sys.stderr)
                    return 1
                frame = (
                    f"kcmc_tpu_torch top — {label}   (unreachable: {err}; "
                    "retrying)\n"
                )
            elif len(addrs) == 1:
                addr = addrs[0]
                frame = render(payloads[addr], stats_by[addr], addr)
            else:
                from kcmc_tpu_torch.serve.fleet import merge_fleet_metrics

                states = {a: "HEALTHY" for a in payloads}
                states.update({a: "UNREACHABLE" for a in down})
                merged = merge_fleet_metrics(payloads, states=states)
                frame = render(merged, _merge_stats(stats_by), label)
            if args.once:
                print(frame, end="")
                return 0
            print(_CLEAR + frame, end="", flush=True)
            time.sleep(interval)
    except KeyboardInterrupt:
        print()
        return 0
    finally:
        for c in clients.values():
            c.close()
