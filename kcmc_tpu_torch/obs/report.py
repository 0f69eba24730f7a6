"""Render a human-readable run report (the port's copy of
kcmc_tpu/obs/report.py; `python -m kcmc_tpu_torch.obs.report PATH`).

Consumes either artifact a run leaves behind:

* a frame-records JSONL (`frame_records_path`) — header manifest,
  per-frame quality records, optional run summary line;
* a transforms `.npz` — per-frame diagnostic arrays plus the
  JSON-encoded `timing`/`robustness` payloads.

and renders: the manifest line, the stage/stall table (totals, counts,
per-stage means — the `StageTimer` payload), frame-quality percentiles,
the worst-N frames by consensus support, and the robustness-ladder
summary. Pure stdlib + numpy: auditing a run must not require an
accelerator stack.

A `kcmc check --json` artifact (kind: kcmc_check) is also accepted and
renders as the static-analysis summary line — the CI job's one-stop
"what did this run conclude" renderer.

The timing keys and span names this renderer reads are the canonical
vocabulary of `kcmc_tpu_torch/obs/registry.py`, the reference's names,
so this renderer reads the reference's artifacts and the reference's
renderer reads the port's.
"""

from __future__ import annotations

import json

import numpy as np

# Per-frame metrics the percentile table covers, in display order.
_METRICS = (
    ("n_keypoints", "keypoints"),
    ("n_matches", "matches"),
    ("n_inliers", "inliers"),
    ("inlier_ratio", "inlier_ratio"),
    ("rms_residual_px", "residual_px"),
    ("template_corr", "template_corr"),
    ("coverage", "coverage"),
)
_PCTS = (5, 25, 50, 75, 95)


def load_run(path: str) -> dict:
    """Normalize either artifact into
    {manifest, records: [dict], timing, robustness, source}.
    Distributed-tracing span shards (a shard .jsonl or a directory of
    them) normalize to {source, spans} and render as the critical-path
    report."""
    p = str(path)
    if p.endswith(".npz"):
        return _load_npz(p)
    spans = _load_maybe_spans(p)
    if spans is not None:
        return spans
    return _load_jsonl(p)


def _load_maybe_spans(path: str) -> dict | None:
    """The artifact as {source, spans} if it is a span shard (header
    kind kcmc_span_shard) or a directory containing shards; None
    otherwise — frame-records JSONLs have a different header kind and
    fall through to the frame-quality loader."""
    import os

    from kcmc_tpu_torch.obs.tracing import SHARD_KIND, collect_spans

    if os.path.isdir(path):
        try:
            spans = collect_spans([path])
        except (OSError, ValueError):
            return None
        return {"source": path, "spans": spans} if spans else None
    try:
        with open(path, encoding="utf-8") as f:
            first = json.loads(f.readline() or "null")
    except (OSError, ValueError, UnicodeDecodeError):
        return None
    if not (isinstance(first, dict) and first.get("kind") == SHARD_KIND):
        return None
    return {"source": path, "spans": collect_spans([path])}


def _load_jsonl(path: str) -> dict:
    from kcmc_tpu_torch.obs.records import read_jsonl

    header, records, summary = read_jsonl(path)
    out = {
        "source": path,
        "manifest": (header or {}).get("manifest"),
        "records": records,
        "timing": (summary or {}).get("timing"),
        "robustness": (summary or {}).get("robustness"),
    }
    if summary is None:
        out["incomplete"] = True  # killed run: no summary line
    elif "error" in summary:
        out["error"] = summary["error"]
    return out


def _load_npz(path: str) -> dict:
    with np.load(path, allow_pickle=False) as data:
        keys = set(data.files)

        def _json_scalar(key):
            if key not in keys:
                return None
            try:
                return json.loads(str(data[key]))
            except (json.JSONDecodeError, ValueError):
                return None

        n = 0
        for k in ("n_inliers", "n_matches", "n_keypoints", "rms_residual"):
            if k in keys:
                n = len(data[k])
                break
        cols = {
            k: np.asarray(data[k])
            for k in (
                "n_keypoints", "n_matches", "n_inliers", "rms_residual",
                "template_corr", "coverage", "warp_ok", "warp_rescued",
                "frames_failed",
            )
            if k in keys
        }
        timing = _json_scalar("timing")
        robustness = _json_scalar("robustness")
        manifest = _json_scalar("manifest")
    records = []
    for i in range(n):
        nm = int(cols["n_matches"][i]) if "n_matches" in cols else 0
        ni = int(cols["n_inliers"][i]) if "n_inliers" in cols else 0
        rec = {
            "frame": i,
            "n_matches": nm,
            "n_inliers": ni,
            "inlier_ratio": ni / max(nm, 1),
        }
        if "n_keypoints" in cols:
            rec["n_keypoints"] = int(cols["n_keypoints"][i])
        if "rms_residual" in cols:
            rec["rms_residual_px"] = float(cols["rms_residual"][i])
        if "template_corr" in cols:
            rec["template_corr"] = float(cols["template_corr"][i])
        if "coverage" in cols:
            rec["coverage"] = float(cols["coverage"][i])
        if "warp_ok" in cols:
            rec["warp_ok"] = bool(cols["warp_ok"][i])
        if "warp_rescued" in cols:
            rec["warp_rescued"] = bool(cols["warp_rescued"][i])
        if "frames_failed" in cols:
            rec["failed"] = bool(cols["frames_failed"][i])
        records.append(rec)
    return {
        "source": path,
        "manifest": manifest,
        "records": records,
        "timing": timing,
        "robustness": robustness,
    }


def _metric_values(records: list[dict], key: str) -> np.ndarray:
    vals = [
        r[key]
        for r in records
        if r.get(key) is not None and np.isfinite(r[key])
    ]
    return np.asarray(vals, np.float64)


def _fmt(v: float) -> str:
    if abs(v) >= 1000 or v == int(v):
        return f"{v:.0f}"
    return f"{v:.3f}"


def _stage_table(timing: dict) -> list[str]:
    lines = []
    stages = timing.get("stages_s", {})
    counts = timing.get("stage_counts", {})
    means = timing.get("stage_mean_s", {})
    if stages:
        lines.append("Stages:")
        lines.append(
            f"  {'stage':<20} {'total_s':>10} {'count':>7} {'mean_s':>10}"
        )
        for name, total in sorted(stages.items(), key=lambda kv: -kv[1]):
            c = counts.get(name, 0)
            m = means.get(name, total / c if c else 0.0)
            lines.append(
                f"  {name:<20} {total:>10.3f} {c:>7d} {m:>10.4f}"
            )
        lines.append(f"  {'TOTAL':<20} {timing.get('total_s', 0.0):>10.3f}")
    stalls = timing.get("stalls_s", {})
    if stalls:
        sc = timing.get("stall_counts", {})
        total = timing.get("total_s") or 0.0
        lines.append("Pipeline stalls (consumer blocked inside stages):")
        lines.append(
            f"  {'seam':<20} {'total_s':>10} {'count':>7} {'of run':>7}"
        )
        for name, s in sorted(stalls.items(), key=lambda kv: -kv[1]):
            frac = f"{100 * s / total:.1f}%" if total else "-"
            lines.append(
                f"  {name:<20} {s:>10.3f} {sc.get(name, 0):>7d} {frac:>7}"
            )
    feed = timing.get("feeder")
    if feed:
        # pooled-ingest accounting (io/feeder.py): which pool flavor
        # decoded, how wide, and how much it retried
        lines.append(
            "Feeder (decode pool): "
            f"mode={feed.get('mode', '?')} workers={feed.get('workers', '?')}"
            f" prefetch={feed.get('prefetch_chunks', '?')} chunks"
            f"  decoded {feed.get('frames', 0)} frames in"
            f" {feed.get('chunks', 0)} chunks / {feed.get('spans', 0)} spans"
            + (
                f"  (io_retries {feed['io_retries']})"
                if feed.get("io_retries")
                else ""
            )
        )
    lines.extend(_latency_table(timing))
    fps = timing.get("frames_per_sec")
    if fps:
        lines.append(f"Throughput: {fps:.1f} frames/sec")
    plan = timing.get("plan_cache")
    if plan:
        # Warm-up / build accounting (plans/): what this run
        # compiled vs deserialized, and how batches routed to buckets.
        lines.append("Warm-up / compile cache (execution plans):")
        cache = plan.get("cache_dir") or "off"
        lines.append(
            f"  persistent cache: {cache}  rung: {plan.get('rung', 'full')}"
        )
        if plan.get("buckets"):
            lines.append(
                "  buckets: "
                + ", ".join("x".join(map(str, b)) for b in plan["buckets"])
                + (
                    f"  routed exact={plan.get('bucket_exact', 0)}"
                    f" padded={plan.get('bucket_padded', 0)}"
                    f" fallback={plan.get('bucket_fallback', 0)}"
                )
            )
        lines.append(
            f"  programs compiled: {plan.get('programs_compiled', 0)}"
            f" in {plan.get('compile_s', 0.0):.2f}s"
            f"  (stamp hits {plan.get('stamp_hits', 0)},"
            f" misses {plan.get('stamp_misses', 0)})"
        )
        for ev in (plan.get("events") or [])[:8]:
            shape = "x".join(str(s) for s in ev.get("shape", []))
            hit = ev.get("stamp_hit")
            tag = "" if hit is None else (" [cached]" if hit else " [fresh]")
            lines.append(
                f"    {ev.get('program', '?'):<18} {shape:<12}"
                f" {ev.get('dtype', ''):<8} {ev.get('seconds', 0.0):>8.3f}s"
                f"{tag}"
            )
    return lines


def _fmt_ms(v) -> str:
    """Milliseconds, or the em dash for stats a pre-latency-plane
    artifact (or an empty histogram) doesn't carry — the renderer must
    never crash on old runs."""
    if v is None:
        return "—"
    try:
        return f"{float(v) * 1e3:.2f}"
    except (TypeError, ValueError):
        return "—"


def _latency_table(timing: dict) -> list[str]:
    """The "Request latency" section (docs/OBSERVABILITY.md): one row
    per (lifecycle segment, QoS rung) from `timing["latency"]` — the
    same schema the serve `metrics` verb exports. Absent on pre-plane
    artifacts (rendered as nothing, not a crash)."""
    lat = timing.get("latency")
    if not isinstance(lat, dict):
        return []
    segments = lat.get("segments")
    if not isinstance(segments, dict) or not segments:
        return []
    lines = ["Request latency (per lifecycle segment; ms):"]
    lines.append(
        f"  {'segment':<22} {'rung':<9} {'count':>8} {'p50':>9}"
        f" {'p90':>9} {'p99':>9} {'max':>9}"
    )
    for seg in sorted(segments):
        rungs = segments[seg]
        if not isinstance(rungs, dict):
            continue
        for rung in sorted(rungs):
            s = rungs[rung] or {}
            lines.append(
                f"  {seg:<22} {rung:<9} {s.get('count', 0):>8}"
                f" {_fmt_ms(s.get('p50_s')):>9}"
                f" {_fmt_ms(s.get('p90_s')):>9}"
                f" {_fmt_ms(s.get('p99_s')):>9}"
                f" {_fmt_ms(s.get('max_s')):>9}"
            )
    return lines


def _deadline_qos_table(timing) -> list[str]:
    """The "Deadline QoS" report section (docs/SERVING.md "Latency
    QoS"): the session's scheduling class and its deadline scorecard
    from `timing["deadline_qos"]`. Always present, like the critical-
    path table: artifacts that predate latency QoS (or batch-class runs
    that never touched a deadline) render the em dash rather than
    omitting the section — and never crash, whatever shape the artifact
    has."""
    dq = (timing or {}).get("deadline_qos") if isinstance(
        timing, dict
    ) else None
    if not isinstance(dq, dict) or not dq:
        return [
            "Deadline QoS: — (no latency-class activity in this "
            "artifact)"
        ]
    hits = int(dq.get("deadline_hits") or 0)
    misses = int(dq.get("deadline_misses") or 0)
    rate = (
        f"{100.0 * hits / (hits + misses):.1f}%"
        if (hits + misses) else "—"
    )
    return [
        "Deadline QoS:",
        f"  class={dq.get('qos_class') or '—'}"
        f" deadline_hits={hits} deadline_misses={misses}"
        f" hit_rate={rate}"
        f" preempted_dispatches={int(dq.get('preempted_dispatches') or 0)}",
    ]


def _critical_path_summary(spans) -> dict | None:
    """Per-request dominant-segment histogram from distributed-tracing
    span shards: {n_traces, dominant: {segment: count}, slowest:
    [{trace_id, total_s, dominant}]}. None when the artifact predates
    tracing (no spans) — the renderers show "—" instead of a table."""
    if not spans:
        return None
    from kcmc_tpu_torch.obs.tracing import critical_path, slowest, stitch

    traces = stitch(spans)
    counts: dict[str, int] = {}
    total_by: dict[str, float] = {}
    for trace_spans in traces.values():
        cp = critical_path(trace_spans)
        dom = cp.get("dominant")
        if dom is None:
            continue
        counts[dom] = counts.get(dom, 0) + 1
        total_by[dom] = total_by.get(dom, 0.0) + float(
            cp.get("total_s") or 0.0
        )
    if not counts:
        return None
    return {
        "n_traces": len(traces),
        "dominant": counts,
        "mean_total_s": {
            seg: total_by[seg] / counts[seg] for seg in counts
        },
        "slowest": slowest(traces, n=5),
    }


def _critical_path_table(spans) -> list[str]:
    """The "Critical path" report section. Always present: artifacts
    without span shards (every pre-tracing run) render "—" rather than
    omitting the section, so a reader knows tracing simply wasn't on —
    and never crash, whatever shape the artifact has."""
    cp = _critical_path_summary(spans)
    if cp is None:
        return ["Critical path: — (no span shards in this artifact)"]
    n = sum(cp["dominant"].values())
    lines = [
        f"Critical path ({cp['n_traces']} traced requests, "
        "dominant segment per request):",
        f"  {'dominant segment':<22} {'requests':>9} {'share':>7}"
        f" {'mean e2e':>10}",
    ]
    for seg, c in sorted(cp["dominant"].items(), key=lambda kv: -kv[1]):
        lines.append(
            f"  {seg:<22} {c:>9} {100.0 * c / n:>6.1f}%"
            f" {_fmt_ms(cp['mean_total_s'][seg]):>8}ms"
        )
    rows = cp.get("slowest") or []
    if rows:
        lines.append("  slowest:")
        for r in rows:
            lines.append(
                f"    {r['trace_id']}  {_fmt_ms(r['total_s']):>8}ms"
                f"  dominant={r.get('dominant') or '—'}"
            )
    return lines


def render_report(run: dict, top: int = 10) -> str:
    """The human-readable report text."""
    lines = [f"# kcmc run report — {run.get('source', '?')}"]
    if run.get("spans") is not None:
        # A span-shard artifact IS the critical-path report — no
        # frame-quality sections to render.
        lines.append("")
        lines.extend(_critical_path_table(run["spans"]))
        return "\n".join(lines) + "\n"
    man = run.get("manifest")
    if man:
        v = man.get("versions", {})
        cfg = man.get("config", {})
        bits = []
        if cfg.get("model"):
            bits.append(f"model={cfg['model']}")
        if man.get("backend"):
            bits.append(f"backend={man['backend']}")
        if man.get("config_sha256"):
            bits.append(f"config={man['config_sha256'][:12]}")
        for pkg in ("kcmc_tpu_torch", "kcmc_tpu"):
            if v.get(pkg):
                bits.append(f"{pkg} {v[pkg]}")
        if v.get("torch"):
            bits.append(f"torch {v['torch']}")
        rt = man.get("backend_runtime") or {}
        devs = rt.get("devices") or []
        if devs:
            bits.append(
                f"{len(devs)}x {devs[0].get('platform', '?')}"
            )
        if man.get("fault_plan"):
            bits.append(f"fault_plan={man['fault_plan']!r}")
        lines.append("Manifest: " + ", ".join(bits))
    if run.get("incomplete"):
        lines.append(
            "NOTE: no run-summary line — the run did not close cleanly "
            "(killed mid-run?); records below cover what was flushed."
        )
    if run.get("error"):
        lines.append(f"RUN FAILED: {run['error']}")

    records = run.get("records") or []
    n_failed = sum(1 for r in records if r.get("failed"))
    n_rescued = sum(1 for r in records if r.get("warp_rescued"))
    n_failover = sum(1 for r in records if r.get("failover"))
    escalated = any(r.get("escalated") for r in records)
    frame_bits = [f"Frames: {len(records)}"]
    if n_failed:
        frame_bits.append(f"failed={n_failed}")
    if n_rescued:
        frame_bits.append(f"warp_rescued={n_rescued}")
    if n_failover:
        frame_bits.append(f"failover={n_failover}")
    if escalated:
        frame_bits.append("warp ESCALATED")
    lines.append(" ".join(frame_bits))

    timing = run.get("timing")
    if timing:
        lines.append("")
        lines.extend(_stage_table(timing))

    if records:
        lines.append("")
        lines.append("Frame quality percentiles:")
        header = "  " + f"{'metric':<14}" + "".join(
            f"{f'p{p}':>10}" for p in _PCTS
        )
        lines.append(header)
        for key, label in _METRICS:
            vals = _metric_values(records, key)
            if len(vals) == 0:
                continue
            pcts = np.percentile(vals, _PCTS)
            lines.append(
                f"  {label:<14}" + "".join(f"{_fmt(p):>10}" for p in pcts)
            )
        worst = _worst_frames(records, top)
        if worst:
            lines.append("")
            lines.append(
                f"Worst {len(worst)} frames (by inlier support):"
            )
            lines.append(
                f"  {'frame':>7} {'inliers':>8} {'ratio':>7} "
                f"{'resid_px':>9}  flags"
            )
            for r in worst:
                flags = ",".join(
                    f
                    for f in ("failed", "failover", "warp_rescued")
                    if r.get(f)
                ) or "-"
                resid = r.get("rms_residual_px")
                lines.append(
                    f"  {r['frame']:>7} {r.get('n_inliers', 0):>8} "
                    f"{(r.get('inlier_ratio') or 0):>7.3f} "
                    f"{'-' if resid is None else f'{resid:9.3f}'}  {flags}"
                )

    rb = run.get("robustness")
    if rb:
        lines.append("")
        lines.append(
            "Robustness ladder: "
            f"io_retries={rb.get('io_retries', 0)} "
            f"device_retries={rb.get('device_retries', 0)} "
            f"backend_failovers={rb.get('backend_failovers', 0)} "
            f"failed_frames={rb.get('failed_frames', 0)} "
            f"rescued_frames={rb.get('rescued_frames', 0)} "
            f"faults_injected={rb.get('faults_injected', 0)}"
        )
        # Serve-plane durability counters appear only when the run was
        # a serve session that touched them (docs/ROBUSTNESS.md).
        serve_bits = []
        if rb.get("journal_saves") or rb.get("journal_failures"):
            serve_bits.append(
                f"journal_saves={rb.get('journal_saves', 0)} "
                f"journal_failures={rb.get('journal_failures', 0)}"
            )
        if rb.get("deduped_frames"):
            serve_bits.append(f"deduped_frames={rb['deduped_frames']}")
        if rb.get("resumed_from_frame", -1) >= 0:
            serve_bits.append(
                f"resumed_from_frame={rb['resumed_from_frame']}"
            )
        if serve_bits:
            lines.append("  serve durability: " + " ".join(serve_bits))
        if rb.get("quarantined_parts"):
            lines.append(
                f"  quarantined checkpoint parts: {rb['quarantined_parts']}"
            )
    lines.append("")
    lines.extend(_deadline_qos_table(run.get("timing")))
    lines.append("")
    lines.extend(_critical_path_table(run.get("spans")))
    return "\n".join(lines) + "\n"


def _worst_frames(records: list[dict], top: int) -> list[dict]:
    """Failed frames first, then lowest inlier ratio, residual as the
    tiebreak (descending badness)."""

    def badness(r):
        resid = r.get("rms_residual_px")
        return (
            0 if r.get("failed") else 1,
            r.get("inlier_ratio") if r.get("inlier_ratio") is not None else 0,
            -(resid if resid is not None else 0.0),
        )

    ranked = sorted(records, key=badness)
    return ranked[: max(0, int(top))]


def _load_maybe_check(path: str) -> dict | None:
    """The artifact if it is a `kcmc check --json` report, else None.

    A check report is one JSON object with kind == "kcmc_check";
    frame-records JSONLs (multi-line) and npz (binary) both fail the
    single-object parse, so misdetection is structurally impossible."""
    if path.endswith(".npz"):
        return None
    try:
        with open(path, encoding="utf-8") as f:
            obj = json.loads(f.read(1 << 22))
    except (OSError, UnicodeDecodeError, ValueError):
        return None
    if isinstance(obj, dict) and obj.get("kind") == "kcmc_check":
        return obj
    return None


def render_check(obj: dict) -> str:
    """One summary line (+ any new findings) for a check artifact."""
    ok = bool(obj.get("ok"))
    lines = [
        "kcmc check: "
        f"{obj.get('findings', 0)} findings "
        f"({obj.get('baselined', 0)} baselined, "
        f"{obj.get('new', 0)} new, "
        f"{obj.get('new_errors', 0)} new errors, "
        f"{obj.get('stale_baseline', 0)} stale baseline) -> "
        f"{'OK' if ok else 'FAIL'}"
    ]
    for f in obj.get("new_findings", []):
        lines.append(
            f"  {f.get('path')}:{f.get('line')}: {f.get('severity')} "
            f"[{f.get('rule')}] {f.get('message')}"
        )
    return "\n".join(lines)


def main(path: str, top: int = 10, as_json: bool = False) -> int:
    import sys
    import zipfile

    check = _load_maybe_check(path)
    if check is not None:
        if as_json:
            print(json.dumps(check))
        else:
            print(render_check(check))
        return 0
    try:
        run = load_run(path)
    except (
        OSError,
        ValueError,  # covers json.JSONDecodeError + np.load refusals
        UnicodeDecodeError,
        zipfile.BadZipFile,
    ) as e:
        print(
            f"kcmc report: {path!r} is not a readable run artifact "
            f"(expected a --frame-records JSONL, a `correct "
            f"--transforms` .npz, or a trace span shard): {e}",
            file=sys.stderr,
        )
        return 2
    if as_json:
        print(json.dumps(_json_summary(run, top)))
    else:
        print(render_report(run, top=top), end="")
    return 0


def _json_summary(run: dict, top: int) -> dict:
    records = run.get("records") or []
    metrics = {}
    for key, label in _METRICS:
        vals = _metric_values(records, key)
        if len(vals):
            metrics[label] = {
                f"p{p}": float(v)
                for p, v in zip(_PCTS, np.percentile(vals, _PCTS))
            }
    timing = run.get("timing")
    return {
        "source": run.get("source"),
        "n_frames": len(records),
        "manifest": run.get("manifest"),
        "timing": timing,
        "robustness": run.get("robustness"),
        # the request-latency section, surfaced top-level with the
        # SAME schema as the serve `metrics` verb (one schema,
        # asserted in tests); None on pre-latency-plane artifacts
        "latency": (timing or {}).get("latency"),
        # the Deadline QoS scorecard (class, hits/misses, preempted
        # dispatches); None on pre-QoS artifacts and batch-class runs
        "deadline_qos": (timing or {}).get("deadline_qos"),
        "metrics": metrics,
        "worst_frames": [
            r.get("frame") for r in _worst_frames(records, top)
        ],
        # dominant-segment histogram from span shards; None on every
        # pre-tracing artifact (the text report renders "—")
        "critical_path": _critical_path_summary(run.get("spans")),
        "incomplete": bool(run.get("incomplete")),
    }


if __name__ == "__main__":
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m kcmc_tpu_torch.obs.report",
        description="Render a run report from a frame-records JSONL, a "
        "transforms .npz or a span shard.",
    )
    ap.add_argument("path")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--json", action="store_true", dest="as_json")
    a = ap.parse_args()
    sys.exit(main(a.path, top=a.top, as_json=a.as_json))
