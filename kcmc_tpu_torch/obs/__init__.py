"""kcmc_tpu_torch.obs — the run-telemetry subsystem (the port's copy of
kcmc_tpu/obs).

* `trace` — thread-aware span `Tracer`, Chrome trace-event export
  (`trace_path`, Perfetto-loadable);
* `records` — per-frame quality records streamed to a JSONL sidecar
  through a bounded background writer (`frame_records_path`);
* `manifest` + `heartbeat` — the run manifest embedded in both
  artifacts, and the periodic stderr progress line (`heartbeat_s`);
* `latency` — mergeable latency histograms (`timing["latency"]`, the
  serve plane's `metrics` verb) and the serve scheduler's
  `RequestClock`;
* `slo` — the serve plane's SLO burn-rate engine (`slo_objectives`);
* `tracing` — span shards, stitching and the critical path;
* `report` — the renderer over either artifact
  (`python -m kcmc_tpu_torch.obs.report PATH`);
* `registry` — the canonical span, counter and timing names;
* `top` — the live dashboard over serve replicas or a fleet router
  (`python -m kcmc_tpu_torch top`).

`run.RunTelemetry` coordinates them per run; `log` owns the
`kcmc_tpu_torch` logger and the `advise()` warning-routing seam.
Everything is off by default and costs one None-check per batch when
disabled.
"""

from __future__ import annotations

__all__ = [
    "Tracer",
    "FrameRecordStream",
    "Heartbeat",
    "aggregate_sampler",
    "RunTelemetry",
    "build_manifest",
    "get_logger",
    "setup_cli_logging",
    "advise",
]


def __getattr__(name):  # lazy: obs imports must not tax the hot path
    if name == "Tracer":
        from kcmc_tpu_torch.obs.trace import Tracer

        return Tracer
    if name == "FrameRecordStream":
        from kcmc_tpu_torch.obs.records import FrameRecordStream

        return FrameRecordStream
    if name in ("Heartbeat", "aggregate_sampler"):
        from kcmc_tpu_torch.obs import heartbeat

        return getattr(heartbeat, name)
    if name == "RunTelemetry":
        from kcmc_tpu_torch.obs.run import RunTelemetry

        return RunTelemetry
    if name == "build_manifest":
        from kcmc_tpu_torch.obs.manifest import build_manifest

        return build_manifest
    if name in ("get_logger", "setup_cli_logging", "advise"):
        from kcmc_tpu_torch.obs import log

        return getattr(log, name)
    raise AttributeError(f"module 'kcmc_tpu_torch.obs' has no attribute {name!r}")
