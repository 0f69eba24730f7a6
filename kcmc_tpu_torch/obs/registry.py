"""Canonical telemetry-name registry (the port's copy of
kcmc_tpu/obs/registry.py, name for name).

THE vocabulary of the observability surface: every trace-span /
instant / counter name the package emits, and every key of the
`timing` payload (`StageTimer.report` plus the orchestrator's
additions) that `obs/report.py` renders. The names are the
reference's, so a trace or records file of either package renders in
the other's report, and tests/test_torch_obs.py holds every name the
port emits to this registry.

Adding a name: put it in the right group below, then use the same
literal at the emission site and (if rendered) in obs/report.py.
Removing a producer: delete the name here in the same change.
"""

from __future__ import annotations

# -- trace spans (Tracer.complete / StageTimer stage+stall) ----------------

# StageTimer.stage(...) intervals: the coarse where-did-time-go view.
STAGE_SPANS = frozenset(
    {
        "prepare_reference",
        "refine_template",
        "register_batches",
        "resume_restore",
        "warp",
    }
)

# StageTimer.stall(...)/add_stall(...) seams: consumer time blocked
# inside a stage on something that should overlap.
STALL_SPANS = frozenset(
    {
        "prefetch_wait",
        "drain_sync",
        "writer_backpressure",
        "writer_flush",
        "template_update",
        # Consumer wait on a not-yet-finished staged H2D upload slot
        # (corrector._dispatch_batches double buffering).
        "upload_wait",
    }
)

# Per-batch dispatch + background-writer worker spans.
DISPATCH_SPANS = frozenset({"dispatch_batch"})

# Upload-worker spans (double-buffered H2D): one `upload.stage`
# per staged batch on the kcmc-upload worker's track — the host-side
# asarray + ownership copy that now overlaps device execution.
UPLOAD_SPANS = frozenset({"upload.stage"})
WRITER_SPANS = frozenset(
    {
        "writer.append_batch",
        "writer.backpressure",
        "writer.flush",
    }
)

# Plan-runtime compile accounting (plans/runtime.py `timed`): the span
# is `plan_build` inside an ExecutionPlan build, `jit_compile` for a
# lazily triggered inline build.
PLAN_SPANS = frozenset({"plan_build", "jit_compile"})

# Feeder (io/feeder.py): one span per pooled chunk, submit -> fully
# decoded+reassembled (args carry lo/hi/span count). The consumer-side
# wait on an undecoded head chunk still lands in `prefetch_wait`.
FEEDER_SPANS = frozenset({"feeder.decode"})

# Zero-duration instants.
INSTANT_NAMES = frozenset(
    {
        "checkpoint_save",
        "checkpoint_resume",
        "plan_cache_hit",
        "plan_cache_miss",
        # Pipelined-collective breadcrumb: one instant per
        # sharded-program build recording the ring layout (chunks,
        # devices, shape) — the collective itself runs inside the
        # batch program, invisible to the host tracer.
        "collective.chunk",
    }
)

# Counter series.
COUNTER_NAMES = frozenset({"frames_done"})

# Dispatch-decision explainability counters (serve/scheduler.py,
# the reference's serve plane): every dispatch records exactly one
# `why` — the full vocabulary of reasons a window left the queue.
# Emitted as SpanShard.counter(...) instants when tracing is armed and
# mirrored in the scheduler's `stats` payload; the `why` also rides
# the per-batch request.dispatch span as an arg.
DISPATCH_WHY_COUNTERS = frozenset(
    {
        # the window filled to batch_size — the throughput-optimal case
        "dispatch.why.full_window",
        # head-of-line deadline minus the dispatch horizon went
        # negative: a partial window dispatched NOW on the smallest
        # covering batch-ladder rung
        "dispatch.why.deadline_forced",
        # a latency-class session jumped the weighted round-robin
        "dispatch.why.preempted",
        # a deadline-forced partial deferred by serve_latency_fill_floor
        # fired once the window reached the floor
        "dispatch.why.fill_floor",
        # a partial window with no deadline pressure (tail/trickle
        # drain — the pre-QoS scheduler's only partial case)
        "dispatch.why.flush",
    }
)

# Request-lifecycle latency segments (obs/latency.py): the shared
# vocabulary of the per-request telemetry plane — every
# `SegmentLatencies.observe(...)` site in serve/scheduler.py,
# serve/session.py, and corrector.py uses these literals, and the
# `metrics` verb / `kcmc_tpu report` latency section / `kcmc_tpu top`
# render exactly them. Serve records the full ladder; one-shot runs
# record the dispatch/device/drain subset (no client queue exists).
REQUEST_SEGMENTS = frozenset(
    {
        "request.admission",  # submit entry -> admitted to the queue
        "request.queue_wait",  # admitted -> taken into a batch
        "request.batch_form",  # take_batch stack+pad
        "request.dispatch",  # batch formed -> device dispatch returned
        "request.device",  # dispatch returned -> host materialized
        "request.drain",  # materialized -> session accounting done
        "request.delivery",  # accounted -> fetched by the client
        "request.total",  # submit entry -> fetched (end to end)
    }
)

# Durable-journal DURATION spans (serve/session.py, serve/scheduler.py):
# tracer spans (cat "journal") AND latency segments, so durability cost
# shows up both in Perfetto and in the `metrics` verb. These replaced
# the earlier `journal_save`/`journal_resume` instants.
JOURNAL_SPANS = frozenset({"journal.save", "journal.resume"})

# Object-store I/O spans (io/objectstore.py, cat "object"): one
# `object.get` per ObjectStack.read (covers every chunk GET it issued,
# hedges included — args carry lo/hi), one `object.put` per verified
# chunk/manifest upload (args carry key/bytes).
OBJECT_SPANS = frozenset({"object.get", "object.put"})

# Fleet-router DURATION spans (serve/router.py): latency segments the
# router records into its own SegmentLatencies — `fleet.migrate` is
# one whole session migration (pick survivor -> resume_session ->
# tail replay -> rebind), surfaced through the router's `metrics`
# rollup so migration cost is visible fleet-wide. With distributed
# tracing the router also emits the migration as a link span
# into its span shard, carrying the migrated session's trace id so
# the stitched trace crosses replicas.
FLEET_SPANS = frozenset({"fleet.migrate"})

# Distributed-tracing RPC hop spans (obs/tracing.py SpanShard): one
# span per protocol hop of a traced request — the client side of a
# call (serve/client.py), the router forward (serve/router.py), and
# the replica handling it (serve/server.py). Together with the
# REQUEST_SEGMENTS spans the scheduler/session emit per batch, they
# form the causal tree `kcmc_tpu trace` stitches.
TRACE_SPANS = frozenset({"rpc.client", "rpc.router", "rpc.server"})

SPAN_NAMES = (
    STAGE_SPANS
    | STALL_SPANS
    | DISPATCH_SPANS
    | UPLOAD_SPANS
    | WRITER_SPANS
    | PLAN_SPANS
    | FEEDER_SPANS
    | INSTANT_NAMES
    | COUNTER_NAMES
    | DISPATCH_WHY_COUNTERS
    | REQUEST_SEGMENTS
    | JOURNAL_SPANS
    | FLEET_SPANS
    | TRACE_SPANS
    | OBJECT_SPANS
)

# -- timing payload keys ---------------------------------------------------

# Keys of `CorrectionResult.timing`: StageTimer.report's own output
# plus what the orchestrator/plan layers attach. obs/report.py and the
# CLI summary read EXACTLY these literals.
TIMING_KEYS = frozenset(
    {
        # StageTimer.report
        "stages_s",
        "stage_counts",
        "stage_mean_s",
        "stalls_s",
        "stall_counts",
        "total_s",
        "frames_per_sec",
        # orchestrator attachments
        "robustness",
        "warp_escalated",
        "pipeline",
        "restored_frames",
        # plans/runtime.py snapshot
        "plan_cache",
        # pooled-ingest accounting (io/feeder.py via correct_file)
        "feeder",
        # serve session result timing (serve/session.py; the transport
        # reads n_frames back in serve/server.py close_session)
        "n_frames",
        "elapsed_s",
        # request-latency section (obs/latency.py SegmentLatencies
        # .report(): {"segments": ..., "totals": ...}) — attached by
        # serve session finalize and RunTelemetry.finish, rendered by
        # obs/report.py and the `metrics` verb consumers
        "latency",
        # deadline-QoS section (serve/session.py finalize): qos_class,
        # deadline hit/miss counts, preemption exposure — rendered as
        # the "Deadline QoS" table by obs/report.py; absent on every
        # pre-QoS artifact (the table renders "—", never crashes)
        "deadline_qos",
    }
)
