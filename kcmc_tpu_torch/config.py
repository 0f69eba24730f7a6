"""Pipeline configuration of the PyTorch port.

The fields the ported slices (translation, rigid, similarity, affine,
homography, piecewise and rigid3d, single-scale or through the scale
pyramid, with the options of `correct()`, the retry, fault and
file-streaming knobs of `correct_file()`, the observability knobs of a
one-shot run, the serve plane's knobs, span shards and SLOs, and the
fleet router's knobs) read, under the names and
defaults of `kcmc_tpu.config.CorrectorConfig`, so a JAX config carries
across with `config_from_dict(dataclasses.asdict(cfg))`. `plan_buckets`
is normalized through plans/buckets.py, as the reference normalizes it.
`config_from_dict` drops only the reference fields listed in
`DROPPED_FIELDS`, each with why the port may ignore it, and a name no
config has
raises `TypeError`. Warp policies and knob values the reference
rejects raise `ValueError` here with the reference's messages
(kcmc_tpu/config.py:750-767, :976-985, :1018-1047).
"""

from __future__ import annotations

import dataclasses

from kcmc_tpu_torch.plans.buckets import normalize_buckets

# Oriented describe takes the bins-first route from this many keypoints
# on, the small-K route through K6 below it
# (kcmc_tpu/ops/describe.py:_BINS_FIRST_MIN_K).
BINS_FIRST_MIN_K = 2048

MODELS = ("translation", "rigid", "similarity", "affine", "homography",
          "piecewise", "rigid3d")

# Largest Gaussian radius kernel K9 covers (its blur of the volume);
# radius = max(1, int(3 sigma + 0.5)). Beyond it detection takes the
# plain route, as the reference takes its jnp route.
K9_MAX_RADIUS = 6


@dataclasses.dataclass(frozen=True)
class CorrectorConfig:
    model: str = "translation"

    # detection
    max_keypoints: int = 512
    detect_threshold: float = 1e-4
    nms_size: int = 5
    border: int = 16
    harris_k: float = 0.04
    harris_window_sigma: float = 1.5
    cand_tile: int = 8

    # description
    oriented: bool | None = None  # None => auto: off for translation
    blur_sigma: float = 2.0
    n_octaves: int = 1
    octave_scale: float = 1.5
    pyramid_refine: bool = True  # coarse-to-fine pass when n_octaves > 1

    # matching
    ratio: float = 0.85
    max_hamming: int = 80
    mutual: bool = True
    match_radius: float | None = None
    match_tile: int = 64  # banded matcher's query tile side, px
    match_slack: float = 2.0  # banded bucket capacity / mean occupancy
    match_precision: str = "auto"

    # piecewise-rigid (config 3)
    patch_grid: tuple[int, int] = (8, 8)
    patch_hypotheses: int = 32
    refine_hypotheses: int = 8  # 0 = patch_hypotheses
    patch_model: str = "translation"
    patch_prior: float = 2.0
    field_smooth_sigma: float = 0.4  # in grid cells
    field_passes: int = 3
    refine_reach_scale: float = 0.5
    global_threshold: float = 8.0
    field_polish: int = 4

    # consensus
    n_hypotheses: int = 128
    inlier_threshold: float = 2.0
    refine_iters: int = 2
    seed: int = 0
    budget_rungs: int = 4
    early_exit_frac: float = 0.7
    warm_start: bool = False
    score_cap: int = 512

    # warp + photometric polish
    warp: str = "auto"
    rescue_warp: bool = True
    max_shear_px: int = 8
    max_rotation_deg: float | None = None
    # warn when more than this fraction of the frames seen (or of a
    # sliding window) took the gather rescue; with rescue_escalate, the
    # remaining batches switch to the exact gather warp
    rescue_warn_fraction: float = 0.25
    rescue_escalate: bool = True
    max_projective_px: int = 4
    max_scale_dev: float = 0.02
    transform_polish: int = 1
    polish_grid: tuple[int, int] = (4, 4)
    max_flow_px: int = 6  # K8's residual bound around the integer mean

    # orchestration
    batch_size: int = 32
    # per-frame template_corr and coverage diagnostics
    quality_metrics: bool = False
    # replace non-finite pixels by each frame's finite mean
    sanitize_input: bool = False
    # rolling-template updates blend on the device (update_reference)
    device_templates: bool = True
    # execution plans (plans/): the (H, W) shape buckets frames pad to,
    # and the persistent cache directory of the kernel libraries and
    # the plan stamps (also KCMC_COMPILE_CACHE)
    plan_buckets: tuple = ()
    compile_cache_dir: str | None = None
    # the frame-axis mesh (parallel/): 0 = one device (or KCMC_DEVICES),
    # N = the first N devices, -1 = every visible device; the reference
    # keypoint gathers as one all-gather (collective_chunks 0 or 1) or
    # as a ring of that many chunks per shard, value-identical
    mesh_devices: int = 0
    collective_chunks: int = 0
    # the pipelined dispatch stages the next batch's upload on a worker
    # thread (through pinned buffers and a copy stream on the card)
    # while the current batch runs; False uploads inline. Byte-identical
    # either way
    upload_overlap: bool = True

    # robustness (utils/faults.py; the degradation ladder of correct()
    # and correct_file()): total attempts per retryable operation (chunk
    # reads, device batches; 1 = no retry), exponential backoff with
    # seeded jitter
    retry_attempts: int = 3
    retry_backoff_s: float = 0.05
    retry_backoff_max_s: float = 2.0
    retry_jitter: float = 0.25  # uniform fraction in [0, 1]
    # rung 2: re-run a batch whose retries are spent on this backend;
    # "numpy" (the reference's name) is the same config on device="cpu",
    # the kernels' plain versions; None disables the rung
    failover_backend: str | None = "numpy"
    # rung 3: mark the batch's frames failed (identity transform, raw
    # pixels; matrix transforms interpolated after the run) instead of
    # raising
    degrade_mark_failed: bool = True
    # deterministic fault-injection spec (also KCMC_FAULT_PLAN), e.g.
    # "io_read:step=3:raise, device:step=7:transient"
    fault_plan: str | None = None
    # file streaming: decode workers (0 = auto), prefetch depth in
    # chunks (0 = derived from the dispatch window) and the background
    # writer's queue depth in batches (0 = synchronous writes)
    io_workers: int = 0
    io_prefetch: int = 0
    writer_depth: int = 2
    # object-store I/O (io/objectstore.py; emu:// or registered-scheme
    # URLs as source or output): they shape when and how bytes move,
    # never what a run computes. The per-attempt deadline of every
    # object op, seconds (RetryPolicy.deadline_s); the hedged-read
    # floor, milliseconds (a warm GET outlasting max(p95, this) fires
    # one duplicate; 0 disables hedging); frames per egress chunk
    # object (a resume reads it from the durable manifest); and the
    # multipart threshold and part size, bytes
    object_timeout_s: float = 30.0
    object_hedge_ms: float = 50.0
    object_chunk_frames: int = 64
    object_part_bytes: int = 8 << 20

    # observability (obs/): the Chrome trace-event JSON path (None =
    # off; stages, stalls, dispatches, uploads and writer appends become
    # spans, the run manifest rides in its metadata); the per-frame
    # quality-record JSONL path (None = off; one JSON object per frame,
    # written behind a background writer); the heartbeat period in
    # seconds (0 = off; one progress line to stderr per period); and
    # whether a run with any of them armed records the dispatch /
    # device / drain latency segments into timing["latency"]
    trace_path: str | None = None
    frame_records_path: str | None = None
    heartbeat_s: float = 0.0
    latency_telemetry: bool = True
    # distributed tracing of the serve plane: the span-shard directory
    # ("" = off; each serve process appends its finished request and RPC
    # spans to its own bounded JSONL there) and the per-process bound in
    # spans (the `trace` verb's ring; the file stops growing past it)
    trace_shard_dir: str = ""
    trace_shard_cap: int = 4096
    # declarative SLO objectives of the serve plane ("" = off):
    # ';'-separated `rung:threshold_s:fraction` (that fraction of
    # `request.total` on that QoS rung under the threshold) or
    # `avail:fraction` entries, e.g. "full:0.5:0.99;avail:0.999"
    slo_objectives: str = ""

    # serving (serve/): the per-session admission bound in frames (a
    # submit past it is rejected 429-style, after the degradation below
    # had its chance); the cross-session window of batches in flight;
    # the queue fraction past which a session dispatches on the
    # reduced-budget backend (1.0 = never degrade)
    serve_queue_depth: int = 256
    serve_inflight: int = 3
    serve_degrade_watermark: float = 0.5
    # durable session journals (None = off) and their cadence in drained
    # frames; a killed server restarted over the directory resumes every
    # journaled stream through `resume_session`
    serve_journal_dir: str | None = None
    serve_journal_every: int = 64
    # seconds a session may sit idle before it is journaled and reaped
    # (0 = never); the transport deadline baseline of the client; the
    # consecutive primary-backend batch failures before the scheduler
    # quarantines and rebuilds the backend (0 = never)
    serve_session_timeout_s: float = 0.0
    serve_io_timeout_s: float = 30.0
    serve_backend_strikes: int = 2
    # latency QoS, scheduling only (never what a frame computes): the
    # window fill a deadline-forced partial dispatch needs, predictive
    # admission, the horizon model's refresh period and the batch-class
    # starvation bound in preemptions
    serve_latency_fill_floor: float = 0.0
    serve_latency_admission: bool = True
    serve_latency_horizon_refresh_s: float = 1.0
    serve_latency_starvation_limit: int = 4
    # the fleet router (serve/fleet.py, serve/router.py), placement and
    # health only (never what a stream computes): the health-scrape
    # period, which is also each scrape's whole budget; the consecutive
    # bad probes that take HEALTHY to SUSPECT (and good ones back); the
    # consecutive hard-bad probes that take SUSPECT to DEAD and migrate
    # its sessions; the `loop_beat_age_s` past which a replica that
    # answers counts as wedged; the fraction of the fleet's queue
    # capacity past which new sessions are rejected 429-style (1.0 =
    # never); and the autoscaler's minimum spacing between actions
    fleet_probe_interval_s: float = 1.0
    fleet_suspect_probes: int = 2
    fleet_dead_probes: int = 4
    fleet_wedge_threshold_s: float = 30.0
    fleet_queue_watermark: float = 0.9
    fleet_scale_cooldown_s: float = 30.0

    @property
    def observability_enabled(self) -> bool:
        """True when any obs surface is armed: the one gate both the
        corrector (skip telemetry setup entirely) and
        `RunTelemetry.begin` (return None) consult."""
        return bool(
            self.trace_path or self.frame_records_path or self.heartbeat_s > 0
        )

    def __post_init__(self):
        # Totality of the resume-signature classification: every field
        # must be declared neutral or affecting (registries below the
        # class; `check`'s config-registry pass enforces the same
        # statically, this guards modified configs at runtime).
        _validate_field_classification()
        if self.model not in MODELS:
            raise ValueError(
                f"unknown model {self.model!r}; available: {sorted(MODELS)}"
            )
        if self.blur_sigma <= 0.0:
            raise ValueError(f"blur_sigma must be positive, got {self.blur_sigma}")
        if self.harris_window_sigma <= 0.0:
            raise ValueError(
                "harris_window_sigma must be positive, got "
                f"{self.harris_window_sigma}"
            )
        if self.cand_tile < 1:
            raise ValueError(f"cand_tile must be >= 1, got {self.cand_tile}")
        if self.max_rotation_deg is not None and not (
            0.0 < self.max_rotation_deg < 45.0
        ):
            raise ValueError(
                "max_rotation_deg must be in (0, 45) — beyond that the "
                "separable shear decomposition degrades; use warp='jnp' "
                f"for extreme rotations (got {self.max_rotation_deg})"
            )
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.match_precision not in ("auto", "float32", "bf16", "int8"):
            raise ValueError(
                "match_precision must be 'auto', 'float32', 'bf16', or "
                f"'int8', got {self.match_precision!r}"
            )
        if self.warm_start and self.model == "piecewise":
            raise ValueError(
                "warm_start seeds matrix-model consensus with the "
                "previous batch's transform; the piecewise field has "
                "no transform seed — disable warm_start for piecewise"
            )
        self._check_warp()
        if self.field_passes < 1:
            raise ValueError(f"field_passes must be >= 1, got {self.field_passes}")
        if self.refine_hypotheses < 0:
            raise ValueError(
                "refine_hypotheses must be >= 0 (0 = patch_hypotheses), "
                f"got {self.refine_hypotheses}"
            )
        if int(self.field_polish) < 0:
            raise ValueError(f"field_polish must be >= 0 passes, got {self.field_polish}")
        if self.patch_model not in ("translation", "rigid", "similarity", "affine"):
            raise ValueError(
                "patch_model must be one of translation/rigid/"
                f"similarity/affine, got {self.patch_model!r}"
            )
        if self.n_octaves < 1:
            raise ValueError(f"n_octaves must be >= 1, got {self.n_octaves}")
        if self.n_octaves > 1:
            if not 1.0 < self.octave_scale <= 4.0:
                raise ValueError(
                    f"octave_scale must be in (1, 4], got {self.octave_scale}"
                )
            if self.model == "rigid3d":
                raise ValueError("n_octaves > 1 (scale pyramid) supports 2D models only")
        if self.match_radius is not None:
            if self.match_radius <= 0:
                raise ValueError(
                    f"match_radius must be positive, got {self.match_radius}"
                )
            if self.model == "rigid3d":
                raise ValueError(
                    "match_radius (banded matching) supports 2D models only; "
                    "rigid3d uses the dense matcher"
                )
        if self.match_tile < 16 or self.match_tile % 4:
            raise ValueError(
                "match_tile must be >= 16 and a multiple of 4 (sub-"
                f"bucket sides are tile//4 or tile//2), got {self.match_tile}"
            )
        if self.match_slack < 1.0:
            raise ValueError(f"match_slack must be >= 1.0, got {self.match_slack}")
        if not 0.0 < self.rescue_warn_fraction <= 1.0:
            raise ValueError(
                "rescue_warn_fraction must be in (0, 1], got "
                f"{self.rescue_warn_fraction}"
            )
        if int(self.transform_polish) < 0:
            raise ValueError(
                f"transform_polish must be >= 0, got {self.transform_polish}"
            )
        if self.mesh_devices < -1:
            raise ValueError(
                "mesh_devices must be -1 (all devices), 0 (single-chip),"
                f" or a positive device count, got {self.mesh_devices}"
            )
        if self.collective_chunks < 0:
            raise ValueError(
                "collective_chunks must be >= 0 chunks (0/1 = one "
                f"monolithic all_gather), got {self.collective_chunks}"
            )
        self._check_robustness()
        if self.heartbeat_s < 0:
            raise ValueError(
                f"heartbeat_s must be >= 0 seconds (0 = off), got "
                f"{self.heartbeat_s}"
            )
        self._check_serve()
        object.__setattr__(self, "polish_grid", tuple(self.polish_grid))
        object.__setattr__(self, "patch_grid", tuple(self.patch_grid))
        # the bucket ladder in its canonical spelling, so the frozen
        # config hashes and digests on one form (config.py:1008)
        object.__setattr__(self, "plan_buckets", normalize_buckets(self.plan_buckets))
        if self.compile_cache_dir is not None and (
            not isinstance(self.compile_cache_dir, str)
            or not self.compile_cache_dir.strip()
        ):
            raise ValueError(
                "compile_cache_dir must be a non-empty path string or "
                f"None, got {self.compile_cache_dir!r}"
            )

    def _check_robustness(self) -> None:
        """The reference's checks of the retry, fault, object-store and
        file-streaming knobs, with its messages."""
        if self.retry_attempts < 1:
            raise ValueError(
                f"retry_attempts must be >= 1 (1 = no retry), got "
                f"{self.retry_attempts}"
            )
        if self.retry_backoff_s <= 0.0:
            raise ValueError(
                f"retry_backoff_s must be positive, got {self.retry_backoff_s}"
            )
        if self.retry_backoff_max_s < self.retry_backoff_s:
            raise ValueError(
                "retry_backoff_max_s must be >= retry_backoff_s, got "
                f"{self.retry_backoff_max_s} < {self.retry_backoff_s}"
            )
        if not 0.0 <= self.retry_jitter <= 1.0:
            raise ValueError(
                f"retry_jitter must be in [0, 1], got {self.retry_jitter}"
            )
        if self.fault_plan is not None:
            # a typo'd chaos spec fails at construction, not mid-run
            from kcmc_tpu_torch.utils.faults import FaultPlan

            FaultPlan.from_spec(self.fault_plan)
        if self.object_timeout_s <= 0.0:
            raise ValueError(
                f"object_timeout_s must be positive seconds, got "
                f"{self.object_timeout_s}"
            )
        if self.object_hedge_ms < 0.0:
            raise ValueError(
                "object_hedge_ms must be >= 0 milliseconds (0 disables "
                f"hedging), got {self.object_hedge_ms}"
            )
        if self.object_chunk_frames < 1:
            raise ValueError(
                f"object_chunk_frames must be >= 1 frame, got "
                f"{self.object_chunk_frames}"
            )
        if self.object_part_bytes < 1:
            raise ValueError(
                f"object_part_bytes must be >= 1 byte, got "
                f"{self.object_part_bytes}"
            )
        if self.writer_depth < 0:
            raise ValueError(
                f"writer_depth must be >= 0 batches (0 = synchronous "
                f"writes), got {self.writer_depth}"
            )
        if self.io_workers < 0:
            raise ValueError(
                f"io_workers must be >= 0 workers (0 = auto), got "
                f"{self.io_workers}"
            )
        if self.io_prefetch < 0:
            raise ValueError(
                f"io_prefetch must be >= 0 chunks (0 = auto: derived "
                f"from the dispatch window), got {self.io_prefetch}"
            )

    def _check_serve(self) -> None:
        """The reference's checks of the serve, tracing and SLO knobs,
        with its messages (kcmc_tpu/config.py:872-923, :960-970)."""
        if self.serve_queue_depth < 1:
            raise ValueError(
                f"serve_queue_depth must be >= 1 frame, got "
                f"{self.serve_queue_depth}"
            )
        if self.serve_inflight < 1:
            raise ValueError(
                f"serve_inflight must be >= 1 batch, got "
                f"{self.serve_inflight}"
            )
        if not 0.0 < self.serve_degrade_watermark <= 1.0:
            raise ValueError(
                "serve_degrade_watermark must be in (0, 1], got "
                f"{self.serve_degrade_watermark}"
            )
        if self.serve_journal_every < 1:
            raise ValueError(
                f"serve_journal_every must be >= 1 frame, got "
                f"{self.serve_journal_every}"
            )
        if self.serve_session_timeout_s < 0:
            raise ValueError(
                "serve_session_timeout_s must be >= 0 seconds (0 = "
                f"never reap), got {self.serve_session_timeout_s}"
            )
        if self.serve_io_timeout_s <= 0:
            raise ValueError(
                "serve_io_timeout_s must be positive seconds, got "
                f"{self.serve_io_timeout_s}"
            )
        if self.serve_backend_strikes < 0:
            raise ValueError(
                "serve_backend_strikes must be >= 0 failures (0 = "
                f"never quarantine), got {self.serve_backend_strikes}"
            )
        if not 0.0 <= self.serve_latency_fill_floor <= 1.0:
            raise ValueError(
                "serve_latency_fill_floor must be in [0, 1] (0 = "
                "deadlines always win), got "
                f"{self.serve_latency_fill_floor}"
            )
        if self.serve_latency_horizon_refresh_s <= 0:
            raise ValueError(
                "serve_latency_horizon_refresh_s must be positive "
                f"seconds, got {self.serve_latency_horizon_refresh_s}"
            )
        if self.serve_latency_starvation_limit < 1:
            raise ValueError(
                "serve_latency_starvation_limit must be >= 1 "
                "preemption (a batch session must eventually run), got "
                f"{self.serve_latency_starvation_limit}"
            )
        if self.fleet_probe_interval_s <= 0:
            raise ValueError(
                "fleet_probe_interval_s must be positive seconds, got "
                f"{self.fleet_probe_interval_s}"
            )
        if self.fleet_suspect_probes < 1:
            raise ValueError(
                "fleet_suspect_probes must be >= 1 probe, got "
                f"{self.fleet_suspect_probes}"
            )
        if self.fleet_dead_probes < self.fleet_suspect_probes:
            raise ValueError(
                "fleet_dead_probes must be >= fleet_suspect_probes "
                f"(a replica is SUSPECT before it is DEAD), got "
                f"{self.fleet_dead_probes} < {self.fleet_suspect_probes}"
            )
        if self.fleet_wedge_threshold_s <= 0:
            raise ValueError(
                "fleet_wedge_threshold_s must be positive seconds, got "
                f"{self.fleet_wedge_threshold_s}"
            )
        if not 0.0 < self.fleet_queue_watermark <= 1.0:
            raise ValueError(
                "fleet_queue_watermark must be in (0, 1] (1.0 = never "
                f"reject at the router), got {self.fleet_queue_watermark}"
            )
        if self.fleet_scale_cooldown_s < 0:
            raise ValueError(
                "fleet_scale_cooldown_s must be >= 0 seconds, got "
                f"{self.fleet_scale_cooldown_s}"
            )
        if self.trace_shard_cap <= 0:
            raise ValueError(
                "trace_shard_cap must be a positive span count, got "
                f"{self.trace_shard_cap}"
            )
        if self.slo_objectives:
            # a malformed spec fails at config time, naming the entry
            from kcmc_tpu_torch.obs.slo import parse_objectives

            parse_objectives(self.slo_objectives)

    def _check_warp(self) -> None:
        """The reference's warp-policy checks, with its messages."""
        if self.warp not in ("auto", "jnp", "pallas", "separable", "matrix"):
            raise ValueError(
                "warp must be 'auto', 'jnp', 'pallas', 'separable', or "
                f"'matrix', got {self.warp!r}"
            )
        if self.warp == "matrix" and self.model not in (
            "translation", "rigid", "affine", "homography"
        ):
            raise ValueError(
                "warp='matrix' resamples bounded-residual 2D matrix "
                f"transforms; model {self.model!r} needs "
                "warp='separable' (zoom-unbounded) or 'jnp' (or 'auto')"
            )
        if self.warp == "pallas" and self.model != "translation":
            raise ValueError(
                "warp='pallas' is the gather-free translation kernel; "
                f"model {self.model!r} needs warp='jnp' (or 'auto')"
            )
        if self.warp == "separable" and self.model not in (
            "translation", "rigid", "similarity", "affine", "homography"
        ):
            raise ValueError(
                "warp='separable' resamples affine-family transforms "
                "(plus homography via the affine+residual split); "
                f"model {self.model!r} needs warp='jnp' (or 'auto')"
            )

    def resolved_oriented(self) -> bool:
        if self.oriented is None:
            return self.model not in ("translation", "piecewise")
        return self.oriented

    def resolved_match_precision(self, on_accelerator: bool = True) -> str:
        """What "auto" resolves to, as in kcmc_tpu. Every variant gives
        the identical Hamming matrix; the port computes it with float32
        ±1 operands whatever the name says. "float32" also selects the
        unquantized describe route (ops/describe.py)."""
        if self.match_precision == "auto":
            if not on_accelerator or self.model == "rigid3d":
                return "bf16"
            return "int8"
        return self.match_precision

    def replace(self, **kw) -> CorrectorConfig:
        return dataclasses.replace(self, **kw)

    def unsupported(self) -> list[str]:
        """Non-default knobs the port does not implement yet, each with
        the ROADMAP.md queue-1 item that will port it (none left among
        the declared fields; `config_from_dict` guards the undeclared
        ones)."""
        return []


# Fields that shape failure recovery, IO scheduling or execution
# topology but never what a run computes (kcmc_tpu/config.py:1094-1170,
# for the fields the port declares): pinned to their defaults in
# correct_file's resume signature, so changing them between a killed
# run and its rerun resumes instead of restarting. `compile_cache_dir`
# only changes when kernels build, and the observability knobs only
# record what ran, never what a run computes: a killed run rerun with a
# trace added resumes. The serve knobs schedule when and where a stream
# runs, never what it computes: a journaled session resumes under others,
# and the fleet knobs move sessions between replicas, whose migration
# computes the same frames.
# `device_templates` and `plan_buckets` are deliberately not neutral.
SIG_NEUTRAL_FIELDS = frozenset({
    "fault_plan", "retry_attempts", "retry_backoff_s", "retry_backoff_max_s",
    "retry_jitter", "failover_backend", "degrade_mark_failed",
    "object_timeout_s", "object_hedge_ms", "object_chunk_frames", "object_part_bytes",
    "writer_depth", "io_workers", "io_prefetch",
    "mesh_devices", "collective_chunks", "upload_overlap", "compile_cache_dir",
    "trace_path", "frame_records_path", "heartbeat_s", "latency_telemetry",
    "trace_shard_dir", "trace_shard_cap", "slo_objectives",
    "serve_queue_depth", "serve_inflight", "serve_degrade_watermark",
    "serve_journal_dir", "serve_journal_every", "serve_session_timeout_s",
    "serve_io_timeout_s", "serve_backend_strikes", "serve_latency_fill_floor",
    "serve_latency_admission", "serve_latency_horizon_refresh_s",
    "serve_latency_starvation_limit",
    "fleet_probe_interval_s", "fleet_suspect_probes", "fleet_dead_probes",
    "fleet_wedge_threshold_s", "fleet_queue_watermark", "fleet_scale_cooldown_s",
})

# Fields that change what a run computes (kcmc_tpu/config.py:1172-1228,
# name for name): a change between a killed run and its rerun restarts
# the resume. Every field is in exactly one of the two registries
# (`_validate_field_classification`, and `check`'s config-registry
# pass statically).
SIG_AFFECTING_FIELDS = frozenset({
    "model", "max_keypoints", "detect_threshold", "nms_size", "border",
    "harris_k", "harris_window_sigma", "cand_tile", "oriented", "blur_sigma",
    "n_octaves", "octave_scale", "pyramid_refine",
    "ratio", "max_hamming", "mutual", "match_radius", "match_tile",
    "match_slack",
    "n_hypotheses", "inlier_threshold", "refine_iters", "seed", "budget_rungs",
    "early_exit_frac", "warm_start", "match_precision",
    "patch_grid", "patch_hypotheses", "refine_hypotheses", "patch_model",
    "patch_prior", "field_smooth_sigma", "field_passes", "refine_reach_scale",
    "global_threshold", "field_polish", "transform_polish", "polish_grid",
    "score_cap", "quality_metrics", "plan_buckets", "sanitize_input",
    "batch_size", "device_templates",
    "warp", "rescue_warp", "max_shear_px", "max_rotation_deg",
    "rescue_warn_fraction", "rescue_escalate", "max_flow_px",
    "max_projective_px", "max_scale_dev",
})

_FIELDS_VALIDATED = False


def _validate_field_classification() -> None:
    """Raise unless the registries partition the dataclass fields (the
    reference's check and messages, kcmc_tpu/config.py:1234-1264).

    Runs once per process (first config construction); cost after that
    is one global read. A field added to the dataclass but to neither
    registry fails HERE, at construction, instead of silently landing
    on one side of the resume signature."""
    global _FIELDS_VALIDATED
    if _FIELDS_VALIDATED:
        return
    names = {f.name for f in dataclasses.fields(CorrectorConfig)}
    unclassified = names - SIG_NEUTRAL_FIELDS - SIG_AFFECTING_FIELDS
    if unclassified:
        raise TypeError(
            "CorrectorConfig fields missing from the resume-signature "
            f"registries (config.py): {sorted(unclassified)} — add each "
            "to SIG_NEUTRAL_FIELDS or SIG_AFFECTING_FIELDS"
        )
    both = SIG_NEUTRAL_FIELDS & SIG_AFFECTING_FIELDS
    if both:
        raise TypeError(
            "CorrectorConfig fields classified as BOTH signature-"
            f"neutral and signature-affecting: {sorted(both)}"
        )
    stale = (SIG_NEUTRAL_FIELDS | SIG_AFFECTING_FIELDS) - names
    if stale:
        raise TypeError(
            "resume-signature registries list names that are not "
            f"CorrectorConfig fields: {sorted(stale)}"
        )
    _FIELDS_VALIDATED = True


# Reference fields the port does not declare and may drop: field ->
# (ROADMAP.md queue-1 item, or "none", and why dropping it changes
# nothing a run computes or writes).
DROPPED_FIELDS = {
    "donate_buffers": ("none", "an XLA buffer-aliasing knob; it changes no value"),
    "autotune_tiles": ("none", "chooses among Pallas tilings; each hand kernel has one "
                               "tiling and the knob changes no value"),
}


def port_fields(d: dict) -> dict:
    """The entries of `d` (reference field names) that the port declares.
    The fields of `DROPPED_FIELDS` are dropped; a name no config has
    raises TypeError."""
    names = {f.name for f in dataclasses.fields(CorrectorConfig)}
    kept = {}
    for k, v in d.items():
        if k in names:
            kept[k] = v
        elif k not in DROPPED_FIELDS:
            raise TypeError(f"unknown config field {k!r}")
    return kept


def config_from_dict(d: dict) -> CorrectorConfig:
    """A port config from a dict such as `dataclasses.asdict` of a
    `kcmc_tpu` CorrectorConfig, through `port_fields`."""
    return CorrectorConfig(**port_fields(d))
