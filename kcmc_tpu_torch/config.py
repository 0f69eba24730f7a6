"""Pipeline configuration of the PyTorch port.

The fields the ported slices (translation, rigid, similarity, affine,
homography, piecewise and rigid3d, single-scale or through the scale
pyramid, with the options of `correct()`, and the retry, fault and
file-streaming knobs of `correct_file()`) read, under the names and
defaults of `kcmc_tpu.config.CorrectorConfig`, so a JAX config carries
across with `config_from_dict(dataclasses.asdict(cfg))`. Knobs the port
does not implement yet (`plan_buckets`, `mesh_devices`) are still
declared: `unsupported()` names each non-default one with the ROADMAP.md
item that will port it, and the backend raises `NotImplementedError`
with that list instead of ignoring them. Warp
policies and knob values the reference rejects raise `ValueError` here
with the reference's messages (kcmc_tpu/config.py:750-767, :1018-1047).
"""

from __future__ import annotations

import dataclasses

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
    plan_buckets: tuple = ()
    mesh_devices: int = 0

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

    def __post_init__(self):
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
        self._check_robustness()
        object.__setattr__(self, "polish_grid", tuple(self.polish_grid))
        object.__setattr__(self, "patch_grid", tuple(self.patch_grid))
        object.__setattr__(self, "plan_buckets", tuple(self.plan_buckets))

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
        the ROADMAP.md queue-1 item that will port it."""
        out = []
        if self.plan_buckets:
            out.append("plan_buckets (ROADMAP queue 1 item 16)")
        if self.mesh_devices:
            out.append("mesh_devices (ROADMAP queue 1 item 17)")
        return out


# Fields that shape failure recovery, IO scheduling or execution
# topology but never what a run computes (kcmc_tpu/config.py:1094-1170,
# for the fields the port declares): pinned to their defaults in
# correct_file's resume signature, so changing them between a killed
# run and its rerun resumes instead of restarting. `device_templates`
# and `plan_buckets` are deliberately not neutral.
SIG_NEUTRAL_FIELDS = frozenset({
    "fault_plan", "retry_attempts", "retry_backoff_s", "retry_backoff_max_s",
    "retry_jitter", "failover_backend", "degrade_mark_failed",
    "writer_depth", "io_workers", "io_prefetch",
    "mesh_devices",
})


def config_from_dict(d: dict) -> CorrectorConfig:
    """A port config from a dict such as `dataclasses.asdict` of a
    `kcmc_tpu` CorrectorConfig: fields the port does not declare (serve,
    fleet, I/O and other layers outside this slice) are dropped."""
    names = {f.name for f in dataclasses.fields(CorrectorConfig)}
    return CorrectorConfig(**{k: v for k, v in d.items() if k in names})
