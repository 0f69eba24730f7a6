"""Pipeline configuration of the PyTorch port.

The fields the translation slice reads, under the names and defaults of
`kcmc_tpu.config.CorrectorConfig`, so a JAX config carries across with
`config_from_dict(dataclasses.asdict(cfg))`. Knobs the slice does not
implement are still declared: `unsupported()` names each non-default one
with the ROADMAP.md item that will port it, and the backend raises
`NotImplementedError` with that list instead of ignoring them.
"""

from __future__ import annotations

import dataclasses


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

    # matching
    ratio: float = 0.85
    max_hamming: int = 80
    mutual: bool = True
    match_radius: float | None = None
    match_precision: str = "auto"

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
    transform_polish: int = 1
    polish_grid: tuple[int, int] = (4, 4)

    # orchestration
    batch_size: int = 32
    quality_metrics: bool = False
    sanitize_input: bool = False
    plan_buckets: tuple = ()
    mesh_devices: int = 0

    def __post_init__(self):
        if self.blur_sigma <= 0.0:
            raise ValueError(f"blur_sigma must be positive, got {self.blur_sigma}")
        if self.harris_window_sigma <= 0.0:
            raise ValueError(
                "harris_window_sigma must be positive, got "
                f"{self.harris_window_sigma}"
            )
        if self.cand_tile < 1:
            raise ValueError(f"cand_tile must be >= 1, got {self.cand_tile}")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.match_precision not in ("auto", "float32", "bf16", "int8"):
            raise ValueError(
                "match_precision must be 'auto', 'float32', 'bf16', or "
                f"'int8', got {self.match_precision!r}"
            )
        if self.warp not in ("auto", "jnp", "pallas", "separable", "matrix"):
            raise ValueError(f"unknown warp policy {self.warp!r}")
        if int(self.transform_polish) < 0:
            raise ValueError(
                f"transform_polish must be >= 0, got {self.transform_polish}"
            )
        object.__setattr__(self, "polish_grid", tuple(self.polish_grid))
        object.__setattr__(self, "plan_buckets", tuple(self.plan_buckets))

    def resolved_oriented(self) -> bool:
        if self.oriented is None:
            return self.model not in ("translation", "piecewise")
        return self.oriented

    def resolved_match_precision(self, on_accelerator: bool = True) -> str:
        """What "auto" resolves to, as in kcmc_tpu. Every variant gives
        the identical Hamming matrix; the port computes it with float32
        ±1 operands whatever the name says."""
        if self.match_precision == "auto":
            if not on_accelerator or self.model == "rigid3d":
                return "bf16"
            return "int8"
        return self.match_precision

    def replace(self, **kw) -> CorrectorConfig:
        return dataclasses.replace(self, **kw)

    def unsupported(self) -> list[str]:
        """Non-default knobs this slice does not implement, each with
        the ROADMAP.md queue-1 item that will port it."""
        out = []
        if self.model != "translation":
            item = {
                "rigid": 11, "similarity": 11, "affine": 11,
                "homography": 11, "piecewise": 12, "rigid3d": 13,
            }.get(self.model, 11)
            out.append(f"model={self.model!r} (ROADMAP queue 1 item {item})")
        if self.resolved_oriented():
            out.append("oriented descriptors (ROADMAP queue 1 item 11)")
        if self.n_octaves > 1:
            out.append("n_octaves > 1 (ROADMAP queue 1 item 14)")
        if self.match_radius is not None:
            out.append("match_radius (ROADMAP queue 1 item 14)")
        if self.match_precision == "float32":
            out.append(
                "match_precision='float32' unquantized describe route "
                "(ROADMAP queue 1 item 15)"
            )
        if self.warm_start:
            out.append("warm_start (ROADMAP queue 1 item 15)")
        if self.quality_metrics:
            out.append("quality_metrics (ROADMAP queue 1 item 15)")
        if self.sanitize_input:
            out.append("sanitize_input (ROADMAP queue 1 item 15)")
        if self.plan_buckets:
            out.append("plan_buckets (ROADMAP queue 1 item 16)")
        if self.mesh_devices:
            out.append("mesh_devices (ROADMAP queue 1 item 17)")
        if self.warp not in ("auto", "pallas"):
            out.append(
                f"warp={self.warp!r}: the slice has the translation kernel "
                "only (ROADMAP queue 1 item 11)"
            )
        return out


def config_from_dict(d: dict) -> CorrectorConfig:
    """A port config from a dict such as `dataclasses.asdict` of a
    `kcmc_tpu` CorrectorConfig: fields the port does not declare (serve,
    fleet, I/O and other layers outside this slice) are dropped."""
    names = {f.name for f in dataclasses.fields(CorrectorConfig)}
    return CorrectorConfig(**{k: v for k, v in d.items() if k in names})
