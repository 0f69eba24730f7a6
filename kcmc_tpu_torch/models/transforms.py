"""Geometric transform models as weighted closed-form solves (translation).

Counterpart of `kcmc_tpu/models/transforms.py` for the translation
family, batched over any leading axes instead of vmapped:

* `solve(src, dst, w)`: (..., N, 2) points and (..., N) weights ->
  (..., 3, 3) homogeneous matrices (weighted mean displacement);
* `residual(M, src, dst)`: squared reprojection error (..., N);
* `apply_transform(M, pts)`: homogeneous application with the
  projective divide clamped away from zero.

Degenerate solves (zero weight mass, non-finite results) return the
identity (`_guard`). The other models raise NotImplementedError naming
the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

_EPS = 1e-8
_MIN_MASS = 1e-3


def _eye(shape, device) -> torch.Tensor:
    return torch.eye(3, dtype=torch.float32, device=device).expand(
        tuple(shape) + (3, 3)
    ).clone()


def apply_transform(M: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) applied to (..., N, 2) points (broadcasting over the
    leading axes): (x M00 + y M01) + M02 etc., divided by the clamped
    homogeneous coordinate."""
    x, y = pts[..., 0], pts[..., 1]

    def row(i):
        return x * M[..., i, 0, None] + y * M[..., i, 1, None] + M[..., i, 2, None]

    w = row(2)
    w = torch.where(
        w.abs() < _EPS,
        torch.where(w < 0, torch.full_like(w, -_EPS), torch.full_like(w, _EPS)),
        w,
    )
    return torch.stack([row(0), row(1)], dim=-1) / w[..., None]


def _guard(M: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Identity wherever M is non-finite or `ok` is False."""
    good = torch.isfinite(M).all(dim=-1).all(dim=-1) & ok
    return torch.where(good[..., None, None], M, _eye(M.shape[:-2], M.device))


def _wmean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    tot = torch.clamp(w.sum(dim=-1), min=_EPS)
    return (x * w[..., None]).sum(dim=-2) / tot[..., None]


def solve_translation(src, dst, w) -> torch.Tensor:
    t = _wmean(dst - src, w)
    M = _eye(t.shape[:-1], t.device)
    M[..., 0, 2] = t[..., 0]
    M[..., 1, 2] = t[..., 1]
    return _guard(M, w.sum(dim=-1) > _MIN_MASS)


@dataclasses.dataclass(frozen=True)
class TransformModel:
    name: str
    ndim: int
    dof: int
    min_samples: int
    solve: Callable
    refine_solve: Callable | None = None

    @property
    def resolved_refine_solve(self) -> Callable:
        return self.refine_solve if self.refine_solve is not None else self.solve

    def apply(self, M, pts):
        return apply_transform(M, pts)

    def residual(self, M, src, dst) -> torch.Tensor:
        diff = apply_transform(M, src) - dst
        return torch.sum(diff * diff, dim=-1)


MODELS: dict[str, TransformModel] = {
    "translation": TransformModel(
        "translation", ndim=2, dof=2, min_samples=1, solve=solve_translation
    ),
}


def get_model(name: str) -> TransformModel:
    if name not in MODELS:
        raise NotImplementedError(
            f"transform model {name!r} is not ported yet (ROADMAP.md queue 1 "
            "items 11-13); the port has: " + ", ".join(sorted(MODELS))
        )
    return MODELS[name]
