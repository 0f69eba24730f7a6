"""Batched RANSAC consensus with an adaptive hypothesis-budget ladder,
and the fixed-budget estimator the piecewise field runs per patch.

Counterpart of `kcmc_tpu/ops/ransac.py::consensus_batch`. Hypotheses
are solved and scored as (frames x hypotheses) blocks. With
`budget_rungs` > 1 the budget splits into equal rung chunks: a frame
whose running best explains `early_exit_frac` of its valid matches stops
accepting candidates, and the loop — a Python loop over rungs with one
host check per rung, where the reference has a `lax.while_loop` — ends
once every frame is done. Per-hypothesis draws reproduce the
reference's bits: key = fold_in(frame_key, h), scores =
uniform(key, (N,)) over the valid matches, m argmax-and-mask rounds.
The winner gets IRLS refinement and a final least-squares polish on the
full match set (`_refine_polish`). A temporal warm-start seed
(`seed_transform`, `seed_ok`) scores as hypothesis zero: it only adds a
candidate, and a seed below the exit bar leaves the ladder to run as
unseeded (ransac.py:273-290).

`ransac_estimate` is the reference's single-frame entry
(ransac.py:435): without the ladder it is `_estimate_single`, whose
hypothesis keys come from `split(key, n_hypotheses)` instead of
`fold_in`, batched here over any leading axes (frames x patches in the
piecewise estimator) as one block of solves and scores.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kcmc_tpu_torch.models.transforms import TransformModel
from kcmc_tpu_torch.utils import prng

EARLY_EXIT_MIN_MATCHES = 24


class RansacResult(NamedTuple):
    transform: torch.Tensor  # (B, d+1, d+1)
    n_inliers: torch.Tensor  # (B,) int32
    inlier_mask: torch.Tensor  # (B, N) bool
    rms_residual: torch.Tensor  # (B,) float32


def _sample_indices(keys: torch.Tensor, valid: torch.Tensor, m: int) -> torch.Tensor:
    """(B, C, m) indices of m distinct valid matches per hypothesis key
    (keys (B, C, 2), valid (B, N)): top-m of iid uniform scores by m
    argmax-and-mask rounds (ransac.py:66). The uniforms are drawn only
    where a match is valid (uniform(key, N)'s bits there, since draw i
    hashes counter i); invalid matches score -1."""
    B, C = keys.shape[:2]
    N = valid.shape[-1]
    b, i = valid.nonzero(as_tuple=True)  # (V,) each
    y0, y1 = prng.threefry2x32(
        keys[b, :, 0], keys[b, :, 1], torch.zeros_like(i)[:, None], i[:, None]
    )  # (V, C)
    scores = torch.full((B, N, C), -1.0, device=keys.device)
    scores[b, i] = prng.bits_to_uniform(y0 ^ y1)
    scores = scores.transpose(1, 2)
    picks = []
    for _ in range(m):
        j = torch.argmax(scores, dim=-1)
        picks.append(j)
        scores = scores.scatter(-1, j[..., None], -1.0)
    return torch.stack(picks, dim=-1)


def _solve_sampled(model, hk, psrc, pdst, pvalid) -> torch.Tensor:
    """(B, C, d+1, d+1) minimal-sample solves, one per hypothesis key of
    hk (B, C, 2), sampled from the (B, N, d) pools."""
    m = int(model.min_samples)
    B, _, d = psrc.shape
    idx = _sample_indices(hk, pvalid, m)  # (B, C, m)
    C = idx.shape[1]
    flat = idx.reshape(B, C * m)
    s = torch.gather(psrc, 1, flat[..., None].expand(B, C * m, d))
    t = torch.gather(pdst, 1, flat[..., None].expand(B, C * m, d))
    w = torch.gather(pvalid, 1, flat).to(torch.float32)
    return model.solve(s.reshape(B, C, m, d), t.reshape(B, C, m, d), w.reshape(B, C, m))


def _count_inliers(model, M, src, dst, valid, thresh_sq) -> torch.Tensor:
    """Inlier counts of hypotheses M (B, C, d+1, d+1) on (B, N) matches."""
    r = model.residual(M, src[:, None], dst[:, None])  # (B, C, N)
    return ((r < thresh_sq) & valid[:, None]).sum(dim=-1).to(torch.int32)


def _refine_polish(model, M0, n0, src, dst, valid, thresh_sq, refine_iters):
    """IRLS refinement + final LS polish of each frame's winner on the
    full match set (ransac.py:99), batched over frames."""
    M, n_in = M0, n0
    for _ in range(refine_iters):
        r = model.residual(M, src, dst)
        w = ((r < thresh_sq) & valid).to(torch.float32)
        M2 = model.resolved_refine_solve(src, dst, w)
        r2 = model.residual(M2, src, dst)
        n2 = ((r2 < thresh_sq) & valid).sum(dim=-1).to(torch.int32)
        better = n2 >= n_in
        M = torch.where(better[:, None, None], M2, M)
        n_in = torch.maximum(n2, n_in)

    mask_f = (model.residual(M, src, dst) < thresh_sq) & valid
    nf = mask_f.sum(dim=-1)
    Mp = model.resolved_refine_solve(src, dst, mask_f.to(torch.float32))
    np_ = ((model.residual(Mp, src, dst) < thresh_sq) & valid).sum(dim=-1)
    keep = np_.to(torch.float32) >= 0.8 * nf.to(torch.float32)
    M = torch.where((keep & (np_ >= model.min_samples))[:, None, None], Mp, M)

    r = model.residual(M, src, dst)
    inl = (r < thresh_sq) & valid
    n_in = inl.sum(dim=-1)
    rms = torch.sqrt(
        torch.where(inl, r, torch.zeros_like(r)).sum(dim=-1)
        / torch.clamp(n_in.to(torch.float32), min=1.0)
    )
    return RansacResult(M, n_in.to(torch.int32), inl, rms)


def consensus_batch(
    model: TransformModel,
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    keys: torch.Tensor,
    n_hypotheses: int = 128,
    threshold: float = 2.0,
    refine_iters: int = 2,
    score_cap: int = 0,
    budget_rungs: int = 0,
    early_exit_frac: float = 0.7,
    seed_transform: torch.Tensor | None = None,
    seed_ok: torch.Tensor | bool | None = None,
) -> RansacResult:
    """Batched consensus: src/dst (B, N, d) with d = model.ndim (2, or 3
    for rigid3d), valid (B, N), keys (B, 2) per-frame keys. `score_cap`
    > 0 scores on an every-stride-th subset when N exceeds it (the first
    eighth of the hypotheses then samples the full set); `budget_rungs`
    > 1 arms the early-exit ladder. `seed_transform` ((d+1, d+1) shared
    or (B, d+1, d+1)) with `seed_ok` (bool, scalar or (B,)) is scored
    first, as the running best of the frames where it is ok."""
    B, N = src.shape[:2]
    dev = src.device
    m = int(model.min_samples)
    thresh_sq = float(torch.tensor(threshold * threshold, dtype=torch.float32))
    H = int(n_hypotheses)
    subset = bool(score_cap) and N > int(score_cap)
    if subset:
        stride = -(-N // int(score_cap))
        src_s, dst_s, valid_s = src[:, ::stride], dst[:, ::stride], valid[:, ::stride]
    else:
        src_s, dst_s, valid_s = src, dst, valid

    def solve_block(hids, psrc, pdst, pvalid):
        hk = prng.fold_in(keys[:, None, :], hids[None, :])  # (B, C, 2)
        return _solve_sampled(model, hk, psrc, pdst, pvalid)

    def score_block(Ms):
        return _count_inliers(model, Ms, src_s, dst_s, valid_s, thresh_sq)

    bidx = torch.arange(B, device=dev)

    def merge(best_M, best_s, done, Ms, scores):
        j = torch.argmax(scores, dim=1)  # earliest maximum
        cs = scores[bidx, j]
        upd = (cs > best_s) & ~done
        return (
            torch.where(upd[:, None, None], Ms[bidx, j], best_M),
            torch.where(upd, cs, best_s),
        )

    n_valid_s = valid_s.sum(dim=1).to(torch.int32)
    frac = torch.tensor(early_exit_frac, dtype=torch.float32, device=dev)
    exit_floor = torch.clamp(
        torch.ceil(frac * n_valid_s.to(torch.float32)).to(torch.int32), min=m + 2
    )
    can_exit = n_valid_s >= EARLY_EXIT_MIN_MATCHES

    dd = int(model.ndim) + 1
    best_M = torch.eye(dd, dtype=torch.float32, device=dev).expand(B, dd, dd).clone()
    best_s = torch.full((B,), -1, dtype=torch.int32, device=dev)
    if seed_transform is not None:
        seedM = torch.as_tensor(seed_transform, dtype=torch.float32, device=dev)
        seedM = seedM.expand(B, dd, dd)
        sok = torch.as_tensor(seed_ok, dtype=torch.bool, device=dev).expand(B)
        s_sc = _count_inliers(model, seedM[:, None], src_s, dst_s, valid_s, thresh_sq)[:, 0]
        best_s = torch.where(sok, s_sc, best_s)
        best_M = torch.where(sok[:, None, None], seedM, best_M)
    never_done = torch.zeros((B,), dtype=torch.bool, device=dev)

    def hyp_ids(lo, hi):
        return torch.arange(lo, hi, dtype=torch.int64, device=dev)

    rungs = int(budget_rungs)
    n_full = max(1, H // 8) if subset else 0
    if not (rungs > 1 and H > rungs):
        blocks = (
            [(hyp_ids(0, n_full), True), (hyp_ids(n_full, H), False)]
            if subset else [(hyp_ids(0, H), True)]
        )
        for hids, full in blocks:
            pool = (src, dst, valid) if full else (src_s, dst_s, valid_s)
            Ms = solve_block(hids, *pool)
            best_M, best_s = merge(best_M, best_s, never_done, Ms, score_block(Ms))
    else:
        done = can_exit & (best_s >= exit_floor)
        if subset:
            C = -(-(H - n_full) // rungs)
            blocks = [(hyp_ids(0, n_full), True)] + [
                (hyp_ids(n_full + i * C, n_full + (i + 1) * C), False)
                for i in range(rungs)
            ]
        else:
            C = -(-H // rungs)
            blocks = [(hyp_ids(i * C, (i + 1) * C), True) for i in range(rungs)]
        for hids, full in blocks:
            if bool(done.all()):
                break
            pool = (src, dst, valid) if full else (src_s, dst_s, valid_s)
            Ms = solve_block(hids, *pool)
            best_M, best_s = merge(best_M, best_s, done, Ms, score_block(Ms))
            done = done | (can_exit & (best_s >= exit_floor))

    if subset:
        n0 = _count_inliers(model, best_M[:, None], src, dst, valid, thresh_sq)[:, 0]
    else:
        n0 = best_s
    return _refine_polish(
        model, best_M, n0, src, dst, valid, thresh_sq, refine_iters
    )


def _estimate_single(model, src, dst, valid, keys, n_hypotheses, thresh_sq,
                     refine_iters, score_cap) -> RansacResult:
    """The fixed-budget estimator (ransac.py:370) on (B, N) problems:
    one key per hypothesis from split(key), every hypothesis scored, the
    first best kept, then `_refine_polish`."""
    B, N = src.shape[:2]
    H = int(n_hypotheses)
    subset = bool(score_cap) and N > int(score_cap)
    if subset:
        stride = -(-N // int(score_cap))
        src_s, dst_s, valid_s = src[:, ::stride], dst[:, ::stride], valid[:, ::stride]
    else:
        src_s, dst_s, valid_s = src, dst, valid
    hk = prng.split(keys, H)  # (B, H, 2)
    if subset:
        n_full = max(1, H // 8)
        Ms = torch.cat([
            _solve_sampled(model, hk[:, :n_full], src, dst, valid),
            _solve_sampled(model, hk[:, n_full:], src_s, dst_s, valid_s),
        ], dim=1)
    else:
        Ms = _solve_sampled(model, hk, src, dst, valid)
    scores = _count_inliers(model, Ms, src_s, dst_s, valid_s, thresh_sq)
    best = torch.argmax(scores, dim=1)  # first maximum
    M0 = Ms[torch.arange(B, device=src.device), best]
    if subset:
        n0 = _count_inliers(model, M0[:, None], src, dst, valid, thresh_sq)[:, 0]
    else:
        n0 = scores.gather(1, best[:, None])[:, 0]
    return _refine_polish(model, M0, n0, src, dst, valid, thresh_sq, refine_iters)


def ransac_estimate(
    model: TransformModel,
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    key: torch.Tensor,
    n_hypotheses: int = 128,
    threshold: float = 2.0,
    refine_iters: int = 2,
    score_cap: int = 0,
    budget_rungs: int = 0,
    early_exit_frac: float = 0.7,
    seed_transform: torch.Tensor | None = None,
    seed_ok: torch.Tensor | bool | None = None,
) -> RansacResult:
    """RANSAC estimate of `model` mapping src -> dst (ransac.py:435),
    batched over the leading axes: src/dst (..., N, 2), valid (..., N),
    key (..., 2). With budget_rungs <= 1 and no seed the fixed-budget
    estimator, else the laddered `consensus_batch` (a seeded call always
    takes it; the seed is (..., 3, 3) or shared (3, 3), `seed_ok` (...)
    or scalar). Result fields carry the leading axes."""
    lead = tuple(src.shape[:-2])
    N = src.shape[-2]
    src = src.reshape((-1, N, 2))
    dst = dst.reshape((-1, N, 2))
    valid = valid.reshape((-1, N))
    key = key.reshape((-1, 2))
    if int(budget_rungs) > 1 or seed_transform is not None:
        if seed_transform is not None:
            n = src.shape[0]
            seed_transform = torch.as_tensor(seed_transform).reshape((-1, 3, 3))
            seed_transform = seed_transform.expand(n, 3, 3)
            seed_ok = torch.as_tensor(seed_ok, dtype=torch.bool).reshape(-1).expand(n)
        res = consensus_batch(
            model, src, dst, valid, key, n_hypotheses=n_hypotheses,
            threshold=threshold, refine_iters=refine_iters, score_cap=score_cap,
            budget_rungs=budget_rungs, early_exit_frac=early_exit_frac,
            seed_transform=seed_transform, seed_ok=seed_ok,
        )
    else:
        thresh_sq = float(torch.tensor(threshold * threshold, dtype=torch.float32))
        res = _estimate_single(model, src, dst, valid, key, n_hypotheses, thresh_sq,
                               refine_iters, score_cap)
    return RansacResult(*(x.reshape(lead + tuple(x.shape[1:])) for x in res))
