"""Geometric transform models as weighted closed-form solves
(translation, rigid, similarity, affine, homography and rigid3d).

Counterpart of `kcmc_tpu/models/transforms.py` for every family,
batched over any leading axes instead of vmapped:

* `solve(src, dst, w)`: (..., N, d) points and (..., N) weights ->
  (..., d+1, d+1) homogeneous matrices (d = 2, or 3 for rigid3d);
* `residual(M, src, dst)`: squared reprojection error (..., N);
* `apply_transform(M, pts)`: homogeneous application with the
  projective divide clamped away from zero.

Degenerate solves (zero weight mass, non-finite results, collinear or
coincident samples) return the identity (`_guard`). The affine and
homography solves run in float32 on Hartley-conditioned normal
equations; on the card the backend turns TF32 off, so their small
matmuls stay full float32 as the reference's Precision.HIGHEST does.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

_EPS = 1e-8
_MIN_MASS = 1e-3


def _eye(shape, device, n: int = 3) -> torch.Tensor:
    return torch.eye(n, dtype=torch.float32, device=device).expand(
        tuple(shape) + (n, n)
    ).clone()


def apply_transform(M: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., d+1, d+1) applied to (..., N, d) points (broadcasting over
    the leading axes): ((x M00 + y M01) [+ z M02]) + M0d etc., divided by
    the clamped homogeneous coordinate."""
    d = pts.shape[-1]
    coords = [pts[..., j] for j in range(d)]

    def row(i):
        acc = coords[0] * M[..., i, 0, None]
        for j in range(1, d):
            acc = acc + coords[j] * M[..., i, j, None]
        return acc + M[..., i, d, None]

    w = row(d)
    w = torch.where(
        w.abs() < _EPS,
        torch.where(w < 0, torch.full_like(w, -_EPS), torch.full_like(w, _EPS)),
        w,
    )
    return torch.stack([row(i) for i in range(d)], dim=-1) / w[..., None]


def _guard(M: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Identity wherever M is non-finite or `ok` is False."""
    good = torch.isfinite(M).all(dim=-1).all(dim=-1) & ok
    eye = _eye(M.shape[:-2], M.device, M.shape[-1])
    return torch.where(good[..., None, None], M, eye)


def _wmean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    tot = torch.clamp(w.sum(dim=-1), min=_EPS)
    return (x * w[..., None]).sum(dim=-2) / tot[..., None]


def solve_translation(src, dst, w) -> torch.Tensor:
    t = _wmean(dst - src, w)
    M = _eye(t.shape[:-1], t.device)
    M[..., 0, 2] = t[..., 0]
    M[..., 1, 2] = t[..., 1]
    return _guard(M, w.sum(dim=-1) > _MIN_MASS)


def solve_rigid(src, dst, w) -> torch.Tensor:
    """Weighted 2D Procrustes (rotation + translation), closed form."""
    cs = _wmean(src, w)
    cd = _wmean(dst, w)
    s = src - cs[..., None, :]
    d = dst - cd[..., None, :]
    a = torch.sum(w * (s[..., 0] * d[..., 0] + s[..., 1] * d[..., 1]), dim=-1)
    b = torch.sum(w * (s[..., 0] * d[..., 1] - s[..., 1] * d[..., 0]), dim=-1)
    norm = torch.clamp(torch.sqrt(a * a + b * b), min=_EPS)
    c, sn = a / norm, b / norm
    M = _eye(c.shape, c.device)
    M[..., 0, 0] = c
    M[..., 0, 1] = -sn
    M[..., 1, 0] = sn
    M[..., 1, 1] = c
    M[..., 0, 2] = cd[..., 0] - (c * cs[..., 0] - sn * cs[..., 1])
    M[..., 1, 2] = cd[..., 1] - (sn * cs[..., 0] + c * cs[..., 1])
    # norm ~ 0: coincident or weightless samples define no rotation
    return _guard(M, (w.sum(dim=-1) > _MIN_MASS) & (norm > 1e-6))


def solve_similarity(src, dst, w) -> torch.Tensor:
    """Weighted 2D similarity (uniform scale, rotation, translation),
    closed form (Umeyama): the rigid Procrustes rotation with scale =
    |(a, b)| / sum w |src - c|^2."""
    cs = _wmean(src, w)
    cd = _wmean(dst, w)
    s = src - cs[..., None, :]
    d = dst - cd[..., None, :]
    a = torch.sum(w * (s[..., 0] * d[..., 0] + s[..., 1] * d[..., 1]), dim=-1)
    b = torch.sum(w * (s[..., 0] * d[..., 1] - s[..., 1] * d[..., 0]), dim=-1)
    var_s = torch.clamp(torch.sum(w * (s[..., 0] ** 2 + s[..., 1] ** 2), dim=-1), min=_EPS)
    norm = torch.clamp(torch.sqrt(a * a + b * b), min=_EPS)
    scale = norm / var_s
    c, sn = scale * (a / norm), scale * (b / norm)
    M = _eye(c.shape, c.device)
    M[..., 0, 0] = c
    M[..., 0, 1] = -sn
    M[..., 1, 0] = sn
    M[..., 1, 1] = c
    M[..., 0, 2] = cd[..., 0] - (c * cs[..., 0] - sn * cs[..., 1])
    M[..., 1, 2] = cd[..., 1] - (sn * cs[..., 0] + c * cs[..., 1])
    return _guard(M, (w.sum(dim=-1) > _MIN_MASS) & (norm > 1e-6))


def _normalization(pts: torch.Tensor, w: torch.Tensor):
    """Hartley conditioning: the similarity T mapping the weighted
    (..., N, 2) cloud to zero mean and RMS radius sqrt(2). Returns
    (T, T_inv), (..., 3, 3) each."""
    c = _wmean(pts, w)
    centered = pts - c[..., None, :]
    sq = torch.sum(centered * centered, dim=-1, keepdim=True)
    rms = torch.sqrt(_wmean(sq, w)[..., 0])
    s = torch.sqrt(torch.tensor(2.0, dtype=pts.dtype)) / torch.clamp(rms, min=_EPS)
    T = _eye(s.shape, pts.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., :2, 2] = -s[..., None] * c
    Tinv = _eye(s.shape, pts.device)
    Tinv[..., 0, 0] = 1.0 / s
    Tinv[..., 1, 1] = 1.0 / s
    Tinv[..., :2, 2] = c
    return T, Tinv


def _solve_sym3(M: torch.Tensor, rhs: torch.Tensor):
    """Closed-form (adjugate / Cramer) solve of symmetric (..., 3, 3)
    systems with (..., 3, k) right-hand sides. Returns (x, ok); ok is
    False where the determinant is below 1e-5 of the Hadamard bound
    a*e*i (collinear or duplicated minimal samples)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    e, f = M[..., 1, 1], M[..., 1, 2]
    i = M[..., 2, 2]
    A00 = e * i - f * f
    A01 = c * f - b * i
    A02 = b * f - c * e
    A11 = a * i - c * c
    A12 = b * c - a * f
    A22 = a * e - b * b
    det = a * A00 + b * A01 + c * A02
    adj = torch.stack([
        torch.stack([A00, A01, A02], dim=-1),
        torch.stack([A01, A11, A12], dim=-1),
        torch.stack([A02, A12, A22], dim=-1),
    ], dim=-2)
    ok = det.abs() > 1e-5 * (a * e * i).abs()
    den = torch.where(ok, det, torch.ones_like(det))
    return torch.matmul(adj, rhs) / den[..., None, None], ok


def _normalized_spread_ok(sn, dn, w) -> torch.Tensor:
    """False where the conditioned src or dst sample has ~zero spread
    (coincident points), which the ridge would otherwise turn into a
    finite collapse map."""
    tot = torch.clamp(w.sum(dim=-1), min=_EPS)
    ws = w[..., None]
    return (torch.sum(ws * sn * sn, dim=(-2, -1)) > 1e-6 * tot) & (
        torch.sum(ws * dn * dn, dim=(-2, -1)) > 1e-6 * tot
    )


def _affine_normal_system(src, dst, w):
    Ts, _ = _normalization(src, w)
    Td, Td_inv = _normalization(dst, w)
    sn = apply_transform(Ts, src)
    dn = apply_transform(Td, dst)
    A = torch.cat([sn, torch.ones_like(sn[..., :1])], dim=-1)  # (..., N, 3)
    Aw = A * w[..., None]
    M33 = torch.matmul(A.transpose(-1, -2), Aw) + _EPS * torch.eye(
        3, dtype=src.dtype, device=src.device
    )
    rhs = torch.matmul(Aw.transpose(-1, -2), dn)  # (..., 3, 2)
    return M33, rhs, Ts, Td_inv, _normalized_spread_ok(sn, dn, w)


def _affine_from_P(P, Ts, Td_inv, ok):
    """(..., 2, 3) normalized affine rows -> the denormalized map."""
    Mn = _eye(P.shape[:-2], P.device)
    Mn[..., :2, :] = P
    return _guard(torch.matmul(torch.matmul(Td_inv, Mn), Ts), ok)


def solve_affine(src, dst, w) -> torch.Tensor:
    """Weighted least-squares 6-DoF affine through the conditioned
    normal equations, solved in closed form (the hypothesis solver)."""
    M33, rhs, Ts, Td_inv, spread_ok = _affine_normal_system(src, dst, w)
    P, det_ok = _solve_sym3(M33, rhs)
    ok = det_ok & spread_ok & (w.sum(dim=-1) > _MIN_MASS)
    return _affine_from_P(P.transpose(-1, -2), Ts, Td_inv, ok)


def solve_affine_accurate(src, dst, w) -> torch.Tensor:
    """The same system solved by LU: the refine solver of IRLS and the
    photometric polish. An exactly singular system is degenerate (the
    reference's LU returns non-finite values there, which `_guard`
    replaces); `solve_ex` reports it without raising or syncing."""
    M33, rhs, Ts, Td_inv, spread_ok = _affine_normal_system(src, dst, w)
    P, info = torch.linalg.solve_ex(M33, rhs)
    ok = spread_ok & (w.sum(dim=-1) > _MIN_MASS) & (info == 0)
    return _affine_from_P(P.transpose(-1, -2), Ts, Td_inv, ok)


def _homography_normal_system(src, dst, w):
    """The weighted normalized-DLT (..., 9, 9) normal matrix, the
    conditioning maps and the spread check."""
    Ts, _ = _normalization(src, w)
    Td, Td_inv = _normalization(dst, w)
    sn = apply_transform(Ts, src)
    dn = apply_transform(Td, dst)
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], dim=-1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], dim=-1)
    rows = torch.cat([r1, r2], dim=-2)  # (..., 2N, 9)
    rw = torch.cat([w, w], dim=-1)
    ATA = torch.matmul(rows.transpose(-1, -2), rows * rw[..., None])
    return ATA, Ts, Td_inv, _normalized_spread_ok(sn, dn, w)


def _homography_from_h(h, Ts, Td_inv, w, ok):
    """(..., 9) normalized null vector -> the denormalized map, scaled
    to unit Frobenius norm, sign fixed by H[2, 2] >= 0, then divided by
    H[2, 2]."""
    H = torch.matmul(torch.matmul(Td_inv, h.reshape(h.shape[:-1] + (3, 3))), Ts)
    H = H / torch.clamp(torch.linalg.vector_norm(H, dim=(-2, -1)), min=_EPS)[..., None, None]
    H = H * torch.where(H[..., 2, 2] < 0, -1.0, 1.0)[..., None, None]
    h22 = H[..., 2, 2]
    denom = torch.where(h22.abs() > 1e-6, h22, torch.ones_like(h22))
    return _guard(H / denom[..., None, None], (w.sum(dim=-1) > _MIN_MASS) & ok)


def _cholesky_solve_unrolled(A: torch.Tensor, b: torch.Tensor, n: int):
    """Solve SPD (..., n, n) systems A x = b by an unrolled scalar
    Cholesky in the reference's operation order. Returns (x (..., n),
    ok): ok is False where a pivot collapsed below 1e-5 of its diagonal
    entry (rank deficiency: a degenerate sample)."""
    L = [[None] * n for _ in range(n)]
    ok = None
    for j in range(n):
        s = A[..., j, j] - sum(L[j][k] * L[j][k] for k in range(j))
        healthy = s > 1e-5 * A[..., j, j]
        ok = healthy if ok is None else ok & healthy
        d = torch.sqrt(torch.clamp(s, min=1e-12))
        L[j][j] = d
        for i in range(j + 1, n):
            L[i][j] = (A[..., i, j] - sum(L[i][k] * L[j][k] for k in range(j))) / d
    y = [None] * n
    for i in range(n):
        y[i] = (b[..., i] - sum(L[i][k] * y[k] for k in range(i))) / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        x[i] = (y[i] - sum(L[k][i] * x[k] for k in range(i + 1, n))) / L[i][i]
    return torch.stack(x, dim=-1), ok


def solve_homography(src, dst, w) -> torch.Tensor:
    """Weighted normalized DLT with h33 = 1: the 8x8 normal system by the
    unrolled Cholesky (the hypothesis solver)."""
    ATA, Ts, Td_inv, spread_ok = _homography_normal_system(src, dst, w)
    A8 = ATA[..., :8, :8] + 1e-8 * torch.eye(8, dtype=ATA.dtype, device=ATA.device)
    h8, ok = _cholesky_solve_unrolled(A8, -ATA[..., :8, 8], 8)
    h = torch.cat([h8, torch.ones_like(h8[..., :1])], dim=-1)
    return _homography_from_h(h, Ts, Td_inv, w, ok & spread_ok)


def solve_homography_accurate(src, dst, w) -> torch.Tensor:
    """Weighted normalized DLT, null vector by `eigh` of the 9x9 normal
    matrix: the refine solver of IRLS and the photometric polish."""
    ATA, Ts, Td_inv, spread_ok = _homography_normal_system(src, dst, w)
    _, evecs = torch.linalg.eigh(ATA)
    return _homography_from_h(evecs[..., :, 0], Ts, Td_inv, w, spread_ok)


def _cross_covariance3(src, dst, w, with_norms: bool = False):
    """Weighted (..., 3, 3) cross-covariance of the centred clouds and
    the centroids; with `with_norms` also the weighted squared norms of
    both centred clouds."""
    cs = _wmean(src, w)
    cd = _wmean(dst, w)
    sc = src - cs[..., None, :]
    dc = dst - cd[..., None, :]
    H = torch.matmul((sc * w[..., None]).transpose(-1, -2), dc)
    if not with_norms:
        return H, cs, cd
    ga = torch.sum(w[..., None] * sc * sc, dim=(-2, -1))
    gb = torch.sum(w[..., None] * dc * dc, dim=(-2, -1))
    return H, cs, cd, ga, gb


def _det3(a, b, c, d, e, f, g, h, i):
    """Determinant of the rows [a b c; d e f; g h i] (scalars or
    tensors), in the reference's cofactor order."""
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _cross4(r0, r1, r2) -> torch.Tensor:
    """Generalized cross product of three (..., 4) vectors: a vector
    orthogonal to all three."""
    comps = []
    for i in range(4):
        c = [j for j in range(4) if j != i]
        m = _det3(
            r0[..., c[0]], r0[..., c[1]], r0[..., c[2]],
            r1[..., c[0]], r1[..., c[1]], r1[..., c[2]],
            r2[..., c[0]], r2[..., c[1]], r2[..., c[2]],
        )
        comps.append(((-1.0) ** i) * m)
    return torch.stack(comps, dim=-1)


def _embed3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    M = _eye(R.shape[:-2], R.device, 4)
    M[..., :3, :3] = R
    M[..., :3, 3] = t
    return M


def solve_rigid3d(src, dst, w) -> torch.Tensor:
    """Weighted Kabsch through the quaternion characteristic polynomial
    (the hypothesis solver): the largest eigenvalue of Horn's 4x4
    matrix by 12 Newton steps from the (GA + GB) / 2 upper bound, its
    eigenvector as the largest of four generalized cross products of
    rows of K - lambda I. Identity for zero weight mass, non-finite
    math or a vanishing quaternion."""
    H, cs, cd, ga, gb = _cross_covariance3(src, dst, w, with_norms=True)
    xx, xy, xz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    yx, yy, yz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    zx, zy, zz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    rows = (
        (xx + yy + zz, yz - zy, zx - xz, xy - yx),
        (yz - zy, xx - yy - zz, xy + yx, zx + xz),
        (zx - xz, xy + yx, -xx + yy - zz, yz + zy),
        (xy - yx, zx + xz, yz + zy, -xx - yy + zz),
    )
    K = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    K2 = torch.matmul(K, K)
    c2 = -0.5 * K2.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    c1 = -torch.sum(K2 * K, dim=(-2, -1)) / 3.0
    dets = []
    for j in range(4):
        c = [k for k in range(4) if k != j]
        m = _det3(
            K[..., 1, c[0]], K[..., 1, c[1]], K[..., 1, c[2]],
            K[..., 2, c[0]], K[..., 2, c[1]], K[..., 2, c[2]],
            K[..., 3, c[0]], K[..., 3, c[1]], K[..., 3, c[2]],
        )
        dets.append(((-1.0) ** j) * K[..., 0, j] * m)
    c0 = dets[0] + dets[1] + dets[2] + dets[3]

    lam = 0.5 * (ga + gb)
    for _ in range(12):
        p = ((lam * lam + c2) * lam + c1) * lam + c0
        dp = (4.0 * lam * lam + 2.0 * c2) * lam + c1
        lam = lam - p / torch.where(dp.abs() > _EPS, dp, torch.full_like(dp, _EPS))

    A = K - lam[..., None, None] * torch.eye(4, dtype=K.dtype, device=K.device)
    a0, a1, a2, a3 = (A[..., i, :] for i in range(4))
    cands = torch.stack(
        [_cross4(a1, a2, a3), _cross4(a0, a2, a3), _cross4(a0, a1, a3),
         _cross4(a0, a1, a2)],
        dim=-2,
    )  # (..., 4 candidates, 4)
    norms = torch.sum(cands * cands, dim=-1)
    best = torch.argmax(norms, dim=-1)  # first maximum
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    nmax = norms.amax(dim=-1)
    q = q / torch.sqrt(torch.clamp(nmax, min=_EPS))[..., None]
    a, b, c, d = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        torch.stack([a * a + b * b - c * c - d * d, 2 * (b * c - a * d),
                     2 * (b * d + a * c)], dim=-1),
        torch.stack([2 * (b * c + a * d), a * a - b * b + c * c - d * d,
                     2 * (c * d - a * b)], dim=-1),
        torch.stack([2 * (b * d - a * c), 2 * (c * d + a * b),
                     a * a - b * b - c * c + d * d], dim=-1),
    ], dim=-2)
    t = cd - torch.matmul(R, cs[..., None])[..., 0]
    # any unit quaternion is a proper isometry: a degenerate sample only
    # loses the vote, so only the hard failures fall back to identity
    ok = (w.sum(dim=-1) > _MIN_MASS) & (nmax > 1e-30)
    return _guard(_embed3(R, t), ok)


def solve_rigid3d_accurate(src, dst, w) -> torch.Tensor:
    """Weighted Kabsch through the 3x3 SVD of the cross-covariance with
    the determinant fix (the refine solver of IRLS)."""
    H, cs, cd = _cross_covariance3(src, dst, w)
    U, _, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    det = torch.linalg.det(torch.matmul(V, Ut))
    Dm = torch.diag_embed(
        torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    )
    R = torch.matmul(torch.matmul(V, Dm), Ut)
    t = cd - torch.matmul(R, cs[..., None])[..., 0]
    return _guard(_embed3(R, t), w.sum(dim=-1) > _MIN_MASS)


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
    "rigid": TransformModel("rigid", ndim=2, dof=3, min_samples=2, solve=solve_rigid),
    "similarity": TransformModel(
        "similarity", ndim=2, dof=4, min_samples=2, solve=solve_similarity
    ),
    "affine": TransformModel(
        "affine", ndim=2, dof=6, min_samples=3,
        solve=solve_affine, refine_solve=solve_affine_accurate,
    ),
    "homography": TransformModel(
        "homography", ndim=2, dof=8, min_samples=4,
        solve=solve_homography, refine_solve=solve_homography_accurate,
    ),
    "rigid3d": TransformModel(
        "rigid3d", ndim=3, dof=6, min_samples=3,
        solve=solve_rigid3d, refine_solve=solve_rigid3d_accurate,
    ),
}


def get_model(name: str) -> TransformModel:
    # piecewise is handled at the pipeline level (ops/piecewise.py)
    if name not in MODELS:
        raise ValueError(f"unknown transform model {name!r}; available: {sorted(MODELS)}")
    return MODELS[name]
