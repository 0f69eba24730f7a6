"""The homography and rigid slices of the PyTorch port against kcmc_tpu:
`prng.split`, `segment_by_key`, the rigid and homography solvers, K6's
plain version against the Pallas kernel in interpret mode, the small-K
oriented describe route against both reference routes, homography
consensus, and MotionCorrector(model="homography" / "rigid") end to end
against backend="jax"."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu.models import transforms as jtransforms
from kcmc_tpu.ops import describe as jdescribe
from kcmc_tpu.ops import dispatch as jdispatch
from kcmc_tpu.ops import pallas_patch as pp
from kcmc_tpu.ops.detect import Keypoints as JKeypoints
from kcmc_tpu.ops.detect import gaussian_blur as jgaussian_blur
from kcmc_tpu.ops.ransac import consensus_batch as j_consensus
from kcmc_tpu.utils import metrics as jmetrics
from kcmc_tpu.utils import synthetic as jsynthetic
from kcmc_tpu_torch.models import transforms as ttransforms
from kcmc_tpu_torch.ops import cuda_patch
from kcmc_tpu_torch.ops import describe as tdescribe
from kcmc_tpu_torch.ops import dispatch as tdispatch
from kcmc_tpu_torch.ops.detect import Keypoints as TKeypoints
from kcmc_tpu_torch.ops.ransac import consensus_batch as t_consensus
from kcmc_tpu_torch.utils import prng

CORNERS = np.array([[0, 0], [511, 0], [0, 511], [511, 511], [255.5, 255.5]], np.float32)


def _px(a, b, pts=CORNERS):
    """Largest displacement between two (..., 3, 3) maps over the control
    points, in pixels (projective divide included)."""
    def ap(M):
        h = np.einsum("...ij,nj->...ni", M, np.concatenate([pts, np.ones((len(pts), 1))], 1))
        return h[..., :2] / h[..., 2:]
    return float(np.abs(ap(a.astype(np.float64)) - ap(b.astype(np.float64))).max())


def _homographies(rng, B, persp=2e-5):
    M = np.tile(np.eye(3), (B, 1, 1))
    for b in range(B):
        th = rng.uniform(-0.05, 0.05)
        c, s = np.cos(th), np.sin(th)
        M[b, :2, :2] = [[c, -s], [s, c]]
        M[b, :2, 2] = rng.uniform(-10, 10, 2)
        M[b, 2, :2] = rng.uniform(-persp, persp, 2)
    return M.astype(np.float32)


def _apply(M, pts):
    h = np.concatenate([pts, np.ones(pts.shape[:-1] + (1,), pts.dtype)], -1)
    h = np.einsum("bij,bnj->bni", M.astype(np.float64), h)
    return (h[..., :2] / h[..., 2:]).astype(np.float32)


# ---------------------------------------------------------------------------
# primitives


@pytest.mark.parametrize("seed,n", [(0, 2), (7, 64), (123456789, 33), (2**31 + 5, 512)])
def test_split_matches_jax(seed, n):
    """Bit-identical to jax.random.split (threefry, partitionable), also
    batched over leading key axes and for keys from fold_in."""
    want = np.asarray(jax.random.key_data(jax.random.split(jax.random.key(seed), n)))
    got = prng.split(prng.key(seed), n).numpy()
    np.testing.assert_array_equal(want.astype(np.int64), got)
    ks = prng.fold_in(prng.key(seed), torch.arange(3))
    batched = prng.split(ks, n).numpy()
    for i in range(3):
        jk = jax.random.fold_in(jax.random.key(seed), i)
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(jax.random.split(jk, n))).astype(np.int64),
            batched[i],
        )


def test_segment_by_key_identical():
    """Slots and flags equal the reference's, with one group overfull
    (its last items dropped), the sentinel and out-of-range keys."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 17, (3, 200)).astype(np.int32)  # 16 = sentinel
    keys[1, :90] = 5  # overfull: 90 > cap
    keys[2, :4] = [-2, 40, 16, 3]
    got_idx, got_ok = tdispatch.segment_by_key(torch.as_tensor(keys), 16, 32)
    for b in range(3):
        wi, wo = jdispatch.segment_by_key(jnp.asarray(keys[b]), 16, 32)
        np.testing.assert_array_equal(np.asarray(wi), got_idx[b].numpy())
        np.testing.assert_array_equal(np.asarray(wo), got_ok[b].numpy())
    assert got_ok[1, 5].all() and got_idx[1, 5].tolist() == list(range(32))


# ---------------------------------------------------------------------------
# solvers


@pytest.mark.parametrize(
    "name", ["solve_rigid", "solve_homography", "solve_homography_accurate"]
)
def test_rigid_homography_solvers_match(name):
    """Weighted solves on 48 noisy points per batch entry: the linear
    part within 1e-5 of the reference, the map within 1e-3 px over a
    512^2 frame. The two sum the centroids and the (9, 9) normal matrix
    in another order, and a float32 sum of 512-px coordinates rounds at
    3e-5 px, which the null-vector solve amplifies in the translation."""
    rng = np.random.default_rng(0)
    B, N = 12, 48
    src = rng.uniform(0, 512, (B, N, 2)).astype(np.float32)
    M = _homographies(rng, B, persp=0.0 if name == "solve_rigid" else 2e-5)
    dst = (_apply(M, src) + rng.normal(0, 0.1, (B, N, 2))).astype(np.float32)
    w = (rng.uniform(size=(B, N)) < 0.8).astype(np.float32)
    want = np.asarray(jax.vmap(getattr(jtransforms, name))(src, dst, w))
    got = getattr(ttransforms, name)(*(torch.as_tensor(a) for a in (src, dst, w))).numpy()
    assert np.abs(want[:, :2, :2] - got[:, :2, :2]).max() <= 1e-5
    assert np.abs(want[:, 2] - got[:, 2]).max() <= 1e-7
    assert _px(want, got) <= 1e-3
    assert _px(got, M) < 0.5  # and they fit the map


@pytest.mark.parametrize("name", ["solve_rigid", "solve_homography"])
def test_minimal_samples_and_degenerate_cases(name):
    """Minimal samples (2 for rigid, 4 for homography): well-spread ones
    agree with the reference within 1e-3 px on the sample's own points
    (a minimal homography is exactly determined there; extrapolated to
    the frame corners its perspective terms carry the float32 rounding
    of a near-singular 8x8 system, up to 0.1 px apart on this draw);
    collinear, duplicated, coincident and weightless samples give the
    identity from both, as does the refine solver for coincident and
    weightless ones."""
    m = 2 if name == "solve_rigid" else 4
    rng = np.random.default_rng(1)
    B = 12
    src = rng.uniform(50, 450, (B, m, 2)).astype(np.float32)
    M = _homographies(rng, B, persp=0.0 if m == 2 else 2e-5)
    dst = (_apply(M, src) + rng.normal(0, 0.3, (B, m, 2))).astype(np.float32)
    w = np.ones((B, m), np.float32)
    if m == 4:
        src[8, 2] = (src[8, 0] + src[8, 1]) / 2  # three collinear
        src[8, 3] = src[8, 0] + 2 * (src[8, 1] - src[8, 0])
    src[9, 1] = src[9, 0]  # duplicated
    dst[9, 1] = dst[9, 0]
    src[10, :] = src[10, 0]  # coincident
    dst[10, :] = dst[10, 0]
    w[11] = 0.0  # weightless
    ts = [torch.as_tensor(a) for a in (src, dst, w)]
    eye = np.eye(3, dtype=np.float32)
    want = np.asarray(jax.vmap(getattr(jtransforms, name))(src, dst, w))
    got = getattr(ttransforms, name)(*ts).numpy()
    for b in range(8):
        assert _px(want[b], got[b], src[b]) <= 1e-3
        if m == 4:  # exactly determined: the sample maps onto its matches
            assert np.abs(_apply(got[b:b + 1], src[b:b + 1]) - dst[b]).max() <= 1e-3
    for b in ((8, 9, 10, 11) if m == 4 else (9, 10, 11)):
        np.testing.assert_array_equal(got[b], eye)
        np.testing.assert_array_equal(want[b], eye)
    if m == 4:
        acc = ttransforms.solve_homography_accurate(*ts).numpy()
        for b in (10, 11):
            np.testing.assert_array_equal(acc[b], eye)


# ---------------------------------------------------------------------------
# K6 and the small-K oriented route


def test_k6_plain_matches_pallas_interpret():
    """Patches bit-identical; moments within 1e-6 of max|m| (interpret
    mode sums in float32 in XLA's order, K6 in float64 rounded once);
    the orientation bins identical."""
    rng = np.random.default_rng(1)
    p = jnp.asarray(rng.normal(size=(2, 160, 170)).astype(np.float32)).astype(jnp.bfloat16)
    xy = rng.uniform(0, 130, (2, 64, 2)).astype(np.float32)
    xy[0, :3] = [[0.5, 0.5], [64.49, 20.5], [129.99, 129.0]]
    wpb, w10, w01 = pp.extract_blended(p, jnp.asarray(xy), 32, with_moments=True,
                                       interpret=True, out_dtype=jnp.bfloat16)
    pt = torch.as_tensor(np.array(p.astype(jnp.float32))).to(torch.bfloat16)
    gpb, g10, g01 = cuda_patch.extract_blended(pt, torch.as_tensor(xy), 32, with_moments=True)
    np.testing.assert_array_equal(np.asarray(wpb.astype(jnp.float32)), gpb.float().numpy())
    w10, w01 = np.asarray(w10)[..., 0], np.asarray(w01)[..., 0]
    scale = max(np.abs(w10).max(), np.abs(w01).max())
    assert np.abs(w10 - g10.numpy()).max() <= 1e-6 * scale
    assert np.abs(w01 - g01.numpy()).max() <= 1e-6 * scale
    wb = np.asarray(jdescribe._quantize_bins(jnp.arctan2(w01, w10)))
    gb = tdescribe._quantize_bins(torch.atan2(g01, g10)).numpy()
    np.testing.assert_array_equal(wb, gb)
    # K6's patches are K2's
    np.testing.assert_array_equal(
        gpb.view(torch.int16).numpy(),
        cuda_patch.extract_blended(pt, torch.as_tensor(xy), 32).view(torch.int16).numpy(),
    )


def test_binned_select_drops_as_reference():
    """A dominant orientation overflows its bin: the same keypoints are
    dropped (zero values) and every kept value is identical."""
    rng = np.random.default_rng(2)
    B, K, L = 2, 256, (2 * tdescribe.ROT_RADIUS + 1) ** 2
    flat = rng.normal(size=(B, K, L)).astype(np.float32)
    bins = rng.integers(0, 16, (B, K)).astype(np.int32)
    bins[0, ::2] = 3  # 128 keypoints in bin 3, cap 32
    valid = rng.uniform(size=(B, K)) < 0.9
    fj = jnp.asarray(flat).astype(jnp.bfloat16)
    want = np.stack([
        np.asarray(jdescribe._binned_select(fj[b], jnp.asarray(bins[b]), jnp.asarray(valid[b]))
                   .astype(jnp.float32))
        for b in range(B)
    ])
    ft = torch.as_tensor(np.asarray(fj.astype(jnp.float32))).to(torch.bfloat16)
    got = tdescribe._binned_select(ft, torch.as_tensor(bins).long(), torch.as_tensor(valid))
    np.testing.assert_array_equal(want, got.float().numpy())
    dropped = (got[0] == 0).all(dim=-1) & torch.as_tensor(valid[0])
    assert int(dropped.sum()) > 50


@pytest.fixture(scope="module")
def small_k_case():
    """One 128x128 frame with K = 512 keypoints (below the bins-first
    gate), the last 32 invalid."""
    rng = np.random.default_rng(9)
    H = W = 128
    K = 512
    img = (jsynthetic.render_scene(rng, (H, W), n_blobs=120) * 300.0).astype(np.float32)
    xy = rng.uniform(2, W - 3, size=(1, K, 2)).astype(np.float32)
    xy[0, :4] = [[3.0, 3.0], [64.5, 20.5], [100.49, 7.51], [124.0, 124.0]]
    valid = np.ones((1, K), bool)
    valid[0, -32:] = False
    score = np.linspace(1, 0.1, K, dtype=np.float32)[None]
    return img[None], xy, valid, score


def test_small_k_words_match_both_reference_routes(small_k_case):
    """Identical words to the reference's small-K Pallas route
    (interpret mode: K6 + `_binned_select`) and to its single-frame XLA
    route (in-patch moments summed in another order; a bin can flip
    only for an angle within ~1e-6 rad of a bin edge, none does here)."""
    fr, xy, valid, score = small_k_case
    smooth = np.asarray(jax.vmap(lambda f: jgaussian_blur(f, 2.0))(jnp.asarray(fr)))
    jk = JKeypoints(jnp.asarray(xy), jnp.asarray(score), jnp.asarray(valid))
    want = np.asarray(jdescribe.describe_keypoints_batch(
        jnp.asarray(fr), jk, oriented=True, use_pallas=True, interpret=True,
        smooth=jnp.asarray(smooth),
    )).astype(np.int64)
    tk = TKeypoints(*(torch.as_tensor(a) for a in (xy, score, valid)))
    got = tdescribe.describe_keypoints_batch(
        torch.as_tensor(fr), tk, oriented=True, smooth=torch.as_tensor(smooth)
    ).numpy()
    assert (got[valid] != 0).any(axis=-1).all() and not got[~valid].any()
    np.testing.assert_array_equal(want, got)
    single = np.asarray(jdescribe.describe_keypoints(
        jnp.asarray(fr[0]), JKeypoints(*(a[0] for a in jk)), oriented=True,
        smooth=jnp.asarray(smooth[0]),
    )).astype(np.int64)
    flips = int((single != got[0]).any(axis=-1).sum())
    assert flips == 0, f"{flips} keypoints differ from the in-patch route"


# ---------------------------------------------------------------------------
# consensus


def _match_case(B=4, N=512, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 512, (B, N, 2)).astype(np.float32)
    M = _homographies(rng, B)
    dst = (_apply(M, src) + rng.normal(0, 0.4, (B, N, 2))).astype(np.float32)
    out = rng.uniform(size=(B, N)) < 0.4
    dst[out] = rng.uniform(0, 512, (int(out.sum()), 2)).astype(np.float32)
    valid = rng.uniform(size=(B, N)) < 0.6
    valid[2, 30:] = False
    valid[3] = False
    return src, dst, valid, M


def _dlt64(src, dst, w):
    """The weighted normalized DLT in float64 (numpy): the exact
    counterpart of `solve_homography_accurate`."""
    src, dst, w = (np.asarray(a, np.float64) for a in (src, dst, w))

    def cond(p):
        c = (w[:, None] * p).sum(0) / w.sum()
        s = np.sqrt(2.0) / np.sqrt((w * ((p - c) ** 2).sum(1)).sum() / w.sum())
        return np.array([[s, 0.0, -s * c[0]], [0.0, s, -s * c[1]], [0.0, 0.0, 1.0]])

    Ts, Td = cond(src), cond(dst)
    (x, y), (u, v) = (src @ Ts[:2, :2].T + Ts[:2, 2]).T, (dst @ Td[:2, :2].T + Td[:2, 2]).T
    z, o = np.zeros_like(x), np.ones_like(x)
    A = np.concatenate([np.stack([-x, -y, -o, z, z, z, u * x, u * y, u], 1),
                        np.stack([z, z, z, -x, -y, -o, v * x, v * y, v], 1)])
    ww = np.concatenate([w, w])
    h = np.linalg.eigh(A.T @ (A * ww[:, None]))[1][:, 0]
    H = np.linalg.inv(Td) @ h.reshape(3, 3) @ Ts
    return H / H[2, 2]


def test_homography_consensus_identical_inliers():
    """Identical inlier counts and inlier masks; transforms within 2e-3
    px over the control points of a 512^2 frame, and no farther from a
    float64 solve on the same inliers than the reference is. The final
    fit is the eigh null vector of a (9, 9) float32 normal matrix summed
    in another order than XLA's, with another float32 eigensolver; the
    reference's own float32 error is of the same size as the gap between
    the two (1.3e-3 px at the corners on this draw's 12-inlier frame), so
    a tighter bound would test LAPACK's rounding, not the port."""
    src, dst, valid, M = _match_case()
    B = src.shape[0]
    idx = np.arange(5, 5 + B, dtype=np.int32)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(jnp.asarray(idx))
    tkeys = prng.fold_in(prng.key(0), torch.as_tensor(idx))
    kw = dict(n_hypotheses=128, threshold=2.0, refine_iters=2, score_cap=512,
              budget_rungs=4, early_exit_frac=0.7)
    want = j_consensus(jtransforms.get_model("homography"), jnp.asarray(src),
                       jnp.asarray(dst), jnp.asarray(valid), jkeys, **kw)
    got = t_consensus(ttransforms.get_model("homography"),
                      *(torch.as_tensor(a) for a in (src, dst, valid)), tkeys, **kw)
    np.testing.assert_array_equal(np.asarray(want.n_inliers), got.n_inliers.numpy())
    np.testing.assert_array_equal(np.asarray(want.inlier_mask), got.inlier_mask.numpy())
    assert _px(np.asarray(want.transform)[:3], got.transform.numpy()[:3]) <= 2e-3
    for b in range(3):
        exact = _dlt64(src[b], dst[b], np.asarray(want.inlier_mask)[b])
        ref_err = _px(np.asarray(want.transform)[b], exact)
        port_err = _px(got.transform.numpy()[b], exact)
        assert port_err <= ref_err + 1e-4, (b, port_err, ref_err)
    assert _px(got.transform.numpy()[:2], M[:2]) < 0.5
    np.testing.assert_array_equal(got.transform.numpy()[3], np.eye(3, dtype=np.float32))


# ---------------------------------------------------------------------------
# the slices


@pytest.fixture(scope="module", params=["homography", "rigid"])
def matrix_runs(request):
    model = request.param
    data = jsynthetic.make_drift_stack(8, (128, 128), model=model, seed=0)
    want = kcmc_tpu.MotionCorrector(model=model, backend="jax").correct(data.stack)
    got = {w: kcmc_tpu_torch.MotionCorrector(model=model, device="cpu", warp=w)
           .correct(data.stack) for w in ("auto", "jnp")}
    return data, want, got


def test_matrix_slice_matches_jax_backend(matrix_runs):
    """Default config (K=512, the small-K oriented route through K6 and
    the binned selection): transforms within 1e-3 px RMSE of
    backend="jax", inliers within +-2, and under 0.05 px from the truth."""
    data, want, got = matrix_runs
    got = got["auto"]
    assert got.transforms.shape == want.transforms.shape == (8, 3, 3)
    assert jmetrics.transform_rmse(got.transforms, want.transforms, (128, 128)) <= 1e-3
    dn = np.abs(want.diagnostics["n_inliers"].astype(int) - got.diagnostics["n_inliers"])
    assert dn.max() <= 2
    for k in ("n_keypoints", "n_matches"):
        np.testing.assert_array_equal(want.diagnostics[k], got.diagnostics[k], err_msg=k)
    gt = jmetrics.relative_transforms(data.transforms)
    assert jmetrics.transform_rmse(got.transforms, gt, (128, 128)) < 0.05
    assert np.isfinite(got.corrected).all() and got.corrected.shape == data.stack.shape
    assert got.fields is None
    assert got.diagnostics["warp_ok"].all() and not got.diagnostics["warp_rescued"].any()


def test_matrix_slice_gather_route_matches_jax_backend(matrix_runs):
    """warp="jnp" (the exact gather warp, the reference's route off the
    accelerator): transforms within 1e-3 px RMSE of backend="jax" and
    corrected pixels within 1e-3 of max|frame| away from the 2-px border
    (where a 1e-4 px difference moves a sample across the frame edge)."""
    data, want, got = matrix_runs
    g = got["jnp"]
    assert jmetrics.transform_rmse(g.transforms, want.transforms, (128, 128)) <= 1e-3
    assert g.diagnostics["warp_ok"].all() and not g.diagnostics["warp_rescued"].any()
    inner = (slice(None), slice(2, -2), slice(2, -2))
    assert (np.abs(want.corrected[inner] - g.corrected[inner]).max()
            <= 1e-3 * np.abs(data.stack).max())
