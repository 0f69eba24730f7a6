"""The affine slice of the PyTorch port against kcmc_tpu: the affine
solvers, K7's plain version against the Pallas matrix warp (interpret
mode) and the XLA form, affine consensus and polish, the config's new
limits, and MotionCorrector(model="affine") end to end against
backend="jax"."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu.models import transforms as jtransforms
from kcmc_tpu.ops import polish as jpolish
from kcmc_tpu.ops import warp as jwarp
from kcmc_tpu.ops.pallas_warp_field import warp_batch_matrix_pallas
from kcmc_tpu.ops.ransac import consensus_batch as j_consensus
from kcmc_tpu.ops.warp_field import warp_batch_matrix as j_warp_matrix
from kcmc_tpu.utils import metrics as jmetrics
from kcmc_tpu.utils import synthetic as jsynthetic
from kcmc_tpu_torch.backends.torch_backend import TorchBackend
from kcmc_tpu_torch.models import transforms as ttransforms
from kcmc_tpu_torch.ops import polish as tpolish
from kcmc_tpu_torch.ops import warp_field as twarp_field
from kcmc_tpu_torch.ops.cuda_warp_matrix import warp_batch_matrix, warp_batch_matrix_plain
from kcmc_tpu_torch.ops.ransac import consensus_batch as t_consensus
from kcmc_tpu_torch.utils import prng

CORNERS = np.array([[0, 0], [511, 0], [0, 511], [511, 511], [255.5, 255.5]], np.float32)


def _px(a, b, pts=CORNERS):
    """Largest displacement between two (..., 3, 3) affine maps over
    the control points, in pixels."""
    def ap(M):
        return np.einsum("...ij,nj->...ni", M[..., :2, :2], pts) + M[..., None, :2, 2]
    return float(np.abs(ap(a) - ap(b)).max())


def _affine(rng, B):
    A = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    for b in range(B):
        th = rng.uniform(-0.05, 0.05)
        c, s = np.cos(th), np.sin(th)
        A[b, :2, :2] = np.array([[c, -s], [s, c]]) @ (np.eye(2) + rng.uniform(-0.02, 0.02, (2, 2)))
        A[b, :2, 2] = rng.uniform(-10, 10, 2)
    return A


def _apply(A, pts):
    return np.einsum("bij,bnj->bni", A[:, :2, :2], pts) + A[:, None, :2, 2]


# ---------------------------------------------------------------------------
# solvers


@pytest.mark.parametrize("name", ["solve_affine", "solve_affine_accurate"])
def test_affine_solvers_match(name):
    """Weighted solves on 48 noisy points per batch entry: the linear
    part within 1e-5 of the reference, the map within 5e-4 px over a
    512^2 frame. The two sum the centroids and normal equations in
    another order, and a float32 sum of 512-px coordinates rounds at
    3e-5 px, so the translation cannot agree to 1e-5."""
    rng = np.random.default_rng(0)
    B, N = 12, 48
    src = rng.uniform(0, 512, (B, N, 2)).astype(np.float32)
    A = _affine(rng, B)
    dst = (_apply(A, src) + rng.normal(0, 0.3, (B, N, 2))).astype(np.float32)
    w = (rng.uniform(size=(B, N)) < 0.8).astype(np.float32)
    want = np.asarray(jax.vmap(getattr(jtransforms, name))(src, dst, w))
    got = getattr(ttransforms, name)(*(torch.as_tensor(a) for a in (src, dst, w))).numpy()
    assert np.abs(want[:, :, :2] - got[:, :, :2]).max() <= 1e-5
    assert _px(want, got) <= 5e-4
    assert _px(want, A) < 0.5  # and they fit the map


def test_affine_minimal_samples_and_degenerate_cases():
    """Minimal 3-point hypotheses: well-spread samples agree with the
    reference; collinear and duplicated samples give the identity from
    the hypothesis solver, coincident or weightless ones from both."""
    rng = np.random.default_rng(1)
    B = 16
    src = rng.uniform(0, 512, (B, 3, 2)).astype(np.float32)
    src[:8] = [[50, 60], [400, 80], [220, 430]] + rng.uniform(-20, 20, (8, 3, 2))
    A = _affine(rng, B)
    dst = (_apply(A, src) + rng.normal(0, 0.3, (B, 3, 2))).astype(np.float32)
    w = np.ones((B, 3), np.float32)
    src[8, 2] = (src[8, 0] + src[8, 1]) / 2  # collinear
    src[9, 1] = src[9, 0]  # duplicated
    dst[9, 1] = dst[9, 0]
    src[10, :] = src[10, 0]  # coincident
    dst[10, :] = dst[10, 0]
    w[11] = 0.0  # weightless
    ts = [torch.as_tensor(a) for a in (src, dst, w)]
    eye = np.eye(3, dtype=np.float32)
    want = np.asarray(jax.vmap(jtransforms.solve_affine)(src, dst, w))
    got = ttransforms.solve_affine(*ts).numpy()
    assert _px(want[:8], got[:8]) <= 1e-3
    for b in (8, 9, 10, 11):
        np.testing.assert_array_equal(got[b], eye)
        np.testing.assert_array_equal(want[b], eye)
    acc = ttransforms.solve_affine_accurate(*ts).numpy()
    for b in (10, 11):
        np.testing.assert_array_equal(acc[b], eye)


# ---------------------------------------------------------------------------
# K7 and the XLA form


def _hom(theta_deg, tx, ty, g, h, sc=1.0, c=95.5):
    """The reference's test maps (test_pallas_warp_field.py)."""
    th = np.deg2rad(theta_deg)
    R = np.array([[sc * np.cos(th), -sc * np.sin(th), 0],
                  [sc * np.sin(th), sc * np.cos(th), 0], [0, 0, 1.0]])
    C = np.array([[1, 0, c], [0, 1, c], [0, 0, 1.0]])
    Ci = np.array([[1, 0, -c], [0, 1, -c], [0, 0, 1.0]])
    T = np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1.0]])
    M = (C @ R @ Ci @ T).astype(np.float64)
    M[2, 0], M[2, 1] = g, h
    return M.astype(np.float32)


@pytest.fixture(scope="module")
def warp_case():
    """The reference's four cases, then a rotation beyond max_px, a
    centre shift beyond +-PAD and a degenerate M[2, 2]."""
    rng = np.random.default_rng(0)
    img = jsynthetic.render_scene(rng, (192, 192), n_blobs=120).astype(np.float32)
    cases = [
        _hom(0.0, 0.0, 0.0, 0.0, 0.0),
        _hom(0.0, 5.2, -3.8, 2e-5, -1.5e-5),
        _hom(1.2, -4.1, 2.6, -2e-5, 2e-5),
        _hom(-0.8, 30.3, -17.7, 0.0, 0.0, sc=1.01),
        _hom(8.0, 0.0, 0.0, 0.0, 0.0),
        _hom(0.0, 140.3, 2.0, 0.0, 0.0),
        _hom(0.5, 1.0, 2.0, 0.0, 0.0),
    ]
    cases[-1][2, 2] = 0.0
    fr = np.stack([img] * len(cases))
    fr = fr + rng.normal(0, 0.01, fr.shape).astype(np.float32)
    return fr, np.stack(cases)


@pytest.mark.parametrize("strip", [None, 64])
def test_k7_plain_matches_pallas_interpret(warp_case, strip):
    """Within 1e-5 of max|frame| (the reference's CPU evaluation fuses
    multiply-adds the port rounds apart) with identical ok flags, for
    the whole-frame and the row-strip layout of the TPU kernel."""
    fr, Ms = warp_case
    want, wok = warp_batch_matrix_pallas(
        jnp.asarray(fr), jnp.asarray(Ms), max_px=12, strip=strip,
        interpret=True, with_ok=True,
    )
    got, ok = warp_batch_matrix(torch.as_tensor(fr), torch.as_tensor(Ms), max_px=12)
    np.testing.assert_array_equal(np.asarray(wok), ok.numpy())
    np.testing.assert_array_equal(ok.numpy(), [True] * 4 + [False] * 3)
    assert np.abs(np.asarray(want) - got.numpy()).max() <= 1e-5 * np.abs(fr).max()
    assert not got.numpy()[~ok.numpy()].any()


def test_k7_plain_equals_xla_form_inside_window(warp_case):
    """The port's XLA form (the clamped-shift canvas and masked views)
    is the independent oracle: bit-equal to K7's plain version wherever
    the centre shift is inside +-PAD and M[2, 2] is sound; it lacks
    those two flags. It also matches the reference's XLA form."""
    fr, Ms = warp_case
    tf, tM = torch.as_tensor(fr), torch.as_tensor(Ms)
    plain, ok = warp_batch_matrix_plain(tf, tM, 12)
    xla, xok = twarp_field.warp_batch_matrix(tf, tM, 12)
    np.testing.assert_array_equal(xok.numpy(), [True] * 4 + [False, True, True])
    inside = [0, 1, 2, 3, 4]
    np.testing.assert_array_equal(plain.numpy()[inside], xla.numpy()[inside])
    want, wok = j_warp_matrix(jnp.asarray(fr), jnp.asarray(Ms), max_px=12, with_ok=True)
    np.testing.assert_array_equal(np.asarray(wok), xok.numpy())
    assert np.abs(np.asarray(want) - xla.numpy()).max() <= 1e-5 * np.abs(fr).max()


def test_k7_close_to_gather_warp(warp_case):
    """One interpolation: within 0.02 of max|frame| of the exact gather
    warp (the rescue path and the reference's CPU warp) on frames it
    keeps, away from the frame border."""
    fr, Ms = warp_case
    got, ok = warp_batch_matrix(torch.as_tensor(fr), torch.as_tensor(Ms), max_px=12)
    exact = np.asarray(jwarp.warp_batch(jnp.asarray(fr), jnp.asarray(Ms)))
    k = ok.numpy()
    d = np.abs(got.numpy()[k] - exact[k])[:, 8:-8, 8:-8]
    assert d.max() <= 0.02 * np.abs(fr).max()


# ---------------------------------------------------------------------------
# consensus and polish


def _match_case(B=4, N=4096, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 512, (B, N, 2)).astype(np.float32)
    A = _affine(rng, B)
    dst = (_apply(A, src) + rng.normal(0, 0.4, (B, N, 2))).astype(np.float32)
    out = rng.uniform(size=(B, N)) < 0.4
    dst[out] = rng.uniform(0, 512, (int(out.sum()), 2)).astype(np.float32)
    valid = rng.uniform(size=(B, N)) < 0.6
    valid[2, 30:] = False
    valid[3] = False
    return src, dst, valid, A


@pytest.mark.parametrize("rungs,cap,N", [(4, 512, 4096), (0, 0, 256)])
def test_affine_consensus_identical_inliers(rungs, cap, N):
    """Identical inlier counts; transforms within 1e-3 px over a 512^2
    frame (float32 normal-equation sums over ~1500 inliers in another
    order)."""
    src, dst, valid, A = _match_case(N=N)
    B = src.shape[0]
    idx = np.arange(7, 7 + B, dtype=np.int32)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(jnp.asarray(idx))
    tkeys = prng.fold_in(prng.key(0), torch.as_tensor(idx))
    kw = dict(n_hypotheses=128, threshold=2.0, refine_iters=2, score_cap=cap,
              budget_rungs=rungs, early_exit_frac=0.7)
    want = j_consensus(jtransforms.get_model("affine"), jnp.asarray(src),
                       jnp.asarray(dst), jnp.asarray(valid), jkeys, **kw)
    got = t_consensus(ttransforms.get_model("affine"),
                      *(torch.as_tensor(a) for a in (src, dst, valid)), tkeys, **kw)
    np.testing.assert_array_equal(np.asarray(want.n_inliers), got.n_inliers.numpy())
    assert _px(np.asarray(want.transform), got.transform.numpy()) <= 1e-3
    assert _px(got.transform.numpy()[:2], A[:2]) < 0.5
    np.testing.assert_array_equal(got.transform.numpy()[3], np.eye(3, dtype=np.float32))


def test_polish_transforms_affine_matches():
    """One photometric polish pass with the affine refine solver, within
    1e-4 px of the reference."""
    rng = np.random.default_rng(4)
    tmpl = jsynthetic.render_scene(rng, (128, 128), n_blobs=200).astype(np.float32)
    A = _affine(rng, 4)
    A[:, :2, 2] *= 0.05  # residual misregistration of a few tenths of a pixel
    A[:, :2, :2] = np.eye(2) + (A[:, :2, :2] - np.eye(2)) * 0.05
    frames = np.array(jwarp.warp_batch(jnp.asarray(np.repeat(tmpl[None], 4, 0)), jnp.asarray(A)))
    base = _affine(rng, 4)
    want = np.asarray(jpolish.polish_transforms(
        jnp.asarray(frames), jnp.asarray(tmpl), jnp.asarray(base), "affine"
    ))
    got = tpolish.polish_transforms(
        torch.as_tensor(frames), torch.as_tensor(tmpl), torch.as_tensor(base), "affine"
    ).numpy()
    assert _px(want, got, CORNERS / 4) <= 1e-4
    assert np.abs(got - base).max() > 1e-3  # the polish moved something


# ---------------------------------------------------------------------------
# config and backend


def test_matrix_bounds_and_config_carry_across():
    jcfg = kcmc_tpu.CorrectorConfig(model="affine", max_keypoints=4096, max_shear_px=9,
                                    max_projective_px=3, max_scale_dev=0.03)
    cfg = kcmc_tpu_torch.config_from_dict(dataclasses.asdict(jcfg))
    for f in ("max_shear_px", "max_rotation_deg", "max_projective_px", "max_scale_dev"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.resolved_oriented() is True and cfg.unsupported() == []
    tb = TorchBackend(cfg, device="cpu")
    for shape in ((128, 128), (512, 512), (2048, 2048)):
        want = kcmc_tpu.MotionCorrector(config=jcfg, backend="jax").backend._matrix_resid_px(shape)
        assert tb._matrix_resid_px(shape) == want
    rot = TorchBackend(cfg.replace(max_rotation_deg=3.0), device="cpu")
    assert rot._shear_bound_px((512, 512)) == 14
    assert TorchBackend(kcmc_tpu_torch.CorrectorConfig(
        model="affine", max_keypoints=4096), device="cpu")._matrix_resid_px((512, 512)) == 18
    with pytest.raises(ValueError, match="max_rotation_deg"):
        kcmc_tpu_torch.CorrectorConfig(max_rotation_deg=50.0)


@pytest.mark.parametrize(
    "kw",
    [
        {"model": "affine", "max_keypoints": 4096, "plan_buckets": ((128, 128),)},
        {"model": "similarity", "max_keypoints": 4096, "mesh_devices": 2},
    ],
)
def test_unported_affine_knobs_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kcmc_tpu_torch.MotionCorrector(device="cpu", **kw)


@pytest.mark.parametrize(
    "kw",
    [
        {"model": "rigid", "warm_start": True},
        {"model": "affine", "max_keypoints": 4096, "oriented": None, "quality_metrics": True},
        {"model": "rigid3d", "template_iters": 1},
        {"model": "homography", "max_keypoints": 4096, "match_precision": "float32"},
        {"model": "translation", "template_update_every": 8},
    ],
)
def test_ported_affine_knobs_accepted(kw):
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", **kw)
    assert mc.config.unsupported() == []


def test_piecewise_warm_start_raises_in_both():
    """warm_start has no transform seed for piecewise: both packages
    raise the same ValueError."""
    with pytest.raises(ValueError) as want:
        kcmc_tpu.CorrectorConfig(model="piecewise", warm_start=True)
    with pytest.raises(ValueError) as got:
        kcmc_tpu_torch.MotionCorrector(model="piecewise", device="cpu", warm_start=True)
    assert str(got.value) == str(want.value)


def test_affine_ok_without_oriented_is_allowed():
    mc = kcmc_tpu_torch.MotionCorrector(model="affine", device="cpu", oriented=False)
    assert mc.config.resolved_oriented() is False


# ---------------------------------------------------------------------------
# the slice


CFG2 = dict(max_keypoints=2048, cand_tile=4, nms_size=3, harris_window_sigma=1.2,
            batch_size=8)


@pytest.fixture(scope="module")
def affine_runs():
    data = jsynthetic.make_drift_stack(8, (128, 128), model="affine", seed=0,
                                       sigma_range=(0.7, 1.4))
    want = kcmc_tpu.MotionCorrector(model="affine", backend="jax", **CFG2).correct(data.stack)
    got = kcmc_tpu_torch.MotionCorrector(model="affine", device="cpu", **CFG2).correct(data.stack)
    return data, want, got


def test_affine_slice_matches_jax_backend(affine_runs):
    """Transforms within 1e-3 px RMSE of backend="jax" and inliers within
    +-2. At 128^2 and cand_tile=4 there are 1024 tiles, fewer than
    K=2048: selection pads to K and the bins-first gate (on K) fires."""
    data, want, got = affine_runs
    assert got.transforms.shape == want.transforms.shape == (8, 3, 3)
    assert jmetrics.transform_rmse(got.transforms, want.transforms, (128, 128)) <= 1e-3
    dn = np.abs(want.diagnostics["n_inliers"].astype(int) - got.diagnostics["n_inliers"])
    assert dn.max() <= 2
    for k in ("n_keypoints", "n_matches"):
        np.testing.assert_array_equal(want.diagnostics[k], got.diagnostics[k], err_msg=k)
    gt = jmetrics.relative_transforms(data.transforms)
    assert jmetrics.transform_rmse(got.transforms, gt, (128, 128)) < 0.05
    assert np.isfinite(got.corrected).all() and got.corrected.shape == data.stack.shape
    assert got.diagnostics["warp_ok"].all() and not got.diagnostics["warp_rescued"].any()


def test_affine_rescue_of_frame_beyond_matrix_bound():
    """A frame rotated beyond K7's residual bound: K7 zeroes and flags
    it, the corrector re-warps it through the exact gather path."""
    rng = np.random.default_rng(3)
    scene = jsynthetic.render_scene(rng, (128, 128), n_blobs=300, sigma_range=(0.7, 1.4))
    th = np.deg2rad(20.0)
    c = 63.5
    M = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    C = np.array([[1, 0, c], [0, 1, c], [0, 0, 1.0]])
    Ci = np.array([[1, 0, -c], [0, 1, -c], [0, 0, 1.0]])
    M = (C @ M @ Ci).astype(np.float32)
    stack = np.stack([scene, jsynthetic._warp_scene(scene, M)]).astype(np.float32)
    res = kcmc_tpu_torch.MotionCorrector(
        model="affine", device="cpu", batch_size=2, max_keypoints=2048, cand_tile=4,
        nms_size=3, harris_window_sigma=1.2,
    ).correct(stack)
    np.testing.assert_array_equal(res.diagnostics["warp_rescued"], [False, True])
    assert jmetrics.transform_rmse(res.transforms[1:], M[None], (128, 128)) < 0.1
    assert res.corrected[1].any()
