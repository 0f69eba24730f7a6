"""The scale-pyramid slice of the PyTorch port against kcmc_tpu: the
pyramid geometry and resize, per-octave detect + describe (XLA route and
interpret mode), the similarity solver, the separable affine warp, and
MotionCorrector(model="similarity", n_octaves=3) end to end against
backend="jax", including the large-zoom contract of
tests/test_pyramid.py."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu.models import transforms as jtransforms
from kcmc_tpu.ops import describe as jdescribe
from kcmc_tpu.ops import detect as jdetect
from kcmc_tpu.ops import pyramid as jpyramid
from kcmc_tpu.ops import warp_separable as jsep
from kcmc_tpu.ops.fused import fused_detect_describe as j_fused
from kcmc_tpu.utils import metrics as jmetrics
from kcmc_tpu.utils import synthetic as jsynthetic
from kcmc_tpu_torch.backends.torch_backend import TorchBackend
from kcmc_tpu_torch.models import transforms as ttransforms
from kcmc_tpu_torch.ops import pyramid as tpyramid
from kcmc_tpu_torch.ops import warp_separable as tsep
from kcmc_tpu_torch.ops.fused import fused_detect_describe as t_fused

STAGE = dict(max_keypoints=192, detect_threshold=1e-4, nms_size=5, border=16,
             harris_k=0.04, window_sigma=1.5, blur_sigma=2.0, cand_tile=8,
             oriented=True)


# ---------------------------------------------------------------------------
# geometry and resize


@pytest.mark.parametrize("n_in,n_out", [(128, 88), (128, 64), (512, 344), (512, 232),
                                        (256, 172), (64, 100)])
def test_resize_matrix_identical(n_in, n_out):
    got = tpyramid.resize_matrix(n_in, n_out)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jpyramid.resize_matrix(n_in, n_out))


@pytest.mark.parametrize("shape,n,scale,k", [((128, 128), 3, 1.5, 512),
                                             ((512, 512), 3, 1.5, 512),
                                             ((200, 96), 4, 2 ** 0.5, 1024),
                                             ((40, 300), 3, 2.0, 100)])
def test_octave_sizes_and_per_octave_k_identical(shape, n, scale, k):
    assert tpyramid.octave_sizes(shape, n, scale) == jpyramid.octave_sizes(shape, n, scale)
    assert tpyramid.per_octave_k(k, n) == jpyramid.per_octave_k(k, n)


def test_default_pyramid_geometry():
    """128^2 gives 128, 88, 64 (88 is not a multiple of K1's 32-px tile)
    and 512^2 gives 512, 344, 232, at 176 keypoints per octave."""
    assert tpyramid.octave_sizes((128, 128), 3, 1.5) == [(128, 128), (88, 88), (64, 64)]
    assert tpyramid.octave_sizes((512, 512), 3, 1.5) == [(512, 512), (344, 344), (232, 232)]
    assert tpyramid.per_octave_k(512, 3) == [176] * 3


def _frames(n=2, shape=(128, 128), seed=0, n_blobs=120):
    rng = np.random.default_rng(seed)
    return np.stack([jsynthetic.render_scene(rng, shape, n_blobs=n_blobs)
                     for _ in range(n)]).astype(np.float32)


def test_build_pyramid_matches(record_property):
    fr = _frames(shape=(128, 96)) * 300.0 + 500.0
    want = jpyramid.build_pyramid(jnp.asarray(fr), 3, 1.5)
    got = tpyramid.build_pyramid(torch.as_tensor(fr), 3, 1.5)
    gap = 0.0
    for w, g in zip(want, got):
        assert (g.sx, g.sy) == (w.sx, w.sy)
        assert tuple(g.frames.shape) == tuple(w.frames.shape)
        gap = max(gap, float(np.abs(np.asarray(w.frames) - g.frames.numpy()).max()))
    record_property("pyramid_gap_rel", gap / float(np.abs(fr).max()))
    assert gap <= 1e-5 * np.abs(fr).max()


# ---------------------------------------------------------------------------
# per-octave detect + describe


def _reference_interpret(fr):
    """kcmc_tpu's multi-scale stage with its Pallas kernels in interpret
    mode: fused_detect_describe's octave loop with use_pallas and
    interpret passed to each stage."""
    octs = jpyramid.build_pyramid(jnp.asarray(fr), 3, 1.5)
    per = []
    for oc, k in zip(octs, jpyramid.per_octave_k(STAGE["max_keypoints"], 3)):
        b = min(STAGE["border"], min(oc.frames.shape[1:]) // 4)
        kps, smooth = jdetect.detect_keypoints_batch(
            oc.frames, max_keypoints=k, threshold=STAGE["detect_threshold"], border=b,
            use_pallas=True, interpret=True, smooth_sigma=STAGE["blur_sigma"],
        )
        per.append((kps, jdescribe.describe_keypoints_batch(
            oc.frames, kps, oriented=True, use_pallas=True, interpret=True,
            smooth=smooth, precision="bf16",
        )))
    return jpyramid.merge_octave_keypoints(per, octs)


@pytest.mark.parametrize("route", ["xla", "interpret"])
@pytest.mark.parametrize("dc", [0.0, 500.0], ids=["no_dc", "dc500"])
def test_per_octave_keypoints_match(route, dc, record_property):
    """Identical validity, xy within 1e-4 px in base coordinates, and
    descriptor words that differ in no more bits than the describe-mean
    bound of test_torch_oriented.py (ROADMAP queue 3: 16 bits)."""
    fr = _frames() * 300.0 + dc
    if route == "xla":
        want_k, want_d = j_fused(jnp.asarray(fr), n_octaves=3, octave_scale=1.5,
                                 precision="bf16", use_pallas=False, **STAGE)
    else:
        want_k, want_d = _reference_interpret(fr)
    got_k, got_d = t_fused(torch.as_tensor(fr), n_octaves=3, octave_scale=1.5, **STAGE)
    valid = np.asarray(want_k.valid)
    assert valid.shape == (2, 3 * 64)
    np.testing.assert_array_equal(valid, got_k.valid.numpy())
    assert valid[:, 64:].any() and valid[:, 128:].any()  # every octave contributes
    gap = float(np.abs(np.asarray(want_k.xy) - got_k.xy.numpy())[valid].max())
    want_w = np.asarray(want_d).astype(np.int64)
    bits = int(np.unpackbits((want_w ^ got_d.numpy()).astype(np.uint32).view(np.uint8)).sum())
    record_property("xy_gap_px", gap)
    record_property("word_bits_differing", bits)
    assert gap <= 1e-4
    assert bits <= 16, f"{bits} descriptor bits differ"


def test_single_scale_flag_bypasses_the_pyramid():
    fr = torch.as_tensor(_frames())
    a = t_fused(fr, n_octaves=3, multi_scale=False, **STAGE)
    b = t_fused(fr, **STAGE)
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())


# ---------------------------------------------------------------------------
# the similarity solver


def _similarity(rng, B):
    M = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    for b in range(B):
        th, s = rng.uniform(-0.05, 0.05), rng.uniform(0.7, 1.5)
        M[b, :2, :2] = s * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        M[b, :2, 2] = rng.uniform(-20, 20, 2)
    return M


def _apply(M, pts):
    return np.einsum("bij,bnj->bni", M[:, :2, :2], pts) + M[:, None, :2, 2]


def _similarity_f64_translation(src, dst, w):
    """The translation column of a float64 Umeyama solve."""
    out = []
    for s, d, ww in zip(src.astype(np.float64), dst.astype(np.float64), w.astype(np.float64)):
        cs = (s * ww[:, None]).sum(0) / ww.sum()
        cd = (d * ww[:, None]).sum(0) / ww.sum()
        p, q = s - cs, d - cd
        a = (p * q).sum(1) @ ww
        b = (p[:, 0] * q[:, 1] - p[:, 1] * q[:, 0]) @ ww
        sc = np.hypot(a, b) / ((p ** 2).sum(1) @ ww)
        c, sn = sc * a / np.hypot(a, b), sc * b / np.hypot(a, b)
        out.append(cd - np.array([[c, -sn], [sn, c]]) @ cs)
    return np.array(out)


def test_solve_similarity_matches(record_property):
    """Weighted solves on 48 noisy points and minimal 2-point samples in
    a 512^2 frame: the linear part within 1e-5 of the reference; the
    translation within 1e-5 of the 512-px extent and no farther from a
    float64 solve than the reference plus one float32 ulp at 512 px
    (3.05e-5): the two sum the centroids in another order, so 1e-5 px
    absolute is below the rounding of the translation column (ROADMAP
    queue 3). Coincident and weightless samples give the identity from
    both."""
    rng = np.random.default_rng(2)
    B = 12
    for N in (48, 2):
        src = rng.uniform(0, 512, (B, N, 2)).astype(np.float32)
        M = _similarity(rng, B)
        dst = (_apply(M, src) + rng.normal(0, 0.2, (B, N, 2))).astype(np.float32)
        w = (rng.uniform(size=(B, N)) < 0.8).astype(np.float32) if N > 2 \
            else np.ones((B, N), np.float32)
        src[10, :] = src[10, 0]
        dst[10, :] = dst[10, 0]
        w[11] = 0.0
        want = np.asarray(jax.vmap(jtransforms.solve_similarity)(src, dst, w))
        got = ttransforms.solve_similarity(*(torch.as_tensor(a) for a in (src, dst, w))).numpy()
        lin = float(np.abs(want[:, :2, :2] - got[:, :2, :2]).max())
        tr = float(np.abs(want[:, :2, 2] - got[:, :2, 2]).max())
        t64 = _similarity_f64_translation(src[:10], dst[:10], w[:10])
        port64 = float(np.abs(got[:10, :2, 2] - t64).max())
        ref64 = float(np.abs(want[:10, :2, 2] - t64).max())
        for name, v in (("linear_gap", lin), ("translation_gap_px", tr),
                        ("float64_gap_px_port", port64), ("float64_gap_px_reference", ref64)):
            record_property(f"{name}_n{N}", v)
        assert lin <= 1e-5
        assert tr <= 1e-5 * 512
        assert port64 <= ref64 + 2.0 ** -15 + 1e-9  # one float32 ulp at 512
        np.testing.assert_array_equal(want[:, 2], got[:, 2])
        for b in (10, 11):
            np.testing.assert_array_equal(got[b], np.eye(3, dtype=np.float32))
            np.testing.assert_array_equal(want[b], np.eye(3, dtype=np.float32))
    model = ttransforms.get_model("similarity")
    assert (model.min_samples, model.dof) == (2, 4)
    assert model.resolved_refine_solve is ttransforms.solve_similarity
    with pytest.raises(ValueError):
        ttransforms.get_model("piecewise")


# ---------------------------------------------------------------------------
# the separable affine warp


def _warp_case(case):
    rng = np.random.default_rng(7)
    H, W = 96, 128
    fr = np.stack([jsynthetic.render_scene(rng, (H, W), n_blobs=60) for _ in range(3)])
    fr = (fr * 300.0 + 50.0).astype(np.float32)
    c = np.array([(W - 1) / 2.0, (H - 1) / 2.0])

    def about_centre(L, t):
        M = np.eye(3)
        M[:2, :2] = L
        M[:2, 2] = c - L @ c + t
        return M

    def rot(th, s=1.0):
        return s * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])

    Ms = [about_centre(rot(0.04, 1.2), (3.3, -2.1)), about_centre(rot(-0.02, 0.85), (-5.5, 1.25)),
          about_centre(np.eye(2), (0.5, 0.25))]
    if case == "beyond_shear":
        Ms[1] = about_centre(rot(0.3), (1.0, 1.0))  # ~14 px of shear at H/2
    elif case == "projective":
        Ms[1][2, 0] = 1e-4
    elif case == "degenerate":
        Ms[1][1, 1] = 0.0
        Ms[1][1, 0] = 0.0
    return fr, np.stack(Ms).astype(np.float32)


@pytest.mark.parametrize("case", ["rotation_zoom", "beyond_shear", "projective", "degenerate"])
def test_warp_batch_affine_matches(case, record_property):
    """Identical `ok` flags and pixels within 1e-5 of max|frame|; the
    out-of-envelope frame (every case but the first) zeroed and
    flagged."""
    fr, M = _warp_case(case)
    want, wok = jsep.warp_batch_affine(jnp.asarray(fr), jnp.asarray(M), shear_px=8,
                                       with_ok=True)
    got, gok = tsep.warp_batch_affine(torch.as_tensor(fr), torch.as_tensor(M), shear_px=8,
                                      with_ok=True)
    np.testing.assert_array_equal(np.asarray(wok), gok.numpy())
    gap = float(np.abs(np.asarray(want) - got.numpy()).max())
    record_property("pixel_gap_rel", gap / float(np.abs(fr).max()))
    assert gap <= 1e-5 * np.abs(fr).max()
    assert bool(gok[0]) and bool(gok[2])
    if case != "rotation_zoom":
        assert not bool(gok[1]) and float(got[1].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the slice


@pytest.fixture(scope="module")
def drift():
    return jsynthetic.make_drift_stack(8, (128, 128), model="similarity", seed=0)


@pytest.fixture(scope="module")
def pyramid_runs(drift):
    """Each port route beside the reference's route of the same warp on
    the CPU: the separable chain (port "auto", reference
    warp="separable") and the gather warp (port "jnp", the reference's
    "auto" off the accelerator)."""
    out = {}
    for twarp, jwarp in (("auto", "separable"), ("jnp", "auto")):
        want = kcmc_tpu.MotionCorrector(model="similarity", n_octaves=3, backend="jax",
                                        warp=jwarp).correct(drift.stack)
        got = kcmc_tpu_torch.MotionCorrector(model="similarity", n_octaves=3, device="cpu",
                                             warp=twarp).correct(drift.stack)
        out[twarp] = (want, got)
    return out


@pytest.mark.parametrize("route", ["auto", "jnp"])
def test_pyramid_slice_matches_jax_backend(pyramid_runs, drift, route, record_property):
    """Transforms within 1e-3 px RMSE of backend="jax"; identical
    keypoint, match, coarse-match and inlier counts; under 0.05 px from
    the truth."""
    want, got = pyramid_runs[route]
    assert got.transforms.shape == want.transforms.shape == (8, 3, 3)
    gap = jmetrics.transform_rmse(got.transforms, want.transforms, (128, 128))
    record_property("transform_rmse_gap_px", float(gap))
    assert gap <= 1e-3
    for k in ("n_keypoints", "n_matches", "coarse_n_matches", "n_inliers"):
        np.testing.assert_array_equal(want.diagnostics[k], got.diagnostics[k], err_msg=k)
    gt = jmetrics.relative_transforms(drift.transforms)
    assert jmetrics.transform_rmse(got.transforms, gt, (128, 128)) < 0.05
    assert np.isfinite(got.corrected).all() and got.corrected.shape == drift.stack.shape
    assert got.diagnostics["warp_ok"].all() and not got.diagnostics["warp_rescued"].any()


def test_batch_program_on_jax_prepared_pyramid_reference(drift):
    """A multi-scale reference prepared by kcmc_tpu (3 x 176 slots at the
    default K) carried across: the port registers a batch against it as
    against its own."""
    jmc = kcmc_tpu.MotionCorrector(model="similarity", n_octaves=3, backend="jax",
                                   warp="separable")
    jref = jmc.backend.prepare_reference(drift.stack[0])
    assert np.asarray(jref["xy"]).shape == (528, 2)
    tb = TorchBackend(kcmc_tpu_torch.config_from_dict(dataclasses.asdict(jmc.config)),
                      device="cpu")
    assert tb.config.warp == "separable" and tb.config.n_octaves == 3
    tref = tb.reference_from_numpy({k: np.asarray(jref[k]) for k in ("xy", "desc", "valid",
                                                                      "frame")})
    own = tb.prepare_reference(drift.stack[0])
    assert tuple(own["xy"].shape) == (528, 2)
    np.testing.assert_array_equal(own["valid"].numpy(), tref["valid"].numpy())
    idx = np.arange(8)
    a = tb.process_batch(drift.stack, tref, idx)
    b = tb.process_batch(drift.stack, own, idx)
    assert jmetrics.transform_rmse(a["transform"], b["transform"], (128, 128)) <= 1e-3
    np.testing.assert_array_equal(a["coarse_n_matches"], b["coarse_n_matches"])


def test_pyramid_config_validation_and_carry_across():
    for bad in ({"n_octaves": 0}, {"n_octaves": 3, "octave_scale": 1.0},
                {"n_octaves": 2, "octave_scale": 4.5}):
        with pytest.raises(ValueError):
            kcmc_tpu.CorrectorConfig(model="similarity", **bad)
        with pytest.raises(ValueError):
            kcmc_tpu_torch.CorrectorConfig(model="similarity", **bad)
    jcfg = kcmc_tpu.CorrectorConfig(model="similarity", n_octaves=4, octave_scale=2 ** 0.5,
                                    pyramid_refine=False)
    cfg = kcmc_tpu_torch.config_from_dict(dataclasses.asdict(jcfg))
    assert (cfg.n_octaves, cfg.octave_scale, cfg.pyramid_refine) == (4, 2 ** 0.5, False)
    assert cfg.unsupported() == []
    with pytest.raises(ValueError, match="unknown model"):
        kcmc_tpu_torch.CorrectorConfig(model="projective")


def test_separable_warp_policy_matches_reference_routes():
    """similarity takes the separable chain with the shear bound, as does
    warp="separable" for rigid and affine; translation with no shear."""
    for model, warp, shear in (("similarity", "auto", 8), ("rigid", "separable", 8),
                               ("affine", "separable", 8), ("translation", "separable", 0),
                               ("similarity", "auto", 5)):
        kw = {"max_rotation_deg": 1.1} if shear == 5 else {}
        fn = TorchBackend(kcmc_tpu_torch.CorrectorConfig(model=model, warp=warp, **kw),
                          device="cpu")._resolve_batch_warp((512, 512))
        assert fn.func is tsep.warp_batch_affine and fn.keywords["shear_px"] == shear
        jfn = kcmc_tpu.MotionCorrector(model=model, warp="separable", backend="jax",
                                       **kw).backend._resolve_batch_warp((512, 512))
        assert jfn.keywords["shear_px"] == shear


def test_pyramid_refine_off_and_flagged_frames(drift):
    """pyramid_refine=False skips the fine pass (no coarse_n_matches)
    and stays near the truth at 128^2; the refine keeps the coarse
    estimate for frames the coarse warp flags."""
    tb = TorchBackend(kcmc_tpu_torch.CorrectorConfig(model="similarity", n_octaves=3,
                                                     pyramid_refine=False), device="cpu")
    ref = tb.prepare_reference(drift.stack[0])
    out = tb.process_batch(drift.stack, ref, np.arange(8))
    assert "coarse_n_matches" not in out
    gt = jmetrics.relative_transforms(drift.transforms)
    assert jmetrics.transform_rmse(out["transform"], gt, (128, 128)) < 0.1
    # a shear bound of 0 flags every rotated frame in the coarse warp:
    # those keep their coarse estimate, then take the rescue
    res = kcmc_tpu_torch.MotionCorrector(model="similarity", n_octaves=3, device="cpu",
                                         max_shear_px=0).correct(drift.stack)
    assert res.diagnostics["warp_rescued"][1:].all()
    assert jmetrics.transform_rmse(res.transforms, gt, (128, 128)) < 0.1


# ---------------------------------------------------------------------------
# the zoom envelope (tests/test_pyramid.py's contract)


def _zoom_stack(rng, scene, s, shape, n=4, drift=3.0):
    """tests/test_pyramid.py's construction: the scene scaled by s about
    the centre plus small random drift."""
    cy, cx = (shape[0] - 1) / 2.0, (shape[1] - 1) / 2.0
    mats = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    frames = [scene]
    for t in range(1, n):
        L = np.float32(s) * np.eye(2, dtype=np.float32)
        mats[t, :2, :2] = L
        mats[t, :2, 2] = rng.uniform(-drift, drift, 2).astype(np.float32) \
            + np.array([cx, cy], np.float32) - L @ np.array([cx, cy], np.float32)
        frames.append(jsynthetic._warp_scene(scene, mats[t]))
    st = np.stack(frames) + rng.normal(0, 0.01, (n,) + shape).astype(np.float32)
    return st.astype(np.float32), mats


@pytest.fixture(scope="module")
def zoom15():
    shape = (256, 256)
    rng = np.random.default_rng(3)
    scene = jsynthetic.render_scene(rng, shape, n_blobs=220)
    st, mats = _zoom_stack(rng, scene, 1.5, shape)
    return st, jmetrics.relative_transforms(mats), shape


@pytest.mark.parametrize("n_octaves", [3, 1], ids=["pyramid", "single_scale"])
def test_zoom_envelope(zoom15, n_octaves, record_property):
    """1.5x zoom at 256^2 (220 blobs, K=1024, batch 4): the pyramid
    recovers it under the reference's 0.04 px bound with the zoom itself
    within 1%; the single-scale run does not reach 0.5 px."""
    st, rel, shape = zoom15
    kw = {"n_octaves": 3, "max_keypoints": 1024} if n_octaves == 3 else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = kcmc_tpu_torch.MotionCorrector(model="similarity", device="cpu", batch_size=4,
                                             **kw).correct(st)
    err = jmetrics.transform_rmse(res.transforms, rel, shape)
    record_property("rmse_px", float(err))
    if n_octaves == 3:
        assert err < 0.04, err
        got_s = np.sqrt(np.abs(np.linalg.det(res.transforms[1:, :2, :2])))
        np.testing.assert_allclose(got_s, 1.5, rtol=0.01)
    else:
        assert err > 0.5, err
