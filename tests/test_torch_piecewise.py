"""The piecewise slice of the PyTorch port against kcmc_tpu: the
fixed-budget RANSAC estimator, the field primitives and the per-patch
field estimate, the exact correlation measurement and polish, the
synthetic piecewise stack, K8's plain version against the Pallas field
warp in interpret mode, the config's new fields and limits, and
MotionCorrector(model="piecewise") end to end against backend="jax"."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu.models import transforms as jtransforms
from kcmc_tpu.ops import piecewise as jpw
from kcmc_tpu.ops import polish as jpolish
from kcmc_tpu.ops import warp as jwarp
from kcmc_tpu.ops.pallas_warp_field import warp_batch_field as j_warp_field
from kcmc_tpu.ops.ransac import ransac_estimate as j_ransac
from kcmc_tpu.utils import metrics as jmetrics
from kcmc_tpu.utils import synthetic as jsynthetic
from kcmc_tpu_torch.models import transforms as ttransforms
from kcmc_tpu_torch.ops import piecewise as tpw
from kcmc_tpu_torch.ops import polish as tpolish
from kcmc_tpu_torch.ops import warp as twarp
from kcmc_tpu_torch.ops.cuda_warp_field import warp_batch_field, warp_batch_field_plain
from kcmc_tpu_torch.ops.ransac import ransac_estimate as t_ransac
from kcmc_tpu_torch.utils import metrics as tmetrics
from kcmc_tpu_torch.utils import prng
from kcmc_tpu_torch.utils import synthetic as tsynthetic


def _t(a):
    return torch.as_tensor(np.array(a))


def _field_matches(seed=0, N=300, shape=(256, 256)):
    """Matches displaced by a smooth field plus outliers: (src, dst,
    valid, field)."""
    rng = np.random.default_rng(seed)
    field = (rng.uniform(-2, 2, (8, 8, 2)) + [3.1, -1.7]).astype(np.float32)
    src = rng.uniform(0, shape[0] - 1, (N, 2)).astype(np.float32)
    flow = jsynthetic.upsample_field(field, shape)
    xi, yi = np.clip(np.rint(src).astype(int), 0, shape[0] - 1).T
    dst = (src + flow[yi, xi] + rng.normal(0, 0.2, (N, 2))).astype(np.float32)
    out = rng.uniform(size=N) < 0.2
    dst[out] = rng.uniform(0, shape[0] - 1, (int(out.sum()), 2))
    valid = rng.uniform(size=N) < 0.9
    return src, dst, valid, field


# ---------------------------------------------------------------------------
# estimator and field primitives


@pytest.mark.parametrize("hyps,cap", [(32, 0), (64, 16)])
def test_ransac_estimate_identical(hyps, cap):
    """Translation, N=64, fixed budget: the same hypothesis keys from
    split(key), the same winner, identical inlier masks and transforms
    within 1e-5 px; with score_cap, the full-pool first eighth too."""
    rng = np.random.default_rng(1)
    B, N = 6, 64
    src = rng.uniform(0, 256, (B, N, 2)).astype(np.float32)
    t = rng.uniform(-5, 5, (B, 1, 2)).astype(np.float32)
    dst = (src + t + rng.normal(0, 0.3, (B, N, 2))).astype(np.float32)
    out = rng.uniform(size=(B, N)) < 0.35
    dst[out] += rng.uniform(-30, 30, (int(out.sum()), 2)).astype(np.float32)
    valid = rng.uniform(size=(B, N)) < 0.8
    valid[5] = False
    idx = np.arange(B, dtype=np.int32)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(4), i))(jnp.asarray(idx))
    kw = dict(n_hypotheses=hyps, threshold=2.0, score_cap=cap)
    want = jax.vmap(lambda s, d, v, k: j_ransac(
        jtransforms.get_model("translation"), s, d, v, k, **kw))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), jkeys)
    got = t_ransac(ttransforms.get_model("translation"), _t(src), _t(dst), _t(valid),
                   prng.fold_in(prng.key(4), torch.as_tensor(idx)), **kw)
    np.testing.assert_array_equal(np.asarray(want.n_inliers), got.n_inliers.numpy())
    np.testing.assert_array_equal(np.asarray(want.inlier_mask), got.inlier_mask.numpy())
    assert np.abs(np.asarray(want.transform) - got.transform.numpy()).max() <= 1e-5
    np.testing.assert_array_equal(got.transform.numpy()[5], np.eye(3, dtype=np.float32))


def test_field_primitives_match():
    """smooth_field, upsample_field and sample_field_at within 1e-6 of
    the reference (batched over frames here, per frame there)."""
    rng = np.random.default_rng(2)
    fields = rng.uniform(-4, 4, (3, 8, 8, 2)).astype(np.float32)
    for sigma in (0.4, 0.7, 1.3):
        want = np.stack([np.asarray(jpw.smooth_field(jnp.asarray(f), sigma)) for f in fields])
        got = tpw.smooth_field(_t(fields), sigma).numpy()
        assert np.abs(want - got).max() <= 1e-6
    odd = rng.uniform(-4, 4, (2, 6, 5, 2)).astype(np.float32)
    for f, shape in ((fields, (96, 128)), (odd, (50, 40))):
        want = np.stack([np.asarray(jpw.upsample_field(jnp.asarray(x), shape)) for x in f])
        got = tpw.upsample_field(_t(f), shape).numpy()
        assert np.abs(want - got).max() <= 1e-6
    pts = rng.uniform(-3, 130, (3, 40, 2)).astype(np.float32)
    want = np.stack([np.asarray(jpw.sample_field_at(jnp.asarray(f), jnp.asarray(p), (128, 128)))
                     for f, p in zip(fields, pts)])
    got = tpw.sample_field_at(_t(fields), _t(pts), (128, 128)).numpy()
    assert np.abs(want - got).max() <= 1e-6


def test_estimate_field_matches():
    """One frame's matches through the default estimator settings of the
    corrector (64 global hypotheses for the test, 32 per patch, 3 passes
    with the shrinking reach): field within 1e-4 px of the reference, and
    the frame batched with a second one gives the same field."""
    src, dst, valid, truth = _field_matches(N=1500)
    kw = dict(grid=(8, 8), shape=(256, 256), n_global_hyps=64, patch_hyps=32,
              global_threshold=8.0, patch_threshold=2.0, prior=2.0, smooth_sigma=0.4,
              passes=3, refine_reach_scale=0.5, refine_hyps=8)
    key = jax.random.fold_in(jax.random.key(0), 3)
    want = jpw.estimate_field(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), key, **kw)
    s2, d2, v2, _ = _field_matches(seed=5, N=1500)
    tkeys = prng.fold_in(prng.key(0), torch.tensor([3, 9]))
    got = tpw.estimate_field(_t(np.stack([src, s2])), _t(np.stack([dst, d2])),
                             _t(np.stack([valid, v2])), tkeys, **kw)
    assert np.abs(np.asarray(want.field) - got.field[0].numpy()).max() <= 1e-4
    assert int(want.n_inliers) == int(got.n_inliers[0])
    # closer to the (rough, unsmoothed) truth than its global mean is
    flat = np.broadcast_to(truth.mean(axis=(0, 1)), truth.shape)
    assert (jmetrics.field_rmse(got.field[:1].numpy(), truth[None])
            < jmetrics.field_rmse(flat[None], truth[None]))


@pytest.fixture(scope="module")
def polish_case():
    rng = np.random.default_rng(4)
    tmpl = jsynthetic.render_scene(rng, (128, 128), n_blobs=200).astype(np.float32)
    fields = rng.uniform(-0.6, 0.6, (3, 8, 8, 2)).astype(np.float32)
    flows = np.stack([jsynthetic.upsample_field(f, (128, 128)) for f in fields])
    frames = np.array(jax.vmap(jwarp.warp_frame_flow)(
        jnp.asarray(np.repeat(tmpl[None], 3, 0)), jnp.asarray(flows)))
    return frames, tmpl


def test_measure_shifts_exact_and_correlation_polish_match(polish_case):
    """The exact per-region estimator within 1e-5 px on average and 5e-5
    px at most (and the same significance gate), and no farther from a
    float64 evaluation than the reference is; correlation_polish is its
    negation. Scores are float32 sums over 256-pixel regions in another
    order than XLA's, and the quadratic vertex divides by their second
    difference: one region of 192 here, next to the +-1 clamp, differs by
    2.6e-5 px, where the reference is 1.5e-5 px off the float64 value and
    the port 1.1e-5 px off on the other side."""
    frames, tmpl = polish_case
    wd, ws = jpolish.measure_shifts(jnp.asarray(frames), jnp.asarray(tmpl), (8, 8), exact=True)
    gd, gs = tpolish.measure_shifts(_t(frames), _t(tmpl), (8, 8), exact=True)
    np.testing.assert_array_equal(np.asarray(ws), gs.numpy())
    wd = np.asarray(wd)
    diff = np.abs(wd - gd.numpy())
    assert diff.mean() <= 1e-5 and diff.max() <= 5e-5
    ed, es = tpolish.measure_shifts(_t(frames).double(), _t(tmpl).double(), (8, 8), exact=True)
    np.testing.assert_array_equal(es.numpy(), gs.numpy())
    ref_err, port_err = np.abs(wd - ed.numpy()), np.abs(gd.numpy() - ed.numpy())
    assert port_err.max() <= ref_err.max() and port_err.mean() <= ref_err.mean()
    assert np.abs(gd.numpy()).max() > 0.1
    got = tpw.correlation_polish(_t(frames), _t(tmpl), (8, 8)).numpy()
    np.testing.assert_array_equal(got, -gd.numpy())
    # the ring branch (transform polish) is a different estimator
    rd, _ = tpolish.measure_shifts(_t(frames), _t(tmpl), (8, 8))
    assert np.abs(rd.numpy() - gd.numpy()).max() > 1e-4


def test_piecewise_stack_and_field_rmse_copies_match():
    a = jsynthetic.make_piecewise_stack(3, (64, 48), seed=5)
    b = tsynthetic.make_piecewise_stack(3, (64, 48), seed=5)
    for k in ("stack", "transforms", "fields", "reference"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    est = a.fields + np.float32(0.03)
    assert jmetrics.field_rmse(est, a.fields) == tmetrics.field_rmse(est, b.fields)


# ---------------------------------------------------------------------------
# K8


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(7)
    return jsynthetic.render_scene(rng, (192, 192), n_blobs=90).astype(np.float32)


def _warp_cases(img):
    """The reference's five cases (tests/test_pallas_warp_field.py):
    (frames, fields, max_px, want_ok)."""
    rng = np.random.default_rng(1)
    f = np.stack([rng.uniform(-2.5, 2.5, (8, 8, 2)).astype(np.float32) + np.float32(t)
                  for t in [(0.0, 0.0), (4.7, -3.1), (-9.4, 6.2)]])
    rng3 = np.random.default_rng(3)
    odd_img = jsynthetic.render_scene(rng3, (200, 160), n_blobs=80).astype(np.float32)
    odd = rng3.uniform(-2.0, 2.0, size=(2, 6, 5, 2)).astype(np.float32)
    odd[1] += np.asarray([7.3, -5.1], np.float32)
    beyond = np.zeros((1, 8, 8, 2), np.float32)
    beyond[0, :4] = 10.0
    beyond[0, 4:] = -10.0
    return [
        (np.stack([img] * 3), f, 6, [True] * 3),
        (img[None], np.broadcast_to(np.float32([1.3, -2.6]), (1, 8, 8, 2)).copy(), 6, [True]),
        (np.stack([odd_img] * 2), odd, 6, [True] * 2),
        (img[None], beyond, 4, [False]),
        (img[None], np.full((1, 8, 8, 2), 300.0, np.float32), 4, [False]),
    ]


@pytest.mark.parametrize("case", range(5), ids=["fields", "constant", "odd_shape",
                                                 "beyond_bound", "beyond_pad"])
def test_k8_plain_matches_pallas_interpret(img, case):
    """Within 1e-5 of max|frame| with identical ok flags (interpret mode
    contracts multiply-adds the port rounds apart), frames out of the
    envelope zeroed; and within the O(|grad u|^2) bound of the gather
    warp on the frames it keeps."""
    frames, fields, mp, want_ok = _warp_cases(img)[case]
    want, wok = j_warp_field(jnp.asarray(frames), jnp.asarray(fields), max_px=mp,
                             interpret=True, with_ok=True)
    got, ok = warp_batch_field(_t(frames), _t(fields), max_px=mp)
    np.testing.assert_array_equal(np.asarray(wok), ok.numpy())
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    assert np.abs(np.asarray(want) - got.numpy()).max() <= 1e-5 * np.abs(frames).max()
    assert not got.numpy()[~ok.numpy()].any()
    if ok.all():
        shape = frames.shape[1:]
        exact = twarp.warp_frame_flow(_t(frames), tpw.upsample_field(_t(fields), shape)).numpy()
        d = np.abs(got.numpy() - exact)
        assert d.mean() < 2e-4 and d.max() < 0.02


def test_k8_plain_route_is_the_wrapper_on_cpu(img):
    fields = np.zeros((2, 8, 8, 2), np.float32)
    fields[1] = [0.25, -0.5]
    a, aok = warp_batch_field(_t(np.stack([img] * 2)), _t(fields), max_px=6)
    b, bok = warp_batch_field_plain(_t(np.stack([img] * 2)), _t(fields), 6)
    assert torch.equal(a, b) and torch.equal(aok, bok)
    np.testing.assert_array_equal(a[0].numpy(), img)  # a zero field is the identity
    with pytest.raises(ValueError, match="fields"):
        warp_batch_field(_t(np.stack([img] * 2)), _t(fields[:1]))


# ---------------------------------------------------------------------------
# config


def test_piecewise_config_carries_across():
    jcfg = kcmc_tpu.CorrectorConfig(model="piecewise", patch_grid=(6, 5), field_polish=2,
                                    refine_hypotheses=4, max_flow_px=5)
    cfg = kcmc_tpu_torch.config_from_dict(dataclasses.asdict(jcfg))
    for f in ("patch_grid", "patch_hypotheses", "refine_hypotheses", "patch_model",
              "patch_prior", "field_smooth_sigma", "field_passes", "refine_reach_scale",
              "global_threshold", "field_polish", "max_flow_px"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.resolved_oriented() is False and cfg.unsupported() == []
    for bad in ({"field_passes": 0}, {"refine_hypotheses": -1}, {"field_polish": -1},
                {"patch_model": "homography"}):
        with pytest.raises(ValueError):
            kcmc_tpu_torch.CorrectorConfig(model="piecewise", **bad)


@pytest.mark.parametrize(
    "kw",
    [
        # the mesh is ported (tests/test_torch_mesh.py), and since item
        # 19a so are the records and heartbeat knobs, which raised here
        # before: the corrector takes them with the model's other knobs
        {"model": "piecewise", "mesh_devices": 2, "frame_records_path": "r.jsonl"},
        {"model": "rigid", "plan_buckets": ((64, 64),), "heartbeat_s": 0.5},
    ],
)
def test_unported_knobs_still_raise(kw):
    cfg = kcmc_tpu_torch.MotionCorrector(device="cpu", **kw).config
    assert cfg.unsupported() == [] and cfg.observability_enabled
    assert all(getattr(cfg, k) == v for k, v in kw.items())


@pytest.mark.parametrize(
    "kw",
    [
        {"model": "similarity", "n_octaves": 3, "warm_start": True},
        {"model": "rigid3d", "sanitize_input": True},
        {"model": "homography", "sanitize_input": True},
        {"model": "piecewise", "quality_metrics": True},
        {"model": "rigid", "plan_buckets": ((64, 64),)},
    ],
)
def test_ported_knobs_now_accepted(kw):
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", **kw)
    assert mc.config.unsupported() == []


# ---------------------------------------------------------------------------
# the slice


@pytest.fixture(scope="module")
def piecewise_runs():
    data = jsynthetic.make_piecewise_stack(8, (128, 128), seed=0)
    # off the accelerator the reference's "auto" and "jnp" policies are
    # both its gather warp of the upsampled field
    want = kcmc_tpu.MotionCorrector(model="piecewise", backend="jax").correct(data.stack)
    got = {w: kcmc_tpu_torch.MotionCorrector(model="piecewise", device="cpu", warp=w)
           .correct(data.stack) for w in ("jnp", "auto")}
    return data, want, got


def test_piecewise_slice_gather_route_matches_jax_backend(piecewise_runs):
    """warp="jnp" on both sides (the same gather warp): fields within
    1e-3 px RMSE, identical keypoints, matches and global inliers, and
    corrected pixels within 1e-3 of max|frame| away from the 2-px border
    (where a 1e-4 px field difference moves a sample across the frame
    edge and zeroes it on one side only)."""
    data, want, got = piecewise_runs
    g = got["jnp"]
    assert g.fields.shape == want.fields.shape == (8, 8, 8, 2) and g.transforms is None
    assert tmetrics.field_rmse(g.fields, want.fields) <= 1e-3
    for k in ("n_keypoints", "n_matches", "n_inliers"):
        np.testing.assert_array_equal(want.diagnostics[k], g.diagnostics[k], err_msg=k)
    inner = (slice(None), slice(2, -2), slice(2, -2))
    assert (np.abs(want.corrected[inner] - g.corrected[inner]).max()
            <= 1e-3 * np.abs(data.stack).max())


def test_piecewise_slice_k8_route_matches_jax_backend(piecewise_runs):
    """The port's default route (K8's plain version, whose split differs
    from the gather by O(|grad u|^2) and feeds the field_polish loop)
    against the reference's gather: fields within 0.02 px RMSE, and the
    port's error against the truth no worse than 1.1x the reference's."""
    data, want, got = piecewise_runs
    g = got["auto"]
    assert tmetrics.field_rmse(g.fields, want.fields) <= 0.02
    truth = data.fields - data.fields[0]
    assert tmetrics.field_rmse(g.fields, truth) <= 1.1 * jmetrics.field_rmse(want.fields, truth)
    assert np.isfinite(g.corrected).all() and g.corrected.shape == data.stack.shape
    assert g.diagnostics["warp_ok"].all() and not g.diagnostics["warp_rescued"].any()


def test_piecewise_rescue_of_frame_beyond_field_bound():
    """A frame whose field leaves K8's residual bound: K8 zeroes and
    flags it, the corrector re-warps it from its field through the
    gather warp of the upsampled flow."""
    data = tsynthetic.make_piecewise_stack(2, (128, 128), seed=3, max_disp=6.0)
    mc = kcmc_tpu_torch.MotionCorrector(model="piecewise", device="cpu", batch_size=2,
                                        max_flow_px=1, field_polish=0)
    res = mc.correct(data.stack)
    bad = res.diagnostics["warp_rescued"]
    assert bad.any() and res.corrected[bad].any()
    flows = tpw.upsample_field(_t(res.fields[bad]), (128, 128))
    want = twarp.warp_frame_flow(_t(data.stack[bad]), flows).numpy()
    np.testing.assert_array_equal(res.corrected[bad], want)
