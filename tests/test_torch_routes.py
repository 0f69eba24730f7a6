"""The routes this slice of the port adds, against kcmc_tpu: the
dense-flow warp and the separable homography warp (the reference's XLA
forms), the routing chosen from shapes and config (K8 or the flow route
by grid size, K9 or the plain route by blur radius, the homography and
translation warp policies), and end to end against backend="jax":
homography warp="separable", translation warp="matrix" and a rigid3d
blur_sigma of 3.0. The piecewise routes are in
test_torch_piecewise_routes.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu.ops import detect3d as jdetect3d
from kcmc_tpu.ops import warp_field as jwf
from kcmc_tpu.utils import metrics as jmetrics
from kcmc_tpu.utils import synthetic as jsynthetic
from kcmc_tpu_torch.backends.torch_backend import TorchBackend
from kcmc_tpu_torch.ops import cuda_detect3d, cuda_warp_field
from kcmc_tpu_torch.ops import detect3d as tdetect3d
from kcmc_tpu_torch.ops import warp_field as twf
from kcmc_tpu_torch.ops.cuda_warp_matrix import warp_batch_matrix


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs here are many small tensor ops, which torch's
    intra-op threads only slow down when several test processes share the
    host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    return np.stack([jsynthetic.render_scene(rng, (96, 112), n_blobs=100)
                     for _ in range(4)]).astype(np.float32)


@pytest.mark.parametrize("grid,amp", [((6, 5), 3.0), ((40, 48), 5.0)], ids=["smooth", "rough"])
def test_warp_batch_flow_matches(frames, grid, amp):
    """Fields around a mean of a few px (and one of 60 px), and one frame
    whose residual leaves the 6-px bound (zeroed, flagged): within 1e-5
    of max|frame| of the reference's flow warp, equal flags. The rough
    case (2.4-px cells, |grad u| above 1 px/px) is where the two-pass
    split departs most from the gather warp: the port departs the same
    way."""
    rng = np.random.default_rng(1)
    fields = rng.uniform(-amp, amp, (4, *grid, 2)).astype(np.float32)
    fields += np.array([[5.3, -2.2], [0.4, 0.6], [60.2, -31.5], [2.0, 1.0]],
                       np.float32)[:, None, None, :]
    fields[3] *= 4
    flows = np.stack([jsynthetic.upsample_field(f, (96, 112)) for f in fields])
    want, wok = jwf.warp_batch_flow(jnp.asarray(frames), jnp.asarray(flows), max_px=6,
                                    with_ok=True)
    got, gok = twf.warp_batch_flow(torch.as_tensor(frames), torch.as_tensor(flows), max_px=6)
    np.testing.assert_array_equal(np.asarray(wok), gok.numpy())
    assert gok.numpy().tolist() == [True, True, True, False]
    assert np.abs(np.asarray(want) - got.numpy()).max() <= 1e-5 * np.abs(frames).max()


def test_warp_batch_homography_matches(frames):
    """Projective maps within the shear and residual bounds, one sheared
    past the 8-px bound (zeroed, flagged): within 1e-5 of max|frame| of
    the reference's separable homography warp, equal flags."""
    th = 0.01
    Ms = np.stack([
        [[np.cos(th), -np.sin(th), 3.2], [np.sin(th), np.cos(th), -1.7], [2e-5, -1e-5, 1]],
        [[1.01, 0.01, 0.5], [-0.02, 0.99, 0.3], [0, 3e-5, 1.0]],
        [[1, 0.3, 0], [0, 1, 0], [0, 0, 1.0]],
        [[0.98, 0.0, -2.0], [0.01, 1.02, 4.0], [-4e-5, 2e-5, 1.1]],
    ]).astype(np.float32)
    want, wok = jwf.warp_batch_homography(jnp.asarray(frames), jnp.asarray(Ms), shear_px=8,
                                          max_px=4, with_ok=True)
    got, gok = twf.warp_batch_homography(torch.as_tensor(frames), torch.as_tensor(Ms),
                                         shear_px=8, max_px=4)
    np.testing.assert_array_equal(np.asarray(wok), gok.numpy())
    assert gok.numpy().tolist() == [True, True, False, True]
    assert np.abs(np.asarray(want) - got.numpy()).max() <= 1e-5 * np.abs(frames).max()


def test_routes_chosen_from_config():
    """K8 up to 6144 cells and max_px 1024, the flow route beyond; K9 up
    to a blur radius of 6; the separable homography chain and K7 for
    translation when asked. The K8 wrapper raises beyond its limits
    whatever the device."""
    assert cuda_warp_field.supports((78, 78), 6) and cuda_warp_field.supports((8, 8), 1024)
    assert not cuda_warp_field.supports((80, 80), 6)
    assert not cuda_warp_field.supports((8, 8), 1025)
    pw = TorchBackend(kcmc_tpu_torch.CorrectorConfig(model="piecewise"), device="cpu")
    k8 = pw._resolve_field_warp((64, 64))
    assert k8.func is cuda_warp_field.warp_batch_field and k8.keywords == {"max_px": 6}
    wide = TorchBackend(kcmc_tpu_torch.CorrectorConfig(model="piecewise", patch_grid=(80, 80)),
                        device="cpu")
    fr = torch.zeros((1, 64, 64))
    fields = torch.full((1, 80, 80, 2), 0.25)
    out, ok = wide._resolve_field_warp((64, 64))(fr, fields)
    assert ok.all() and not isinstance(wide._resolve_field_warp((64, 64)), functools.partial)
    with pytest.raises(ValueError, match="6144"):
        cuda_warp_field.warp_batch_field(fr, fields)

    assert cuda_detect3d.supports(1.5, 2.16) and not cuda_detect3d.supports(1.5, 2.17)
    assert not cuda_detect3d.supports(2.5, None) and cuda_detect3d.supports(1.5, None)

    def batch_warp(**kw):
        return TorchBackend(kcmc_tpu_torch.CorrectorConfig(**kw),
                            device="cpu")._resolve_batch_warp((512, 512))

    h = batch_warp(model="homography", warp="separable", max_rotation_deg=2.0)
    assert h.func is twf.warp_batch_homography
    assert h.keywords == {"shear_px": 9, "max_px": 4}
    t = batch_warp(model="translation", warp="matrix")
    assert t.func is warp_batch_matrix and t.keywords == {"max_px": 18}


def test_wide_blur_detection_takes_the_plain_route():
    """blur_sigma=3.0 (radius 9): K9 does not take it, so detection runs
    the plain route, the reference's jnp route: the same keypoints
    (positions within 1e-5 px: the subpixel fit rounds differently in a
    last place) and the describe stage's blur within 1e-6 of its max."""
    vols = np.stack([jsynthetic.make_drift_stack_3d(1, (16, 48, 40), seed=s).stack[0]
                     for s in (0, 1)])
    want_kps, want_smooth = jdetect3d.detect_keypoints_3d_batch(
        jnp.asarray(vols), max_keypoints=64, threshold=1e-4, border=4, smooth_sigma=3.0)
    got_kps, got_smooth = tdetect3d.detect_keypoints_3d_batch(
        torch.as_tensor(vols), max_keypoints=64, threshold=1e-4, border=4, smooth_sigma=3.0)
    np.testing.assert_array_equal(np.asarray(want_kps.valid), got_kps.valid.numpy())
    np.testing.assert_allclose(got_kps.xy.numpy(), np.asarray(want_kps.xy), rtol=0, atol=1e-5)
    want_smooth = np.asarray(want_smooth)
    assert np.abs(got_smooth.numpy() - want_smooth).max() <= 1e-6 * np.abs(want_smooth).max()


# ---------------------------------------------------------------------------
# the slices


def _gap_and_counts(want, got, shape, keys=("n_keypoints", "n_matches", "n_inliers")):
    for k in keys:
        np.testing.assert_array_equal(want.diagnostics[k], got.diagnostics[k], err_msg=k)
    return jmetrics.transform_rmse(got.transforms, want.transforms, shape)


@pytest.mark.parametrize("model,warp", [("homography", "separable"), ("translation", "matrix")])
def test_warp_policy_slices_match_jax_backend(model, warp, record_property):
    """The same warp policy on both sides (the reference's XLA route off
    the accelerator; the port's separable chain plus projective residual
    and K7's plain version): transforms within 1e-3 px RMSE, identical
    keypoint, match and inlier counts, under 0.05 px from the truth,
    corrected pixels within 1e-3 of max|frame| away from the border."""
    data = jsynthetic.make_drift_stack(4, (128, 128), model=model, seed=0)
    kw = dict(batch_size=4, warp=warp)
    want = kcmc_tpu.MotionCorrector(model=model, backend="jax", **kw).correct(data.stack)
    got = kcmc_tpu_torch.MotionCorrector(model=model, device="cpu", **kw).correct(data.stack)
    gap = _gap_and_counts(want, got, (128, 128))
    record_property("transform_rmse_gap_px", float(gap))
    assert gap <= 1e-3
    gt = jmetrics.relative_transforms(data.transforms)
    assert jmetrics.transform_rmse(got.transforms, gt, (128, 128)) < 0.05
    assert not got.diagnostics["warp_rescued"].any()
    inner = (slice(None), slice(4, -4), slice(4, -4))
    assert (np.abs(want.corrected[inner] - got.corrected[inner]).max()
            <= 1e-3 * np.abs(data.stack).max())


def test_rigid3d_wide_blur_matches_jax_backend(record_property):
    """blur_sigma=3.0 end to end (detection's plain route, K10's plain
    version): within 1e-3 px transform RMSE of backend="jax" on a 9x9x9
    grid, identical counts."""
    shape = (16, 64, 64)
    data = jsynthetic.make_drift_stack_3d(2, shape, seed=0)
    kw = dict(model="rigid3d", batch_size=2, blur_sigma=3.0)
    want = kcmc_tpu.MotionCorrector(backend="jax", **kw).correct(data.stack)
    got = kcmc_tpu_torch.MotionCorrector(device="cpu", **kw).correct(data.stack)
    gap = _gap_and_counts(want, got, shape)
    record_property("transform_rmse_gap_px", float(gap))
    assert gap <= 1e-3
    assert np.isfinite(got.corrected).all()
