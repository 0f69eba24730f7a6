"""The piecewise routes this slice of the port adds, against kcmc_tpu:
the per-patch field estimate with rigid, similarity and affine patch
fits, and end to end against backend="jax": piecewise patch_model
rigid / similarity / affine (the affine case through the banded
matcher) and a grid of 6400 cells, beyond K8's 6144, through the flow
route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu.ops import piecewise as jpw
from kcmc_tpu.utils import metrics as jmetrics
from kcmc_tpu.utils import synthetic as jsynthetic
from kcmc_tpu_torch.ops import piecewise as tpw
from kcmc_tpu_torch.ops.piecewise import upsample_field
from kcmc_tpu_torch.ops.warp import warp_frame_flow
from kcmc_tpu_torch.utils import prng


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs here are many small tensor ops, which torch's
    intra-op threads only slow down when several test processes share the
    host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Field and pixel tolerances of the end-to-end piecewise comparisons:
# the port's fields within 1e-3 px RMSE of the reference's (measured
# 5e-4 for rigid and similarity patches, 2.5e-7 on the 6400-cell grid);
# the flow route within 2% of max|frame| of the gather warp of the same
# fields away from the border (measured 1.35% on 1.6-px cells, where
# the two-pass split's O(|r| |grad r|) term is largest).
FIELD_TOL = 1e-3
WIDE_PIXEL_TOL = 0.02

PATCH = dict(batch_size=4, n_hypotheses=64, patch_hypotheses=16, refine_hypotheses=8,
             field_polish=1, warp="jnp")


def _field_matches(seed=0, N=1500, shape=(256, 256)):
    """Matches displaced by a smooth field plus 20% outliers, 10% invalid
    (test_torch_piecewise's case)."""
    rng = np.random.default_rng(seed)
    field = (rng.uniform(-2, 2, (8, 8, 2)) + [3.1, -1.7]).astype(np.float32)
    src = rng.uniform(0, shape[0] - 1, (N, 2)).astype(np.float32)
    flow = jsynthetic.upsample_field(field, shape)
    xi, yi = np.clip(np.rint(src).astype(int), 0, shape[0] - 1).T
    dst = (src + flow[yi, xi] + rng.normal(0, 0.2, (N, 2))).astype(np.float32)
    out = rng.uniform(size=N) < 0.2
    dst[out] = rng.uniform(0, shape[0] - 1, (int(out.sum()), 2))
    return src, dst, rng.uniform(size=N) < 0.9


@pytest.mark.parametrize("patch_model", ["rigid", "similarity", "affine"])
def test_estimate_field_patch_models_match(patch_model):
    """The per-patch field estimate with rigid, similarity or affine
    patch fits, three passes, on 1500 matches of a smooth field: within
    1e-4 px of the reference (every patch has members enough to pin its
    fit)."""
    src, dst, valid = _field_matches()
    kw = dict(grid=(8, 8), shape=(256, 256), n_global_hyps=64, patch_hyps=32,
              global_threshold=8.0, patch_threshold=2.0, prior=2.0, smooth_sigma=0.4,
              passes=3, refine_reach_scale=0.5, refine_hyps=8, patch_model=patch_model)
    key = jax.random.fold_in(jax.random.key(0), 3)
    want = jpw.estimate_field(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), key, **kw)
    got = tpw.estimate_field(torch.as_tensor(src[None]), torch.as_tensor(dst[None]),
                             torch.as_tensor(valid[None]),
                             prng.fold_in(prng.key(0), torch.tensor([3])), **kw)
    assert np.abs(np.asarray(want.field) - got.field[0].numpy()).max() <= 1e-4
    assert int(want.n_inliers) == int(got.n_inliers[0])


@pytest.mark.parametrize("patch_model,extra", [
    ("rigid", {}),
    ("similarity", {}),
    # one pass on a 4x4 grid: the refinement passes' 0.75-pitch reach
    # leaves patches of this sparse 128^2 scene with fewer than three
    # members, whose affine normal system is singular (ROADMAP queue 3)
    ("affine", {"patch_grid": (4, 4), "field_passes": 1, "match_radius": 10.0}),
])
def test_patch_models_match_jax_backend(patch_model, extra, record_property):
    """Piecewise with rigid, similarity or affine patch fits (the affine
    case also through the banded matcher), the gather warp on both
    sides: fields within FIELD_TOL px RMSE of backend="jax", identical
    keypoint, match and global-inlier counts, and no farther from the
    truth than the reference plus 0.01 px."""
    data = jsynthetic.make_piecewise_stack(4, (128, 128), seed=0)
    kw = dict(PATCH, patch_model=patch_model, **extra)
    want = kcmc_tpu.MotionCorrector(model="piecewise", backend="jax", **kw).correct(data.stack)
    got = kcmc_tpu_torch.MotionCorrector(model="piecewise", device="cpu", **kw).correct(
        data.stack)
    for k in ("n_keypoints", "n_matches", "n_inliers"):
        np.testing.assert_array_equal(want.diagnostics[k], got.diagnostics[k], err_msg=k)
    gap = jmetrics.field_rmse(got.fields, want.fields)
    record_property("field_rmse_gap_px", float(gap))
    assert gap <= FIELD_TOL
    if got.fields.shape == data.fields.shape:
        truth = data.fields - data.fields[0]
        assert (jmetrics.field_rmse(got.fields, truth)
                <= jmetrics.field_rmse(want.fields, truth) + 0.01)


def test_piecewise_grid_beyond_k8_runs_on_cpu(record_property):
    """An 80x80 grid (6400 cells, beyond K8's 6144) corrects on the CPU
    through the flow route: fields within FIELD_TOL px RMSE of
    backend="jax" (whose CPU route is the gather warp of the same
    fields), identical keypoint, match and global-inlier counts, and the
    corrected frames within WIDE_PIXEL_TOL of max|frame| of the gather
    warp of the port's own fields, away from the 8-px border."""
    data = jsynthetic.make_piecewise_stack(2, (128, 128), seed=0)
    kw = dict(batch_size=2, patch_grid=(80, 80), max_keypoints=128, n_hypotheses=32,
              patch_hypotheses=8, refine_hypotheses=4, field_polish=1, field_passes=2)
    want = kcmc_tpu.MotionCorrector(model="piecewise", backend="jax", **kw).correct(data.stack)
    got = kcmc_tpu_torch.MotionCorrector(model="piecewise", device="cpu", **kw).correct(
        data.stack)
    assert got.fields.shape == (2, 80, 80, 2) and np.isfinite(got.fields).all()
    for k in ("n_keypoints", "n_matches", "n_inliers"):
        np.testing.assert_array_equal(want.diagnostics[k], got.diagnostics[k], err_msg=k)
    gap = jmetrics.field_rmse(got.fields, want.fields)
    record_property("field_rmse_gap_px", float(gap))
    assert gap <= FIELD_TOL
    assert not got.diagnostics["warp_rescued"].any()
    gather = warp_frame_flow(torch.as_tensor(data.stack),
                             upsample_field(torch.as_tensor(got.fields), (128, 128))).numpy()
    rel = np.abs(gather - got.corrected)[:, 8:-8, 8:-8].max() / np.abs(data.stack).max()
    record_property("gather_gap_rel", float(rel))
    assert rel <= WIDE_PIXEL_TOL
