"""The rigid3d slice of the PyTorch port (config 5) against kcmc_tpu on
the same numpy-seeded inputs: the rigid3d solvers, consensus on (K, 3)
points, the bounded volume warp and the gather warp, stack validation,
a JAX-prepared 3D reference, and MotionCorrector(model="rigid3d") end to
end against backend="jax"."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu.models import transforms as jtransforms
from kcmc_tpu.ops import warp as jwarp
from kcmc_tpu.ops import warp_field as jwarp_field
from kcmc_tpu.ops.ransac import consensus_batch as j_consensus
from kcmc_tpu.utils import metrics as jmetrics
from kcmc_tpu.utils import synthetic as jsynthetic
from kcmc_tpu_torch.backends.torch_backend import TorchBackend
from kcmc_tpu_torch.models import transforms as ttransforms
from kcmc_tpu_torch.ops import warp as twarp
from kcmc_tpu_torch.ops import warp_field as twarp_field
from kcmc_tpu_torch.ops.ransac import consensus_batch as t_consensus
from kcmc_tpu_torch.utils import metrics as tmetrics
from kcmc_tpu_torch.utils import prng

SHAPE = (16, 64, 64)  # (D, H, W) of the slice tests


def _t(a):
    return torch.as_tensor(np.array(a))


def _apply(M, pts):
    return (pts.astype(np.float64) @ np.swapaxes(M[..., :3, :3], -1, -2).astype(np.float64)
            + M[..., None, :3, 3])


def _kabsch64(src, dst, w):
    """The weighted Kabsch solution in float64 (numpy)."""
    s, d, w = (np.asarray(a, np.float64) for a in (src, dst, w))
    cs = (w[:, None] * s).sum(0) / w.sum()
    cd = (w[:, None] * d).sum(0) / w.sum()
    U, _, Vt = np.linalg.svd(((s - cs) * w[:, None]).T @ (d - cd))
    R = Vt.T @ np.diag([1.0, 1.0, np.linalg.det(Vt.T @ U.T)]) @ U.T
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = cd - R @ cs
    return M


def _rigid(rng, B, angle=0.05, shift=4.0):
    M = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for b in range(B):
        M[b, :3, :3] = jsynthetic._euler(rng.normal(0, angle, 3))
        M[b, :3, 3] = rng.normal(0, shift, 3)
    return M


def _clouds(rng, B, N, extent=(256.0, 256.0, 32.0)):
    return (rng.uniform(size=(B, N, 3)) * np.array(extent)).astype(np.float32)


@pytest.mark.parametrize("name", ["solve_rigid3d", "solve_rigid3d_accurate"])
def test_rigid3d_solvers_match_jax(name, record_property):
    """On 64 weighted clouds in a 256 x 256 x 32 volume: rotations within
    1e-5, translations within 1e-5 of the cloud extent (1e-5 absolute is
    below one float32 ulp at 256 px), and over all clouds no farther from
    a float64 Kabsch solve than the reference plus one ulp at the
    extent."""
    rng = np.random.default_rng(0)
    B, N = 64, 40
    src = _clouds(rng, B, N)
    M = _rigid(rng, B)
    dst = (_apply(M, src) + rng.normal(0, 0.3, (B, N, 3))).astype(np.float32)
    w = (rng.uniform(size=(B, N)) > 0.3).astype(np.float32)
    want = np.asarray(jax.vmap(getattr(jtransforms, name))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    got = getattr(ttransforms, name)(_t(src), _t(dst), _t(w)).numpy()
    record_property("rotation_gap", float(np.abs(got[:, :3, :3] - want[:, :3, :3]).max()))
    record_property("translation_gap_px", float(np.abs(got[:, :3, 3] - want[:, :3, 3]).max()))
    assert np.abs(got[:, :3, :3] - want[:, :3, :3]).max() <= 1e-5
    assert np.abs(got[:, :3, 3] - want[:, :3, 3]).max() <= 1e-5 * 256.0
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    exact = np.stack([_kabsch64(src[b], dst[b], w[b]) for b in range(B)])

    def err(a):
        return np.abs(_apply(a, src) - _apply(exact, src)).max()

    record_property("float64_gap_px_port", float(err(got)))
    record_property("float64_gap_px_reference", float(err(want)))
    assert err(got) <= err(want) + np.spacing(np.float32(256.0))
    # degenerate: no weight mass falls back to the identity
    z = torch.zeros((2, 3, 3))
    np.testing.assert_array_equal(
        getattr(ttransforms, name)(z, z, torch.zeros(2, 3)).numpy(), np.tile(np.eye(4), (2, 1, 1))
    )


def test_rigid3d_consensus_matches_jax():
    """Identical inlier counts and masks, transforms within 1e-4 px over
    the matched points (the 3D ladder path: score_cap, budget rungs)."""
    rng = np.random.default_rng(1)
    B, N = 4, 512
    src = _clouds(rng, B, N)
    M = _rigid(rng, B)
    dst = (_apply(M, src) + rng.normal(0, 0.3, (B, N, 3))).astype(np.float32)
    out = rng.uniform(size=(B, N)) < 0.3
    dst[out] = _clouds(rng, 1, int(out.sum()))[0]
    valid = rng.uniform(size=(B, N)) < 0.7
    valid[2, 20:] = False
    valid[3] = False
    idx = np.arange(3, 3 + B, dtype=np.int32)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(jnp.asarray(idx))
    tkeys = prng.fold_in(prng.key(0), torch.as_tensor(idx))
    kw = dict(n_hypotheses=128, threshold=2.0, refine_iters=2, score_cap=256,
              budget_rungs=4, early_exit_frac=0.7)
    want = j_consensus(jtransforms.get_model("rigid3d"), jnp.asarray(src), jnp.asarray(dst),
                       jnp.asarray(valid), jkeys, **kw)
    got = t_consensus(ttransforms.get_model("rigid3d"), _t(src), _t(dst), _t(valid), tkeys, **kw)
    np.testing.assert_array_equal(np.asarray(want.n_inliers), got.n_inliers.numpy())
    np.testing.assert_array_equal(np.asarray(want.inlier_mask), got.inlier_mask.numpy())
    gap = np.abs(_apply(got.transform.numpy(), src) - _apply(np.asarray(want.transform), src))
    assert gap.max() <= 1e-4
    assert np.abs(_apply(got.transform.numpy()[:3], src[:3]) - _apply(M[:3], src[:3])).max() < 0.5
    np.testing.assert_array_equal(got.transform.numpy()[3], np.eye(4, dtype=np.float32))


@pytest.fixture(scope="module")
def warp_case():
    data = jsynthetic.make_drift_stack_3d(4, SHAPE, seed=3)
    M = jmetrics.relative_transforms(data.transforms).astype(np.float32)
    M[2, :3, :3] = jsynthetic._euler(np.array([0.0, 0.0, 0.4]))  # beyond max_px
    M[3, 3, 0] = 1e-3  # not affine
    return np.asarray(data.stack, np.float32), M


def test_warp_batch_rigid3d_matches_jax(warp_case):
    """Within 1e-5 of max|volume| and identical ok flags, volumes beyond
    the residual bound or not affine zeroed."""
    vols, M = warp_case
    want, want_ok = jwarp_field.warp_batch_rigid3d(
        jnp.asarray(vols), jnp.asarray(M), max_px=6, with_ok=True)
    got, ok = twarp_field.warp_batch_rigid3d(_t(vols), _t(M), max_px=6)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    assert ok.tolist() == [True, True, False, False]
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * np.abs(vols).max()
    assert float(got[2:].abs().max()) == 0.0


def test_warp_volume_matches_jax(warp_case):
    """Within 1e-5 of max|volume| (float32 rounding of the source map)."""
    vols, M = warp_case
    want = np.asarray(jax.vmap(jwarp.warp_volume)(jnp.asarray(vols), jnp.asarray(M)))
    got = twarp.warp_volume(_t(vols), _t(M)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(vols).max()


# ---------------------------------------------------------------------------
# the slice


@pytest.fixture(scope="module")
def slice_runs():
    data = jsynthetic.make_drift_stack_3d(4, SHAPE, seed=0)
    kw = dict(model="rigid3d", batch_size=2)
    want = kcmc_tpu.MotionCorrector(backend="jax", **kw).correct(data.stack)
    got = kcmc_tpu_torch.MotionCorrector(device="cpu", **kw).correct(data.stack)
    return data, want, got


def test_rigid3d_gather_warp_policy(slice_runs):
    """warp="jnp" takes the trilinear gather warp (the reference's route
    off the accelerator): the same transforms as the bounded warp's run,
    and its volumes are exactly `warp_volume` of them. Pixels are held
    against the reference only under identical transforms: a 1e-5 px
    gap moves a sample across a volume face, where the gather zeroes."""
    data, want, got = slice_runs
    g = kcmc_tpu_torch.MotionCorrector(
        model="rigid3d", batch_size=2, warp="jnp", device="cpu").correct(data.stack)
    np.testing.assert_array_equal(g.transforms, got.transforms)
    np.testing.assert_array_equal(
        g.corrected, twarp.warp_volume(_t(data.stack), _t(g.transforms)).numpy())
    same = twarp.warp_volume(_t(data.stack), _t(want.transforms)).numpy()
    assert np.abs(same - np.asarray(want.corrected)).max() <= 1e-5 * np.abs(data.stack).max()
    assert not g.diagnostics["warp_rescued"].any()


def test_rigid3d_slice_matches_jax_backend(slice_runs, record_property):
    """Within 1e-3 px transform RMSE of backend="jax" on a 9x9x9 control
    grid, identical keypoint, match and inlier counts, and no worse
    against the truth."""
    data, want, got = slice_runs
    assert got.transforms.shape == (4, 4, 4)
    assert got.corrected.shape == data.stack.shape
    gap = tmetrics.transform_rmse(got.transforms, want.transforms, SHAPE)
    record_property("transform_rmse_px_vs_jax_backend", gap)
    assert gap <= 1e-3
    for k in ("n_keypoints", "n_matches", "n_inliers"):
        np.testing.assert_array_equal(got.diagnostics[k], want.diagnostics[k])
    truth = tmetrics.relative_transforms(data.transforms)
    e_got = tmetrics.transform_rmse(got.transforms, truth, SHAPE)
    e_want = tmetrics.transform_rmse(want.transforms, truth, SHAPE)
    assert e_got <= e_want + 1e-3
    assert not got.diagnostics["warp_rescued"].any()
    assert np.isfinite(got.corrected).all()


def test_stack_validation_both_ways():
    vol_stack = np.zeros((2,) + SHAPE, np.float32)
    with pytest.raises(ValueError, match="rigid3d"):
        kcmc_tpu_torch.MotionCorrector(device="cpu").correct(vol_stack)
    with pytest.raises(ValueError, match=r"\(T, D, H, W\)"):
        kcmc_tpu_torch.MotionCorrector(model="rigid3d", device="cpu").correct(vol_stack[:, 0])
    with pytest.raises(ValueError):
        kcmc_tpu_torch.MotionCorrector(model="rigid3d", device="cpu").correct(vol_stack[0, 0])


@pytest.mark.parametrize("bad", [{"n_octaves": 2}, {"match_radius": 8.0}])
def test_rigid3d_config_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        kcmc_tpu.CorrectorConfig(model="rigid3d", **bad)
    with pytest.raises(ValueError):
        kcmc_tpu_torch.CorrectorConfig(model="rigid3d", **bad)


def test_rigid3d_config_carries_across():
    jcfg = kcmc_tpu.CorrectorConfig(model="rigid3d", max_keypoints=256, max_flow_px=5)
    cfg = kcmc_tpu_torch.config_from_dict(dataclasses.asdict(jcfg))
    assert cfg.unsupported() == []
    assert cfg.resolved_match_precision(True) == jcfg.resolved_match_precision(True) == "bf16"
    assert (cfg.max_keypoints, cfg.max_flow_px) == (256, 5)


def test_reference_from_numpy_takes_a_jax_3d_reference(slice_runs):
    """A reference volume prepared by kcmc_tpu (its jnp route) carries
    across: the same keypoints and words as the port's own preparation
    through K9/K10's plain versions, and a batch registered against it
    gives the reference pipeline's transforms."""
    data, want, _ = slice_runs
    jb = kcmc_tpu.MotionCorrector(model="rigid3d", backend="jax", batch_size=2).backend
    jref = {k: np.asarray(v) for k, v in jb.prepare_reference(data.stack[0]).items()
            if not k.startswith("_")}
    tb = TorchBackend(kcmc_tpu_torch.CorrectorConfig(model="rigid3d", batch_size=2), device="cpu")
    ref = tb.reference_from_numpy(jref)
    own = tb.prepare_reference(data.stack[0])
    assert ref["xy"].shape[-1] == 3
    np.testing.assert_array_equal(ref["valid"].numpy(), own["valid"].numpy())
    np.testing.assert_array_equal(ref["desc"].numpy(), own["desc"].numpy())
    assert np.abs(ref["xy"].numpy() - own["xy"].numpy()).max() < 1e-4
    out = tb.process_batch(data.stack[2:4], ref, np.arange(2, 4))
    assert tmetrics.transform_rmse(out["transform"], want.transforms[2:4], SHAPE) <= 1e-3
    rescued = tb.rescue_warp(data.stack[2:4], {"transform": out["transform"]})
    np.testing.assert_array_equal(
        rescued, twarp.warp_volume(_t(data.stack[2:4]), _t(out["transform"])).numpy()
    )
