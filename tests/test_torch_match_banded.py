"""The port's banded matcher (`match_radius`) against kcmc_tpu's:
geometry fields equal, match indices, distances and flags exactly equal
for several radii, both sub-bucket sizes, capacity overflow and the
non-mutual rule, and the affine and pyramid slices with `match_radius`
end to end against backend="jax"."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu.ops import match_banded as jmb
from kcmc_tpu.utils import metrics as jmetrics
from kcmc_tpu.utils import synthetic as jsynthetic
from kcmc_tpu_torch.ops import match_banded as tmb


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs here are many small tensor ops, which torch's
    intra-op threads only slow down when several test processes share the
    host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape,radius,K,tile,slack,nms", [
    ((512, 512), 12.0, 4096, 64, 2.0, 4),
    ((512, 512), 17.0, 4096, 64, 2.0, 4),
    ((160, 192), 6.0, 400, 32, 1.0, None),
    ((130, 250), 40.0, 700, 48, 3.0, 8),
])
def test_make_geometry_identical(shape, radius, K, tile, slack, nms):
    want = jmb.make_geometry(shape, radius, K, K, tile=tile, slack=slack, nms_tile=nms)
    got = tmb.make_geometry(shape, radius, K, K, tile=tile, slack=slack, nms_tile=nms)
    assert want._fields == got._fields
    for name, a, b in zip(want._fields, want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


def _case(seed, K=400, B=3, shape=(160, 192)):
    """Reference keypoints with random descriptors (5 zero ones, 5%
    invalid), and B frames of the same keypoints moved by ~3 px with 8%
    of their bits flipped, shuffled, some of them outside the frame and
    10% invalid."""
    rng = np.random.default_rng(seed)
    H, W = shape
    ref_xy = rng.uniform(0, [W, H], (K, 2)).astype(np.float32)
    ref_desc = rng.integers(0, 2**32, (K, 8), dtype=np.uint64).astype(np.uint32)
    ref_desc[:5] = 0
    ref_valid = rng.uniform(size=K) < 0.95
    q_xy = (ref_xy[None] + rng.normal(0, 3, (B, K, 2))).astype(np.float32)
    q_xy[:, :7] = rng.uniform(-20, max(H, W) + 20, (B, 7, 2))
    bits = np.unpackbits(ref_desc.view(np.uint8), bitorder="little").reshape(K, 256)
    qb = bits[None] ^ (rng.uniform(size=(B, K, 256)) < 0.08)
    q_desc = np.packbits(qb.astype(np.uint8), axis=-1, bitorder="little").view(np.uint32)
    perm = rng.permutation(K)
    return (ref_xy, ref_desc, ref_valid, q_xy[:, perm], q_desc.reshape(B, K, 8)[:, perm],
            rng.uniform(size=(B, K)) < 0.9)


def _i64(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("radius,slack,K,mutual", [
    (6.0, 2.0, 400, True),  # sub-buckets of tile // 4
    (20.0, 2.0, 400, True),  # sub-buckets of tile // 2
    (40.0, 2.0, 400, True),
    (12.0, 1.0, 1500, True),  # capacity overflow, queries and references
    (12.0, 2.0, 400, False),
])
def test_banded_match_identical(radius, slack, K, mutual):
    """Indices, best and second distances and validity exactly equal to
    the reference's per-frame matcher (vmapped), masked slots included."""
    shape = (160, 192)
    ref_xy, ref_desc, ref_valid, q_xy, q_desc, q_valid = _case(int(radius * 10 + K), K=K)
    gj = jmb.make_geometry(shape, radius, K, K, tile=64, slack=slack, nms_tile=4)
    bj = jmb.build_banded_ref(gj, jnp.asarray(ref_xy), jnp.asarray(ref_desc),
                              jnp.asarray(ref_valid))
    want = jax.jit(jax.vmap(lambda d, xy, v: jmb.banded_match(gj, bj, d, xy, v, mutual=mutual)))(
        jnp.asarray(q_desc), jnp.asarray(q_xy), jnp.asarray(q_valid))
    gt = tmb.make_geometry(shape, radius, K, K, tile=64, slack=slack, nms_tile=4)
    bt = tmb.build_banded_ref(gt, torch.as_tensor(ref_xy), _i64(ref_desc),
                              torch.as_tensor(ref_valid))
    np.testing.assert_array_equal(np.asarray(bj.ref_sub), bt.ref_sub.numpy())
    np.testing.assert_array_equal(np.asarray(bj.cand_idx), bt.cand_idx.numpy())
    got = tmb.banded_match(gt, bt, _i64(q_desc), torch.as_tensor(q_xy),
                           torch.as_tensor(q_valid), mutual=mutual)
    for f in ("idx", "dist", "second", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), getattr(got, f).numpy(),
                                      err_msg=f)
    assert int(got.valid.sum()) > K  # the case matches, on average > 1/3 per frame
    if slack == 1.0:
        # overflow: valid reference keypoints dropped (sub-bucket G) and
        # valid queries left unmatched for want of a tile slot
        G = gt.gh * gt.gw
        live = ref_valid & np.any(ref_desc != 0, axis=-1)
        assert (bt.ref_sub.numpy()[live] == G).any()
        assert (q_valid & (got.dist.numpy() == tmb.IBIG)).any()


# ---------------------------------------------------------------------------
# the slices with match_radius


@pytest.mark.parametrize("model,scene,kw", [
    ("affine", dict(sigma_range=(0.7, 1.4)), dict(max_keypoints=512)),
    ("similarity", {}, dict(n_octaves=2, warp="jnp")),
], ids=["affine", "pyramid"])
def test_banded_slices_match_jax_backend(model, scene, kw, record_property):
    """match_radius=14 on both sides: transforms within 1e-3 px RMSE of
    backend="jax", matches and inliers within +-2 (the oriented words
    differ in a few bits, ROADMAP queue 3; the dense matcher shows the
    same on these frames), under 0.05 px from the truth. The affine run
    takes K7's plain version, the reference its gather warp; the pyramid
    run takes the gather warp on both sides."""
    data = jsynthetic.make_drift_stack(4, (128, 128), model=model, seed=0, **scene)
    kw = dict(kw, batch_size=4, match_radius=14.0)
    want = kcmc_tpu.MotionCorrector(model=model, backend="jax", **kw).correct(data.stack)
    got = kcmc_tpu_torch.MotionCorrector(model=model, device="cpu", **kw).correct(data.stack)
    gap = jmetrics.transform_rmse(got.transforms, want.transforms, (128, 128))
    record_property("transform_rmse_gap_px", float(gap))
    assert gap <= 1e-3
    dn = np.abs(want.diagnostics["n_inliers"].astype(int) - got.diagnostics["n_inliers"])
    assert dn.max() <= 2
    np.testing.assert_array_equal(want.diagnostics["n_keypoints"], got.diagnostics["n_keypoints"])
    dm = np.abs(want.diagnostics["n_matches"].astype(int) - got.diagnostics["n_matches"])
    assert dm.max() <= 2
    gt = jmetrics.relative_transforms(data.transforms)
    assert jmetrics.transform_rmse(got.transforms, gt, (128, 128)) < 0.05
    assert not got.diagnostics["warp_rescued"].any()
