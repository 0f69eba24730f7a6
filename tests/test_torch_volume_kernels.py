"""Kernels K9 and K10 of the PyTorch port and the 3D detect and describe
stages against kcmc_tpu on the same numpy-seeded inputs: K9's plain
version against the Pallas kernel in interpret mode and the jnp route,
keypoints against both reference routes, the tile-aligned selection
against the general one, K10's plain version against interpret mode bit
for bit, and the 3D descriptor words against both reference routes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kcmc_tpu.ops import describe3d as jdescribe3d
from kcmc_tpu.ops import detect3d as jdetect3d
from kcmc_tpu.ops import pallas_detect3d as pd3
from kcmc_tpu.ops import pallas_patch as pp
from kcmc_tpu.ops import patterns as jpatterns
from kcmc_tpu.utils import synthetic as jsynthetic
from kcmc_tpu_torch.ops import cuda_detect3d, cuda_patch3d
from kcmc_tpu_torch.ops import describe3d as tdescribe3d
from kcmc_tpu_torch.ops import detect3d as tdetect3d
from kcmc_tpu_torch.ops import patterns as tpatterns
from kcmc_tpu_torch.ops.detect import Keypoints as TKeypoints

needs_element_indexing = pytest.mark.skipif(
    not pp.ELEMENT_INDEXING, reason="this jax build lacks pl.Element (K10's Pallas layout)"
)


@pytest.fixture(scope="module", params=["zero_background", "camera_offset"])
def vols(request):
    """Blob volumes decay to ~0 at the faces; the camera-offset variant
    (background 100 +- noise, as tests/test_pallas_detect3d.py builds it)
    exercises the gradient re-masking at the volume border."""
    data = jsynthetic.make_drift_stack_3d(n_frames=2, shape=(16, 64, 64), seed=1)
    stack = np.asarray(data.stack, np.float32)
    if request.param == "camera_offset":
        rng = np.random.default_rng(7)
        stack = stack * 50.0 + 100.0 + rng.normal(0, 2.0, stack.shape)
    return stack.astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def _tkps(k):
    return TKeypoints(_t(k.xy), _t(k.score), _t(k.valid))


def _bits(a, b) -> int:
    x = (np.asarray(a).astype(np.uint32) ^ np.asarray(b).astype(np.uint32)).view(np.uint8)
    return int(np.unpackbits(x).sum())


def test_3d_pattern_copy_matches():
    np.testing.assert_array_equal(tpatterns.PATTERN_3D, jpatterns.PATTERN_3D)
    assert (tpatterns.RADIUS_XY, tpatterns.RADIUS_Z) == (jpatterns.RADIUS_XY, jpatterns.RADIUS_Z)
    np.testing.assert_array_equal(
        tdescribe3d._SEL_3D_INDEX, np.argmax(jdescribe3d._SEL_3D, axis=0)
    )


def test_k9_plain_matches_pallas_interpret(vols):
    """Response within 1e-5 of max|resp| (float summation order), NMS
    winners on > 99.9% of interior voxels, blur within 1e-5 relative."""
    resp_p, nms_p, smooth_p = (
        np.asarray(a) for a in pd3.response_fields_3d(
            jnp.asarray(vols), smooth_sigma=2.0, interpret=True)
    )
    resp_t, smooth_t = cuda_detect3d.response_fields_3d(_t(vols), smooth_sigma=2.0)
    scale = np.abs(resp_p).max()
    assert np.abs(resp_t.numpy() - resp_p).max() <= 1e-5 * scale
    nms_t = tdetect3d._nms(resp_t).numpy()
    interior = np.s_[:, 2:-2, 2:-2, 2:-2]
    agree = (np.isfinite(nms_t[interior]) == np.isfinite(nms_p[interior])).mean()
    assert agree > 0.999
    assert np.abs(smooth_t.numpy() - smooth_p).max() <= 1e-5 * np.abs(smooth_p).max()


def test_k9_plain_matches_jnp_route(vols, record_property):
    """K9's plain version, and the port's jnp-route mirror, against the
    reference's jnp route: response within 1e-5 of max|resp|, blur within
    1e-5 relative (on this CPU the sums are in the same order and agree
    bit for bit)."""
    resp_j = np.asarray(jax.vmap(jdetect3d.harris_response_3d)(jnp.asarray(vols)))
    blur_j = np.asarray(jax.vmap(lambda v: jdetect3d.gaussian_blur_3d(v, 2.0))(jnp.asarray(vols)))
    resp_t, smooth_t = cuda_detect3d.response_fields_3d_plain(_t(vols), smooth_sigma=2.0)
    scale = np.abs(resp_j).max()
    record_property("resp_rel_err_vs_jnp_route",
                    float(np.abs(resp_t.numpy() - resp_j).max() / scale))
    for r in (resp_t, tdetect3d.harris_response_3d(_t(vols))):
        assert np.abs(r.numpy() - resp_j).max() <= 1e-5 * scale
    for s in (smooth_t, tdetect3d.gaussian_blur_3d(_t(vols), 2.0)):
        assert np.abs(s.numpy() - blur_j).max() <= 1e-5 * np.abs(blur_j).max()
    np.testing.assert_array_equal(
        tdetect3d._maxpool3_same(resp_t).numpy(),
        np.asarray(jax.vmap(jdetect3d._maxpool3_same)(jnp.asarray(resp_t.numpy()))),
    )


def test_detect_matches_both_reference_routes(vols, record_property):
    """Identical `valid`, xy within 1e-4 of the jnp route and 1e-3 of the
    Pallas route (the reference's own contract between its routes)."""
    kw = dict(max_keypoints=128, threshold=1e-4, border=6)
    kj = jdetect3d.detect_keypoints_3d_batch(jnp.asarray(vols), **kw)
    kp = jdetect3d.detect_keypoints_3d_batch(
        jnp.asarray(vols), **kw, use_pallas=True, interpret=True)
    kt = tdetect3d.detect_keypoints_3d_batch(_t(vols), **kw)
    single = [tdetect3d.detect_keypoints_3d(_t(v), **kw) for v in vols]
    for ref, tol in ((kj, 1e-4), (kp, 1e-3)):
        np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(ref.valid))
        both = kt.valid.numpy()
        gap = float(np.abs(kt.xy.numpy() - np.asarray(ref.xy))[both].max())
        record_property(f"xy_gap_px_within_{tol}", gap)
        assert gap < tol
    assert kt.valid.sum() > 50
    for i, s in enumerate(single):
        np.testing.assert_array_equal(s.valid.numpy(), np.asarray(kj.valid)[i])
        assert np.abs(s.xy.numpy() - np.asarray(kj.xy)[i]).max() < 1e-4


@pytest.mark.parametrize("border", [0, 3, 8, 16])
def test_selection_paths_match_reference(vols, border):
    """Both selection paths (the tile-aligned fast path where border % 8
    == 0, the general path through `_force_general`) against each other
    and against the reference's `_select_keypoints_3d` on the same
    dense fields."""
    resp = cuda_detect3d.response_fields_3d_plain(_t(vols))[0]
    nms = tdetect3d._nms(resp)
    args = (512, 1e-4, border)
    fast = tdetect3d._select_keypoints_3d(resp, nms, *args)
    general = tdetect3d._select_keypoints_3d(resp, nms, *args, _force_general=True)
    for a, b in zip(fast, general):
        assert torch.equal(a, b)
    ref = jax.vmap(lambda r, n: jdetect3d._select_keypoints_3d(r, n, *args))(
        jnp.asarray(resp.numpy()), jnp.asarray(nms.numpy()))
    np.testing.assert_array_equal(fast.valid.numpy(), np.asarray(ref.valid))
    assert np.abs(fast.xy.numpy() - np.asarray(ref.xy)).max() < 1e-5
    np.testing.assert_array_equal(fast.score.numpy(), np.asarray(ref.score))


@needs_element_indexing
def test_k10_plain_matches_pallas_interpret():
    """Bit for bit: the plain version issues interpret mode's three FMAs
    (its float32 results are exact in float64 before one rounding)."""
    rng = np.random.default_rng(0)
    B, K, D, H, W = 2, 64, 12, 40, 40
    padded = (rng.normal(size=(B, D + 8, H + 20, W + 20)) * 100).astype(np.float32)
    xyz = np.stack([rng.uniform(0, W - 1, (B, K)), rng.uniform(0, H - 1, (B, K)),
                    rng.uniform(0, D - 1, (B, K))], -1).astype(np.float32)
    want = np.asarray(pp.extract_blended_3d(jnp.asarray(padded), jnp.asarray(xyz), 8, 20,
                                            interpret=True))
    got = cuda_patch3d.extract_blended_3d(_t(padded), _t(xyz), 8, 20).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def words_case():
    data = jsynthetic.make_drift_stack_3d(n_frames=3, shape=(16, 64, 64), seed=2)
    v = np.asarray(data.stack, np.float32)
    kps = jax.vmap(lambda x: jdetect3d.detect_keypoints_3d(x, max_keypoints=64, border=4))(
        jnp.asarray(v))
    return v, kps


@needs_element_indexing
def test_words_match_both_reference_routes(words_case, record_property):
    """At most 1e-3 of the bits differ from either reference route (the
    reference's own contract between its routes,
    tests/test_pallas_patch.py:79-101); on this scene none does, against
    either route."""
    v, kps = words_case
    ref_jnp = jdescribe3d.describe_keypoints_3d_batch(jnp.asarray(v), kps, use_pallas=False)
    ref_pal = jdescribe3d.describe_keypoints_3d_batch(
        jnp.asarray(v), kps, use_pallas=True, interpret=True)
    tk = _tkps(kps)
    got = tdescribe3d.describe_keypoints_3d_batch(_t(v), tk).numpy()
    oracle = np.stack([
        tdescribe3d.describe_keypoints_3d(_t(v[i]), TKeypoints(*(x[i] for x in tk))).numpy()
        for i in range(len(v))
    ])
    n_bits = 32 * got.size
    assert np.asarray(kps.valid).sum() > 100
    record_property("word_bits", n_bits)
    record_property("word_bits_differing_vs_jnp_route", _bits(got, ref_jnp))
    record_property("word_bits_differing_vs_pallas_route", _bits(got, ref_pal))
    assert _bits(got, ref_jnp) <= 1e-3 * n_bits
    assert _bits(got, ref_pal) <= 1e-3 * n_bits
    assert _bits(oracle, ref_jnp) <= 1e-3 * n_bits
    np.testing.assert_array_equal(got[~np.asarray(kps.valid)], 0)
