"""Detection in the PyTorch port against kcmc_tpu: K1's plain version
against the Pallas kernel (interpret mode) and the jnp route, and
keypoint selection against `_select_keypoints` on identical fields."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kcmc_tpu.ops import detect as jdetect
from kcmc_tpu.ops.pallas_detect import response_fields
from kcmc_tpu.utils.synthetic import render_scene
from kcmc_tpu_torch.ops import detect as tdetect
from kcmc_tpu_torch.ops.cuda_detect import detect_response, detect_response_plain


def _frames(shape=(80, 96), n=2, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack(
        [render_scene(rng, shape, n_blobs=40) for _ in range(n)]
    ).astype(np.float32)


@pytest.fixture(scope="module")
def fields():
    """(frames, Pallas interpret fields, port plain fields)."""
    fr = _frames()
    j = [np.array(a) for a in response_fields(
        jnp.asarray(fr), smooth_sigma=2.0, interpret=True
    )]
    t = [a.numpy() for a in detect_response_plain(torch.as_tensor(fr), smooth_sigma=2.0)]
    return fr, j, t


def test_k1_plain_matches_pallas_interpret(fields):
    """Tolerance 1e-5 relative to max|resp| (nms) and max|frame| (blur):
    the two differ only in float32 summation rounding. The -inf pattern
    (NMS decisions) must be identical inside the border, and the subpixel
    fields agree to 1e-5 px at the NMS maxima, the only pixels selection
    reads them at (elsewhere an ill-conditioned fit amplifies rounding)."""
    fr, j, t = fields
    b = 16
    inner = (slice(None), slice(b, -b), slice(b, -b))
    jn, tn = j[0][inner], t[0][inner]
    np.testing.assert_array_equal(np.isfinite(jn), np.isfinite(tn))
    fin = np.isfinite(jn)
    scale = np.abs(jn[fin]).max()
    assert np.abs(jn[fin] - tn[fin]).max() <= 1e-5 * scale
    for a, c in zip(j[1:3], t[1:3]):
        assert np.abs(a[inner][fin] - c[inner][fin]).max() <= 1e-5
    assert np.abs(j[3] - t[3]).max() <= 1e-5 * np.abs(fr).max()


def test_k1_wrapper_cpu_route_is_plain(fields):
    fr, _, t = fields
    got = detect_response(torch.as_tensor(fr), smooth_sigma=2.0)
    for a, c in zip(got, t):
        np.testing.assert_array_equal(a.numpy(), c)


def test_k1_plain_matches_jnp_route(fields):
    """Against the jnp path (separate HIGHEST-precision convolutions,
    edge-replicated subpixel fields): same response up to rounding in
    the interior."""
    fr, _, t = fields
    resp = np.asarray(jax.vmap(jdetect.harris_response)(jnp.asarray(fr)))
    nms = np.asarray(jax.vmap(lambda r: jnp.where(
        r >= jdetect._maxpool_same(r, 5), r, -jnp.inf))(jnp.asarray(resp)))
    inner = (slice(None), slice(16, -16), slice(16, -16))
    np.testing.assert_array_equal(np.isfinite(nms[inner]), np.isfinite(t[0][inner]))
    fin = np.isfinite(nms[inner])
    scale = np.abs(resp).max()
    assert np.abs(nms[inner][fin] - t[0][inner][fin]).max() <= 1e-5 * scale
    blur = np.asarray(jax.vmap(lambda f: jdetect.gaussian_blur(f, 2.0))(jnp.asarray(fr)))
    assert np.abs(blur - t[3]).max() <= 1e-5 * np.abs(fr).max()


def test_port_jnp_route_helpers_match():
    fr = _frames(n=1)[0]
    for name, tol in (("harris_response", 1e-5), ("gaussian_blur", 1e-5)):
        args = (2.0,) if name == "gaussian_blur" else ()
        want = np.asarray(getattr(jdetect, name)(jnp.asarray(fr), *args))
        got = getattr(tdetect, name)(torch.as_tensor(fr), *args).numpy()
        assert np.abs(want - got).max() <= tol * np.abs(want).max(), name
    resp = np.array(jdetect.harris_response(jnp.asarray(fr)))
    ox_j, oy_j = jdetect._subpixel_fields(jnp.asarray(resp))
    ox_t, oy_t = tdetect._subpixel_fields(torch.as_tensor(resp)[None])
    np.testing.assert_array_equal(np.asarray(ox_j), ox_t[0].numpy())
    np.testing.assert_array_equal(np.asarray(oy_j), oy_t[0].numpy())
    mp_j = np.asarray(jdetect._maxpool_same(jnp.asarray(resp), 4))
    mp_t = tdetect._maxpool_same(torch.as_tensor(resp)[None], 4)[0].numpy()
    np.testing.assert_array_equal(mp_j, mp_t)


@pytest.mark.parametrize(
    "shape,border,force_general",
    [((80, 96), 16, False), ((80, 96), 16, True), ((75, 90), 13, False)],
)
def test_select_keypoints_identical(fields, shape, border, force_general):
    """Identical fields into both selections give identical keypoints,
    on the tile-aligned fast path, the forced general path and a
    genuinely unaligned geometry."""
    _, j, _ = fields
    H, W = shape
    nms, ox, oy = (a[:, :H, :W] for a in j[:3])
    K, thr = 48, 1e-4
    want = jax.vmap(lambda a, b, c: jdetect._select_keypoints(
        a, b, c, K, thr, border, 8, _force_general=force_general
    ))(jnp.asarray(nms), jnp.asarray(ox), jnp.asarray(oy))
    got = tdetect._select_keypoints(
        *(torch.as_tensor(np.ascontiguousarray(a)) for a in (nms, ox, oy)),
        K, thr, border, 8, _force_general=force_general,
    )
    np.testing.assert_array_equal(np.asarray(want.valid), got.valid.numpy())
    np.testing.assert_array_equal(np.asarray(want.xy), got.xy.numpy())
    np.testing.assert_array_equal(np.asarray(want.score), got.score.numpy())


def test_select_keypoints_pads_tiny_frames(fields):
    """K beyond the tile count: the selection pads back up to K with
    invalid slots, as the reference does."""
    _, j, _ = fields
    nms, ox, oy = (a[:1, :32, :32] for a in j[:3])
    want = jdetect._select_keypoints(
        jnp.asarray(nms[0]), jnp.asarray(ox[0]), jnp.asarray(oy[0]), 20, 1e-4, 8
    )
    got = tdetect._select_keypoints(
        *(torch.as_tensor(np.ascontiguousarray(a)) for a in (nms, ox, oy)), 20, 1e-4, 8
    )
    np.testing.assert_array_equal(np.asarray(want.valid), got.valid[0].numpy())
    np.testing.assert_array_equal(np.asarray(want.xy), got.xy[0].numpy())


def test_detect_keypoints_batch_matches_pallas_route(fields):
    """The whole batched detector (K1 plain + selection) against the
    reference's Pallas route in interpret mode."""
    fr, _, _ = fields
    want, wsm = jdetect.detect_keypoints_batch(
        jnp.asarray(fr), max_keypoints=48, threshold=1e-4, use_pallas=True,
        smooth_sigma=2.0, interpret=True,
    )
    got, tsm = tdetect.detect_keypoints_batch(
        torch.as_tensor(fr), max_keypoints=48, threshold=1e-4, smooth_sigma=2.0
    )
    np.testing.assert_array_equal(np.asarray(want.valid), got.valid.numpy())
    np.testing.assert_allclose(np.asarray(want.xy), got.xy.numpy(), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(wsm) - tsm.numpy()).max() <= 1e-5


def test_detect_keypoints_single_frame_matches_jnp():
    fr = _frames(n=1, seed=3)[0]
    want = jdetect.detect_keypoints(jnp.asarray(fr), max_keypoints=40, threshold=1e-4)
    got = tdetect.detect_keypoints(torch.as_tensor(fr), max_keypoints=40, threshold=1e-4)
    np.testing.assert_array_equal(np.asarray(want.valid), got.valid.numpy())
    np.testing.assert_allclose(np.asarray(want.xy), got.xy.numpy(), rtol=0, atol=1e-5)


def test_sorted_top_k_stable_ties():
    vals = np.array([3.0, 1.0, 3.0, -np.inf, 2.0, 3.0, 2.0], np.float32)
    wv, wi = jdetect.sorted_top_k(jnp.asarray(vals), 5)
    tv, ti = tdetect.sorted_top_k(torch.as_tensor(vals), 5)
    np.testing.assert_array_equal(np.asarray(wv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(wi), ti.numpy())


def test_batch_detector_rejects_zero_border():
    with pytest.raises(ValueError, match="border"):
        tdetect.detect_keypoints_batch(torch.zeros((1, 32, 32)), border=0)
