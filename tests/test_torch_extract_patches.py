"""K11 (the raw integer-origin patch cut) of the PyTorch port against
kcmc_tpu's `pallas_patch.extract_patches` in interpret mode, and K1's
plain version against the column-paneled variant of the reference's
detection kernel (`response_fields_paneled`, the route the reference
takes for frames wider than 2032 px)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kcmc_tpu.ops.pallas_patch as pp
from kcmc_tpu.ops import detect as jdetect
from kcmc_tpu.ops.pallas_detect import _reach, response_fields_paneled
from kcmc_tpu.utils.synthetic import render_scene
from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.ops import detect as tdetect
from kcmc_tpu_torch.ops.cuda_detect import detect_response_plain
from kcmc_tpu_torch.ops.cuda_patch import extract_patches, extract_patches_plain


@pytest.fixture(scope="module")
def data():
    """The reference suite's K11 case (tests/test_pallas_patch.py)."""
    rng = np.random.default_rng(11)
    B, H, W, K, PAD = 3, 96, 96, 40, 16
    padded = rng.random((B, H + 2 * PAD, W + 2 * PAD), dtype=np.float32)
    oy = rng.integers(0, H, size=(B, K)).astype(np.int32)
    ox = rng.integers(0, W, size=(B, K)).astype(np.int32)
    return padded, oy, ox


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _reference(padded, oy, ox, P):
    return np.asarray(pp.extract_patches(
        jnp.asarray(padded), jnp.asarray(oy), jnp.asarray(ox), P, interpret=True
    ))


@pytest.mark.parametrize("P", [16, 28])
def test_k11_plain_matches_pallas_interpret(data, P):
    padded, oy, ox = data
    want = _reference(padded, oy, ox, P)
    got = extract_patches_plain(*_t(padded, oy, ox), P).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (3, 40, P, P)
    np.testing.assert_array_equal(got, want)


def test_k11_odd_k_against_the_reference_padding(data):
    """K = 13, not a multiple of the TPU kernel's block of 8."""
    padded, oy, ox = data
    want = _reference(padded, oy[:, :13], ox[:, :13], 28)
    got = extract_patches_plain(*_t(padded, oy[:, :13], ox[:, :13]), 28).numpy()
    np.testing.assert_array_equal(got, want)


def test_k11_matches_chunked_reference_batch(data, monkeypatch):
    """The reference split into one frame per call (its SMEM budget
    shrunk, as its own test does) gives the same patches as the port's
    one call."""
    padded, oy, ox = data
    monkeypatch.setattr(pp, "_SMEM_SCALAR_BUDGET", 8)
    assert pp._smem_batch_limit(2, oy.shape[1], pp._KB) == 1
    jax.clear_caches()
    try:
        want = _reference(padded, oy, ox, 16)
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    np.testing.assert_array_equal(extract_patches_plain(*_t(padded, oy, ox), 16).numpy(), want)


def test_k11_wrapper_cpu_route_and_clamp(data):
    """The wrapper takes the plain version on the CPU without counting a
    launch; origins outside the contract clamp into the frame; bad
    arguments raise."""
    padded, oy, ox = data
    cuda_build.reset_launches()
    got = extract_patches(*_t(padded, oy, ox), 28)
    assert cuda_build.launch_counts()["extract_patches"] == 0
    np.testing.assert_array_equal(got.numpy(), _reference(padded, oy, ox, 28))
    far = np.full_like(oy, 10_000)
    out = extract_patches(*_t(padded, far, -far), 8).numpy()
    np.testing.assert_array_equal(out[0, 0], padded[0, -8:, :8])
    with pytest.raises(TypeError):
        extract_patches(*_t(padded, oy.astype(np.int64), ox), 8)
    with pytest.raises(ValueError):
        extract_patches(*_t(padded, oy, ox[:, :5]), 8)
    with pytest.raises(ValueError):
        extract_patches(*_t(padded, oy, ox), 200)


# ---------------------------------------------------------------------------
# K1 against the reference's paneled wide-frame route


@pytest.fixture(scope="module")
def wide():
    """Two 64 x 300 frames; max_panel_w=160 gives 128-px panel cores, so
    the reference stitches three panels (the smallest panel width whose
    core is not empty: 128 leaves none)."""
    rng = np.random.default_rng(5)
    fr = np.stack([render_scene(rng, (64, 300), n_blobs=80) for _ in range(2)])
    fr = fr.astype(np.float32)
    paneled = [np.array(a) for a in response_fields_paneled(
        jnp.asarray(fr), smooth_sigma=2.0, max_panel_w=160, interpret=True
    )]
    plain = [a.numpy() for a in detect_response_plain(torch.as_tensor(fr), smooth_sigma=2.0)]
    return fr, paneled, plain


def test_k1_plain_matches_paneled_pallas(wide, record_property):
    """Outside `_reach` columns of the true edges (and rows, as for the
    whole-frame kernel) the NMS pattern is identical, the response within
    1e-5 of max|resp| and the subpixel fields within 1e-5 px at the NMS
    maxima; the blur within 1e-5 of max|frame| everywhere."""
    fr, j, t = wide
    r = _reach(5, 1.5, 2.0)
    band = (slice(None), slice(r, -r), slice(r, -r))
    jn, tn = j[0][band], t[0][band]
    np.testing.assert_array_equal(np.isfinite(jn), np.isfinite(tn))
    fin = np.isfinite(jn)
    gap = np.abs(jn[fin] - tn[fin]).max() / np.abs(jn[fin]).max()
    record_property("response_gap_rel", float(gap))
    assert gap <= 1e-5
    for a, c in zip(j[1:3], t[1:3]):
        assert np.abs(a[band][fin] - c[band][fin]).max() <= 1e-5
    assert np.abs(j[3] - t[3]).max() <= 1e-5 * np.abs(fr).max()


@pytest.mark.parametrize("border", [16, 10])
def test_k1_keypoints_match_paneled_route(wide, border, record_property):
    """With border >= reach (10) the keypoints the port selects from
    K1's fields are those the reference selects from the paneled
    fields: identical validity and positions within 1e-4 px (they differ
    by one float32 ulp at most, from subpixel offsets ~1e-7 apart)."""
    fr, j, _ = wide
    assert border >= _reach(5, 1.5, 2.0)
    want = jax.vmap(lambda a, b, c: jdetect._select_keypoints(
        a, b, c, 96, 1e-4, border))(*(jnp.asarray(a) for a in j[:3]))
    got, _ = tdetect.detect_keypoints_batch(
        torch.as_tensor(fr), max_keypoints=96, threshold=1e-4, border=border,
        smooth_sigma=2.0,
    )
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(valid, got.valid.numpy())
    assert valid.sum() > 60
    gap = np.abs(np.asarray(want.xy) - got.xy.numpy())[valid].max()
    record_property("xy_gap_px", float(gap))
    assert gap <= 1e-4
