"""Warping and the photometric polish in the PyTorch port against
kcmc_tpu: K3's plain version against the Pallas translation kernel and
its row-strip variant (interpret mode) and the gather warp, including a
shift beyond the +-PAD window, and polish_transforms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kcmc_tpu.ops import polish as jpolish
from kcmc_tpu.ops import warp as jwarp
from kcmc_tpu.ops.pallas_warp import (
    warp_batch_translation,
    warp_batch_translation_strips,
)
from kcmc_tpu.utils.synthetic import render_scene
from kcmc_tpu_torch.ops import polish as tpolish
from kcmc_tpu_torch.ops import warp as twarp
from kcmc_tpu_torch.ops.cuda_warp import warp_translation, warp_translation_plain


def _scene(shape=(72, 88), seed=0):
    return render_scene(np.random.default_rng(seed), shape, n_blobs=40).astype(np.float32)


def _translations(shifts):
    M = np.tile(np.eye(3, dtype=np.float32), (len(shifts), 1, 1))
    M[:, 0, 2] = [s[0] for s in shifts]
    M[:, 1, 2] = [s[1] for s in shifts]
    return M


# (tx, ty): fractional, negative, the exact-window edges, beyond +-PAD
SHIFTS = [(3.25, -1.5), (-7.75, 10.125), (140.3, 2.0), (0.0, -129.0),
          (-128.0, 127.5), (127.9, -0.01)]


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(1)
    fr = np.stack([_scene(seed=s) for s in range(len(SHIFTS))])
    fr = fr + rng.normal(0, 0.01, fr.shape).astype(np.float32)
    return fr, _translations(SHIFTS)


def test_k3_plain_matches_pallas_interpret(case):
    """Tolerance 1e-5 of max|frame|: the reference's CPU evaluation
    contracts the four-tap sum into FMAs, the port rounds each product."""
    fr, M = case
    want, wok = warp_batch_translation(
        jnp.asarray(fr), jnp.asarray(M), interpret=True, with_ok=True
    )
    got, ok = warp_translation(torch.as_tensor(fr), torch.as_tensor(M))
    np.testing.assert_array_equal(np.asarray(wok), ok.numpy())
    np.testing.assert_array_equal(ok.numpy(), [True, True, False, False, True, True])
    assert np.abs(np.asarray(want) - got.numpy()).max() <= 1e-5 * np.abs(fr).max()
    assert not got.numpy()[~ok.numpy()].any()  # flagged frames are zeroed


def test_k3_plain_matches_pallas_strips(case):
    fr, M = case
    want, wok = warp_batch_translation_strips(
        jnp.asarray(fr), jnp.asarray(M), interpret=True, with_ok=True, strip_rows=16
    )
    got, ok = warp_translation_plain(torch.as_tensor(fr), torch.as_tensor(M))
    np.testing.assert_array_equal(np.asarray(wok), ok.numpy())
    assert np.abs(np.asarray(want) - got.numpy()).max() <= 1e-5 * np.abs(fr).max()


def test_k3_matches_gather_warp_inside_window(case):
    """Frames within the exact window: K3 equals the gather warp (the
    rescue path and the reference's CPU warp) up to float rounding."""
    fr, M = case
    got, ok = warp_translation(torch.as_tensor(fr), torch.as_tensor(M))
    want = np.asarray(jwarp.warp_batch(jnp.asarray(fr), jnp.asarray(M)))
    mine = twarp.warp_batch(torch.as_tensor(fr), torch.as_tensor(M)).numpy()
    k = ok.numpy()
    assert np.abs(want[k] - got.numpy()[k]).max() <= 1e-5 * np.abs(fr).max()
    assert np.abs(want - mine).max() <= 1e-6 * np.abs(fr).max()


def test_gather_warp_general_matrix_and_coverage():
    fr = _scene()[None]
    th = 0.05
    M = np.array([[[np.cos(th), -np.sin(th), 4.2], [np.sin(th), np.cos(th), -3.1],
                   [1e-5, -2e-5, 1.0]]], np.float32)
    want = np.asarray(jwarp.warp_batch(jnp.asarray(fr), jnp.asarray(M)))
    got = twarp.warp_batch(torch.as_tensor(fr), torch.as_tensor(M)).numpy()
    assert np.abs(want - got).max() <= 1e-5
    cw = np.asarray(jwarp.coverage_mask(fr.shape[1:], jnp.asarray(M[0])))
    ct = twarp.coverage_mask(fr.shape[1:], torch.as_tensor(M))[0].numpy()
    np.testing.assert_array_equal(cw, ct)
    ok = twarp.warp_batch_with_ok(torch.as_tensor(fr), torch.as_tensor(M))[1]
    assert ok.numpy().all()


@pytest.fixture(scope="module")
def polish_case():
    """A template and frames warped by known sub-pixel residual shifts."""
    tmpl = _scene((128, 128), seed=4)
    res = [(0.3, -0.2), (-0.45, 0.1), (0.05, 0.6), (0.0, 0.0)]
    M_res = _translations(res)
    frames = np.array(jwarp.warp_batch(
        jnp.asarray(np.repeat(tmpl[None], len(res), 0)), jnp.asarray(M_res)
    ))
    base = _translations([(5.0, -3.0), (0.5, 0.25), (-2.0, 1.0), (0.0, 0.0)])
    return frames, tmpl, base


def test_measure_shifts_matches(polish_case):
    frames, tmpl, _ = polish_case
    wd, ws = jpolish.measure_shifts(jnp.asarray(frames), jnp.asarray(tmpl), (4, 4))
    td, ts = tpolish.measure_shifts(torch.as_tensor(frames), torch.as_tensor(tmpl), (4, 4))
    np.testing.assert_array_equal(np.asarray(ws), ts.numpy())
    np.testing.assert_allclose(np.asarray(wd), td.numpy(), rtol=0, atol=1e-5)


def test_polish_transforms_matches(polish_case):
    """polish_transforms to within 1e-4 px of the reference."""
    frames, tmpl, base = polish_case
    want = np.asarray(jpolish.polish_transforms(
        jnp.asarray(frames), jnp.asarray(tmpl), jnp.asarray(base), "translation"
    ))
    got = tpolish.polish_transforms(
        torch.as_tensor(frames), torch.as_tensor(tmpl), torch.as_tensor(base), "translation"
    ).numpy()
    assert np.abs(want - got).max() <= 1e-4
    assert np.abs(got - base).max() > 0.01  # the polish moved something


def test_region_helpers_match():
    x = np.arange(2 * 70 * 90, dtype=np.float32).reshape(2, 70, 90)
    np.testing.assert_array_equal(
        np.asarray(jpolish.region_patches(jnp.asarray(x), (4, 3))),
        tpolish.region_patches(torch.as_tensor(x), (4, 3)).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jpolish.region_centers((4, 3), (70, 90))),
        tpolish.region_centers((4, 3), (70, 90)).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jpolish.region_window(17, 22, 0.25)),
        tpolish.region_window(17, 22, 0.25).numpy(),
    )
    cov = (x > 3000).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jpolish._windowed_mean(jnp.asarray(cov), (4, 3), 0.25)),
        tpolish._windowed_mean(torch.as_tensor(cov), (4, 3), 0.25).numpy(),
        rtol=0, atol=1e-6,
    )
    assert jax.devices()[0].platform == "cpu"
