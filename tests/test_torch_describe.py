"""Description in the PyTorch port against kcmc_tpu: the copied pattern
constants, K2's plain version against the Pallas extraction kernel and
its banded and slab layouts (interpret mode, bit-identical), and the
descriptor words against both reference describe routes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kcmc_tpu.ops import describe as jdescribe
from kcmc_tpu.ops import pallas_patch as pp
from kcmc_tpu.ops import patterns as jpatterns
from kcmc_tpu.ops.detect import Keypoints as JKeypoints
from kcmc_tpu.ops.detect import detect_keypoints_batch as j_detect_batch
from kcmc_tpu.utils.synthetic import render_scene
from kcmc_tpu_torch.ops import describe as tdescribe
from kcmc_tpu_torch.ops import patterns as tpatterns
from kcmc_tpu_torch.ops.cuda_patch import extract_blended, extract_blended_plain
from kcmc_tpu_torch.ops.detect import Keypoints as TKeypoints

P = 28


@pytest.mark.parametrize(
    "name", ["PATTERN", "N_BITS", "N_WORDS", "PATCH_RADIUS", "CAND_TILE", "WINDOW_SIGMA"]
)
def test_pattern_constants_equal(name):
    np.testing.assert_array_equal(getattr(jpatterns, name), getattr(tpatterns, name))


def test_selection_index_matches_onehot_matrix():
    sel = jdescribe._SEL_UPRIGHT  # (729, 512) one-hot
    np.testing.assert_array_equal(np.argmax(sel, axis=0), tdescribe._SEL_UPRIGHT)
    assert (sel.sum(axis=0) == 1).all()


def _padded_case(shape=(72, 88), K=24, B=2, seed=0):
    rng = np.random.default_rng(seed)
    fr = np.stack([render_scene(rng, shape, n_blobs=40) for _ in range(B)])
    fr = (fr - fr.mean()).astype(np.float32)
    r1 = P // 2
    pad = np.pad(fr, ((0, 0), (r1, r1), (r1, r1)), mode="edge")
    H, W = shape
    xy = np.stack(
        [rng.uniform(16, W - 16, (B, K)), rng.uniform(16, H - 16, (B, K))], -1
    ).astype(np.float32)
    xy[0, :3] = [[16.0, 16.0], [W - 16.5, 30.25], [40.0, H - 16.75]]  # integer / edge
    pad_bf = jnp.asarray(pad, jnp.bfloat16)
    return pad_bf, xy, torch.as_tensor(np.array(pad_bf.astype(jnp.float32))).to(torch.bfloat16)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def test_k2_plain_matches_pallas_resident():
    pad_j, xy, pad_t = _padded_case()
    want = pp.extract_blended(
        pad_j, jnp.asarray(xy), P, out_dtype=jnp.bfloat16, interpret=True
    )
    got = extract_blended_plain(pad_t, torch.as_tensor(xy), P)
    np.testing.assert_array_equal(_bits(want), _bits(got))
    # the wrapper's CPU route is the plain version
    np.testing.assert_array_equal(
        _bits(extract_blended(pad_t, torch.as_tensor(xy), P)), _bits(got)
    )


def _planes(xy):
    oy = jnp.asarray(np.floor(xy[..., 1]).astype(np.int32) + 1)
    ox = jnp.asarray(np.floor(xy[..., 0]).astype(np.int32) + 1)
    fx = jnp.asarray((xy[..., 0] - np.floor(xy[..., 0]))[..., None].astype(np.float32))
    fy = jnp.asarray((xy[..., 1] - np.floor(xy[..., 1]))[..., None].astype(np.float32))
    return oy, ox, fx, fy


@pytest.mark.parametrize("layout", ["banded", "slab"])
def test_k2_plain_matches_pallas_large_frame_layouts(layout):
    """The TPU's large-frame layouts of the same op, called directly at
    a small size: K2 has no size gate, so it must equal both."""
    pad_j, xy, pad_t = _padded_case(seed=1)
    oy, ox, fx, fy = _planes(xy)
    if layout == "banded":
        want = pp._extract_blended_planes_banded(
            pad_j, oy, ox, fx, fy, P, NB=2, interpret=True, out_dtype=jnp.bfloat16
        )
    else:
        want = pp._extract_blended_planes_slab(
            pad_j.astype(jnp.float32), oy, ox, fx, fy, P, with_moments=False,
            interpret=True, out_dtype=jnp.bfloat16,
        )
    got = extract_blended_plain(pad_t, torch.as_tensor(xy), P)
    np.testing.assert_array_equal(_bits(want), _bits(got))


def test_pack_bits_matches_reference():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (5, 256)).astype(bool)
    want = np.asarray(jdescribe._pack_bits(jnp.asarray(bits)))
    got = tdescribe._pack_bits(torch.as_tensor(bits)).numpy()
    np.testing.assert_array_equal(want.astype(np.int64), got)


@pytest.fixture(scope="module")
def scene_batch():
    rng = np.random.default_rng(3)
    fr = np.stack([render_scene(rng, (96, 96), n_blobs=60) for _ in range(2)])
    fr = (fr * 300.0 + 500.0).astype(np.float32)  # a DC offset the mean must absorb
    kps, smooth = j_detect_batch(
        jnp.asarray(fr), max_keypoints=64, threshold=1e-4, use_pallas=True,
        smooth_sigma=2.0, interpret=True,
    )
    return fr, kps, np.array(smooth)


def _tk(kps) -> TKeypoints:
    return TKeypoints(*(torch.as_tensor(np.array(a)) for a in kps))


def test_descriptors_match_pallas_batch_route(scene_batch):
    """Same frames, keypoints and blur into both batched routes (the
    reference's Pallas extraction in interpret mode): identical words."""
    fr, kps, smooth = scene_batch
    want = jdescribe.describe_keypoints_batch(
        jnp.asarray(fr), kps, oriented=False, use_pallas=True, interpret=True,
        smooth=jnp.asarray(smooth),
    )
    got = tdescribe.describe_keypoints_batch(
        torch.as_tensor(fr), _tk(kps), smooth=torch.as_tensor(smooth)
    )
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64), got.numpy())
    assert (got.numpy()[np.asarray(kps.valid)] != 0).any(axis=-1).all()
    assert (got.numpy()[~np.asarray(kps.valid)] == 0).all()


def test_descriptors_match_single_frame_gather_route(scene_batch):
    """Against the reference's single-frame XLA gather route (the one
    its reference preparation runs on the CPU): identical words."""
    fr, kps, smooth = scene_batch
    for b in range(fr.shape[0]):
        kb = JKeypoints(*(a[b] for a in kps))
        want = jdescribe.describe_keypoints(
            jnp.asarray(fr[b]), kb, oriented=False, smooth=jnp.asarray(smooth[b])
        )
        got = tdescribe.describe_keypoints(
            torch.as_tensor(fr[b]), TKeypoints(*(torch.as_tensor(np.array(a)) for a in kb)),
            smooth=torch.as_tensor(smooth[b]),
        )
        np.testing.assert_array_equal(np.asarray(want).astype(np.int64), got.numpy())
