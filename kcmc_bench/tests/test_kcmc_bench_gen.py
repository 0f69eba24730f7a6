"""The frozen generator, error arithmetic and constants give the port's
own results on tiny inputs (CPU)."""

import numpy as np
import pytest

from kcmc_bench import gen
from kcmc_bench.reference import errors, patterns
from kcmc_tpu_torch.ops import patterns as port_patterns
from kcmc_tpu_torch.utils import metrics as port_metrics
from kcmc_tpu_torch.utils import synthetic as port


@pytest.mark.parametrize("model", ["translation", "rigid", "similarity", "affine", "homography"])
def test_drift_stack_matches_the_port(model):
    kw = dict(n_frames=4, shape=(48, 40), model=model, seed=3, n_blobs=60, max_drift=5.0)
    a, b = gen.make_drift_stack(**kw), port.make_drift_stack(**kw)
    assert a.stack.tobytes() == b.stack.tobytes()
    assert a.transforms.tobytes() == b.transforms.tobytes()


def test_drift_stack_sharp_scene_matches_the_port():
    kw = dict(n_frames=3, shape=(40, 40), model="affine", seed=9, n_blobs=300,
              sigma_range=(0.7, 1.4))
    assert gen.make_drift_stack(**kw).stack.tobytes() == port.make_drift_stack(**kw).stack.tobytes()


def test_piecewise_stack_matches_the_port():
    kw = dict(n_frames=3, shape=(48, 48), grid=(4, 4), seed=5)
    a, b = gen.make_piecewise_stack(**kw), port.make_piecewise_stack(**kw)
    assert a.stack.tobytes() == b.stack.tobytes()
    assert a.fields.tobytes() == b.fields.tobytes()
    f = np.random.default_rng(0).normal(size=(5, 6, 2)).astype(np.float32)
    assert gen.upsample_field(f, (30, 41)).tobytes() == port.upsample_field(f, (30, 41)).tobytes()


def test_streams_split_scene_motion_and_noise():
    scene = {"generator": "drift", "model": "affine", "max_drift": 4.0,
             "blobs_per_px": 0.02, "sigma_range": [0.7, 1.4]}
    traffic = {"shape": [40, 40], "distinct": 4, "frames": 10, "scene_seed": 1, "motion_seed": 2}
    a, ta = gen.recording(scene, traffic, 2**31 + 11)
    b, tb = gen.recording(scene, traffic, 2**31 + 11)
    c, tc = gen.recording(scene, traffic, 5)
    assert a.shape == (10, 40, 40) and a.dtype == np.float32
    assert np.array_equal(a, b) and np.array_equal(a[4:8], a[:4])  # tiled
    assert not np.array_equal(a, c)  # another seed: other noise
    assert np.array_equal(ta.transforms, tc.transforms)  # the same motion
    assert np.array_equal(ta.reference, tc.reference)  # the same scene
    assert np.abs(a - c).max() < 0.1  # noise of 0.01


def test_errors_match_the_port():
    rng = np.random.default_rng(1)
    A = np.tile(np.eye(3, dtype=np.float32), (5, 1, 1))
    A[:, :2, :] += rng.normal(0, 0.01, (5, 2, 3)).astype(np.float32)
    B = port_metrics.relative_transforms(A)
    assert errors.transform_rmse(A, B, (64, 48)) == port_metrics.transform_rmse(A, B, (64, 48))
    f, g = rng.normal(size=(2, 3, 8, 8, 2))
    assert errors.field_rmse(f, g) == port_metrics.field_rmse(f, g)
    assert np.array_equal(errors.relative_transforms(A), B)
    gaps = errors.frame_transform_gap(A, B, (64, 48))
    assert gaps.shape == (5,) and np.isclose(np.sqrt(np.mean(gaps ** 2)),
                                             errors.transform_rmse(A, B, (64, 48)))


def test_patterns_match_the_port():
    for name in ("N_BITS", "PATCH_RADIUS", "MOMENT_RADIUS", "N_ORIENT_BINS", "ROT_RADIUS",
                 "CAND_TILE", "WINDOW_SIGMA"):
        assert getattr(patterns, name) == getattr(port_patterns, name)
    for name in ("PATTERN", "ROT_PATTERNS", "MOMENTS", "PATTERN_3D"):
        assert np.array_equal(getattr(patterns, name), getattr(port_patterns, name))
