"""The translation slice of the PyTorch port end to end, against
kcmc_tpu's JAX backend, plus the port's package rules: no jax and no
kcmc_tpu import, no silent device fallback, unported knobs raise."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu.utils import metrics as jmetrics
from kcmc_tpu.utils import synthetic as jsynthetic
from kcmc_tpu_torch.backends.torch_backend import TorchBackend
from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.utils import metrics as tmetrics
from kcmc_tpu_torch.utils import synthetic as tsynthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def drift():
    return jsynthetic.make_drift_stack(16, (128, 128), seed=0)


@pytest.fixture(scope="module")
def jax_corrector():
    return kcmc_tpu.MotionCorrector(model="translation", backend="jax")


@pytest.fixture(scope="module")
def runs(drift, jax_corrector):
    want = jax_corrector.correct(drift.stack)
    got = kcmc_tpu_torch.MotionCorrector(model="translation", device="cpu").correct(
        drift.stack
    )
    return want, got


def test_slice_matches_jax_backend(runs, drift):
    """Transforms within 1e-3 px of backend="jax", inliers within +-2."""
    want, got = runs
    assert got.transforms.shape == want.transforms.shape == (16, 3, 3)
    assert np.abs(want.transforms - got.transforms).max() <= 1e-3
    dn = np.abs(want.diagnostics["n_inliers"].astype(int) - got.diagnostics["n_inliers"])
    assert dn.max() <= 2
    gt = jmetrics.relative_transforms(drift.transforms)
    assert jmetrics.transform_rmse(got.transforms, gt, (128, 128)) < 0.05
    assert np.abs(want.corrected - got.corrected).max() <= 1e-3 * np.abs(drift.stack).max()
    for k in ("n_keypoints", "n_matches"):
        np.testing.assert_array_equal(want.diagnostics[k], got.diagnostics[k], err_msg=k)
    assert got.diagnostics["warp_ok"].all() and not got.diagnostics["warp_rescued"].any()
    assert set(got.diagnostics) >= {
        "n_keypoints", "n_matches", "n_inliers", "rms_residual", "warp_ok", "warp_rescued",
    }


def test_batch_program_on_jax_prepared_reference(drift, jax_corrector):
    """The reference carried across: kcmc_tpu prepares it, the port's
    batch program registers a batch against it."""
    jb = jax_corrector.backend
    jref = jb.prepare_reference(drift.stack[0])
    idx = np.arange(32) % 16
    batch = drift.stack[idx]
    want = jb.process_batch(batch, jref, idx)
    tb = TorchBackend(kcmc_tpu_torch.config_from_dict(
        dataclasses.asdict(jax_corrector.config)), device="cpu")
    tref = tb.reference_from_numpy({k: np.asarray(jref[k]) for k in ("xy", "desc", "valid", "frame")})
    got = tb.process_batch(batch, tref, idx)
    assert np.abs(want["transform"] - got["transform"]).max() <= 1e-3
    assert np.abs(want["n_inliers"].astype(int) - got["n_inliers"]).max() <= 2


def test_output_dtype_and_reference_selectors(drift):
    stack = (drift.stack[:4] * 1000).astype(np.uint16)
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", reference="mean", batch_size=4)
    res = mc.correct(stack, output_dtype="input")
    assert res.corrected.dtype == np.uint16 and res.corrected.shape == stack.shape
    with pytest.raises(ValueError, match="reference"):
        kcmc_tpu_torch.MotionCorrector(device="cpu", reference=99).correct(stack)


def test_rescue_of_frame_beyond_warp_window():
    """A frame shifted beyond +-PAD: K3 flags it, the corrector re-warps
    it through the exact gather path and records warp_rescued."""
    rng = np.random.default_rng(2)
    scene = tsynthetic.render_scene(rng, (320, 320), n_blobs=300)
    M = np.eye(3, dtype=np.float32)
    M[:2, 2] = (140.25, 3.5)
    stack = np.stack([scene, tsynthetic._warp_scene(scene, M)]).astype(np.float32)
    res = kcmc_tpu_torch.MotionCorrector(device="cpu", batch_size=2).correct(stack)
    np.testing.assert_array_equal(res.diagnostics["warp_rescued"], [False, True])
    assert np.abs(res.transforms[1, :2, 2] - M[:2, 2]).max() < 0.1
    assert res.corrected[1].any()


def test_synthetic_and_metrics_copies_match():
    a = jsynthetic.make_drift_stack(3, (64, 64), seed=5)
    b = tsynthetic.make_drift_stack(3, (64, 64), seed=5)
    np.testing.assert_array_equal(a.stack, b.stack)
    np.testing.assert_array_equal(a.transforms, b.transforms)
    est = a.transforms + np.float32(0.01)
    assert jmetrics.transform_rmse(est, a.transforms, (64, 64)) == tmetrics.transform_rmse(
        est, b.transforms, (64, 64)
    )
    np.testing.assert_array_equal(
        jmetrics.relative_transforms(a.transforms, 1),
        tmetrics.relative_transforms(b.transforms, 1),
    )
    a3 = jsynthetic.make_drift_stack_3d(3, (8, 32, 32), seed=4)
    b3 = tsynthetic.make_drift_stack_3d(3, (8, 32, 32), seed=4)
    np.testing.assert_array_equal(a3.stack, b3.stack)
    np.testing.assert_array_equal(a3.transforms, b3.transforms)
    np.testing.assert_array_equal(a3.reference, b3.reference)
    est3 = a3.transforms + np.float32(0.01)
    assert jmetrics.transform_rmse(est3, a3.transforms, (8, 32, 32)) == tmetrics.transform_rmse(
        est3, b3.transforms, (8, 32, 32)
    )


def test_config_carries_across():
    jcfg = kcmc_tpu.CorrectorConfig(max_keypoints=256, ratio=0.8, seed=3)
    cfg = kcmc_tpu_torch.config_from_dict(dataclasses.asdict(jcfg))
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.resolved_oriented() is False
    assert cfg.resolved_match_precision(False) == jcfg.resolved_match_precision(False)


@pytest.mark.parametrize(
    "kw",
    [{"plan_buckets": ((128, 128),)}, {"mesh_devices": 2}, {"mesh": object()}],
)
def test_unported_knobs_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kcmc_tpu_torch.MotionCorrector(device="cpu", **kw)


@pytest.mark.parametrize(
    "kw",
    [
        {"warm_start": True}, {"sanitize_input": True},
        {"model": "affine", "warm_start": True},
        {"model": "similarity", "n_octaves": 2, "quality_metrics": True},
        {"quality_metrics": True}, {"model": "rigid3d", "warm_start": True},
        {"model": "piecewise", "sanitize_input": True}, {"match_precision": "float32"},
        {"template_iters": 1}, {"template_update_every": 8},
        {"model": "homography", "template_iters": 1},
    ],
)
def test_ported_knobs_accepted(kw):
    """The options of correct() ported with queue 1 item 15a: accepted,
    with nothing left unsupported."""
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", **kw)
    assert mc.config.unsupported() == []


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_default_device_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kcmc_tpu_torch.MotionCorrector()


def test_cpu_route_never_counts_launches(drift):
    cuda_build.reset_launches()
    kcmc_tpu_torch.MotionCorrector(device="cpu", batch_size=4).correct(drift.stack[:4])
    assert set(cuda_build.launch_counts().values()) == {0}
    assert len(cuda_build.launch_counts()) == 11


def test_port_imports_neither_jax_nor_kcmc_tpu():
    """Every module of the port imports with jax and kcmc_tpu blocked."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["kcmc_tpu"] = None
        import kcmc_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            kcmc_tpu_torch.__path__, "kcmc_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        bad = [m for m in sys.modules if m.startswith(("jax", "kcmc_tpu."))
               and sys.modules[m] is not None]
        assert not bad, bad
        print(" ".join(names))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": REPO}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 28
    for mod in ("ops.piecewise", "ops.cuda_warp_field", "ops.cuda_patch", "ops.dispatch",
                "ops.detect3d", "ops.describe3d", "ops.cuda_detect3d", "ops.cuda_patch3d",
                "ops.pyramid", "ops.warp_separable", "ops.match_banded", "ops.warp_field",
                "utils.trajectory", "corrector", "ops.warp", "io", "io.tiff",
                "io.formats", "io.feeder", "io.reader", "io.async_writer",
                "utils.checkpoint", "utils.faults", "utils.dtypes", "obs.log"):
        assert "kcmc_tpu_torch." + mod in names
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert "import jax" not in src and "from kcmc_tpu " not in src
    assert "from kcmc_tpu." not in src and "import kcmc_tpu\n" not in src


def test_decode_worker_imports_only_the_io_package(tmp_path):
    """The decode pool's worker entry point (`feeder._decode_span`, what
    a spawned worker runs) decodes with torch, jax and kcmc_tpu blocked:
    the lazy package init keeps a worker's imports to
    `kcmc_tpu_torch.io` and numpy. A real process pool then decodes the
    same pages."""
    path = str(tmp_path / "s.tif")
    frames = (np.arange(6 * 24 * 20) % 997).astype(np.uint16).reshape(6, 24, 20)
    from kcmc_tpu_torch.io import feeder, write_stack

    write_stack(path, frames, compression="deflate")
    code = textwrap.dedent(
        f"""
        import sys
        for m in ("torch", "jax", "kcmc_tpu"):
            sys.modules[m] = None
        import numpy as np
        from kcmc_tpu_torch.io import feeder
        got = feeder._decode_span(("stack", {path!r}, (("force_python", True),)), 1, 5)
        assert got.shape == (4, 24, 20), got.shape
        bad = [m for m in sys.modules if m.startswith(("torch", "jax", "kcmc_tpu."))
               and sys.modules[m] is not None]
        assert not bad, bad
        print(int(got.sum()))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": REPO}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == int(frames[1:5].sum())
    pool = feeder.DecodePool(1, kind="process")
    try:
        got = pool.submit(("stack", path, (("force_python", True),)), 2, 6).result(timeout=120)
    finally:
        pool.shutdown()
    np.testing.assert_array_equal(got, frames[2:6])
