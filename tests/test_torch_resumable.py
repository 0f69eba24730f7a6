"""The port's `ResumableCorrector` (kcmc_tpu_torch/utils/checkpoint.py)
against kcmc_tpu's: the four cases of the reference's
tests/test_checkpoint.py, each over a `backend="numpy"` corrector in
both packages, plus a rigid3d case and the cross-package restart.

Transforms and the checkpoint's arrays are equal to the reference's by
bytes (the same NumPy oracle, the same chunks); the corrected frames are
re-warped by each package's own gather warp on the CPU (the port's
torch gather, the reference's jax one), equal within WARP_TOL of the
frame's range: both sample in float32, in a different order of the
bilinear terms."""

import json
import os

import numpy as np
import pytest

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu.utils.checkpoint import ResumableCorrector as JaxPackageResumable
from kcmc_tpu_torch.utils.checkpoint import ResumableCorrector
from kcmc_tpu_torch.utils.synthetic import make_drift_stack, make_drift_stack_3d

WARP_TOL = 1e-5  # of max|frame|: two float32 bilinear gathers
KW = dict(model="translation", backend="numpy", batch_size=4, max_keypoints=128)


@pytest.fixture(scope="module")
def data():
    return make_drift_stack(n_frames=10, shape=(64, 64), model="translation", max_drift=6.0,
                            seed=41)


def _checkpoint(path):
    with np.load(path) as z:
        return json.loads(str(z["meta"])), {k: z[k] for k in z.files if k != "meta"}


def _close(got, want):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape and got.dtype == np.float32
    assert float(np.abs(got - np.asarray(want)).max()) <= WARP_TOL * scale


def test_resume_matches_the_references(tmp_path, data):
    """Chunked + checkpointed runs of both packages: transforms and every
    checkpoint array equal by bytes, the meta keys equal, the frames
    within WARP_TOL; and the port's equals its own one-shot run."""
    want = JaxPackageResumable(kcmc_tpu.MotionCorrector(**KW), str(tmp_path / "j.npz"),
                               chunk_frames=4).correct(data.stack)
    got = ResumableCorrector(kcmc_tpu_torch.MotionCorrector(**KW), str(tmp_path / "t.npz"),
                             chunk_frames=4).correct(data.stack)
    assert got.transforms.tobytes() == want.transforms.tobytes()
    _close(got.corrected, want.corrected)
    for k, v in want.diagnostics.items():
        assert got.diagnostics[k].tobytes() == v.tobytes(), k
    (jmeta, jarr), (tmeta, tarr) = _checkpoint(tmp_path / "j.npz"), _checkpoint(tmp_path / "t.npz")
    assert sorted(jmeta) == sorted(tmeta) == ["config", "done", "n_chunks", "n_frames"]
    assert (tmeta["done"], tmeta["n_chunks"], tmeta["n_frames"]) == (10, 3, 10)
    assert sorted(jarr) == sorted(tarr)
    for k, v in jarr.items():
        assert tarr[k].tobytes() == v.tobytes(), k
    assert got.timing["restored_frames"] == want.timing["restored_frames"] == 0
    assert sorted(got.timing) == sorted(want.timing)
    direct = kcmc_tpu_torch.MotionCorrector(**KW).correct(data.stack)
    assert got.transforms.tobytes() == direct.transforms.tobytes()


def test_resume_restores_from_checkpoint(tmp_path, data):
    """A killed run's checkpoint is picked up, not recomputed: the
    resumed run restores the first chunk and equals a one-shot run."""
    mc = kcmc_tpu_torch.MotionCorrector(**KW)
    rc = ResumableCorrector(mc, str(tmp_path / "run2.ckpt.npz"), chunk_frames=4)

    class Boom(RuntimeError):
        pass

    orig = mc.correct
    calls = {"n": 0}

    def bombing_correct(stack, **kw):
        if calls["n"] >= 1:
            raise Boom()
        calls["n"] += 1
        return orig(stack, **kw)

    mc.correct = bombing_correct
    with pytest.raises(Boom):
        rc.correct(data.stack)
    mc.correct = orig
    assert mc.reference == 0  # the pinned reference is undone on the error path

    res = rc.correct(data.stack)
    assert res.timing["restored_frames"] == 4  # the first chunk came from disk
    direct = kcmc_tpu_torch.MotionCorrector(**KW).correct(data.stack)
    assert res.transforms.tobytes() == direct.transforms.tobytes()
    _close(res.corrected, direct.corrected)


def test_stale_checkpoint_is_discarded(tmp_path, data):
    path = str(tmp_path / "run3.ckpt.npz")
    ResumableCorrector(kcmc_tpu_torch.MotionCorrector(**KW), path, chunk_frames=4).correct(
        data.stack)
    # a different config: the checkpoint is stale, the run starts over
    res = ResumableCorrector(kcmc_tpu_torch.MotionCorrector(n_hypotheses=64, **KW), path,
                             chunk_frames=4).correct(data.stack)
    assert res.timing["restored_frames"] == 0
    assert res.transforms.shape == (10, 3, 3)
    # another stack length: stale too
    res = ResumableCorrector(kcmc_tpu_torch.MotionCorrector(n_hypotheses=64, **KW), path,
                             chunk_frames=4).correct(data.stack[:8])
    assert res.timing["restored_frames"] == 0 and res.transforms.shape == (8, 3, 3)


def test_resume_manager_rejects_rolling_templates(tmp_path):
    """Each chunk restarts from the initial template, so rolling updates
    would diverge from a one-shot run: refused, naming correct_file."""
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", template_update_every=8)
    with pytest.raises(ValueError, match="template_update_every") as e:
        ResumableCorrector(mc, str(tmp_path / "c.npz"))
    jmc = kcmc_tpu.MotionCorrector(backend="numpy", template_update_every=8)
    with pytest.raises(ValueError) as je:
        JaxPackageResumable(jmc, str(tmp_path / "j.npz"))
    assert str(e.value) == str(je.value)


def test_resume_rigid3d_volumes(tmp_path):
    """Volumes: chunked transforms equal the reference's and the one-shot
    run's by bytes; the volume re-warp within WARP_TOL."""
    v = make_drift_stack_3d(4, (16, 64, 64), seed=3)
    stack = np.asarray(v.stack, np.float32)
    kw = dict(KW, model="rigid3d", batch_size=2)
    want = JaxPackageResumable(kcmc_tpu.MotionCorrector(**kw), str(tmp_path / "j.npz"),
                               chunk_frames=2).correct(stack)
    got = ResumableCorrector(kcmc_tpu_torch.MotionCorrector(**kw), str(tmp_path / "t.npz"),
                             chunk_frames=2).correct(stack)
    assert got.transforms.shape == (4, 4, 4)
    assert got.transforms.tobytes() == want.transforms.tobytes()
    _close(got.corrected, want.corrected)
    direct = kcmc_tpu_torch.MotionCorrector(**kw).correct(stack)
    assert got.transforms.tobytes() == direct.transforms.tobytes()


@pytest.mark.parametrize("writer", ["jax_package", "port"])
def test_cross_package_checkpoint_restarts(tmp_path, data, writer):
    """Known difference: the config signature is `repr(config)`, and the
    port's config lacks the reference's two dropped fields, so a
    checkpoint either package wrote is stale to the other, which
    restarts from frame 0 and still gives the same transforms."""
    path = str(tmp_path / "x.npz")
    makers = {"jax_package": (JaxPackageResumable, kcmc_tpu),
              "port": (ResumableCorrector, kcmc_tpu_torch)}
    (wcls, wpkg), (rcls, rpkg) = (makers[writer],
                                  makers["port" if writer == "jax_package" else "jax_package"])
    first = wcls(wpkg.MotionCorrector(**KW), path, chunk_frames=4).correct(data.stack)
    assert repr(kcmc_tpu.MotionCorrector(**KW).config) != repr(
        kcmc_tpu_torch.MotionCorrector(**KW).config)
    again = rcls(rpkg.MotionCorrector(**KW), path, chunk_frames=4).correct(data.stack)
    assert again.timing["restored_frames"] == 0
    assert again.transforms.tobytes() == first.transforms.tobytes()
    assert _checkpoint(path)[0]["config"] == repr(rpkg.MotionCorrector(**KW).config)
