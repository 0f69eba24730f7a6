"""The port's backend plugin seam (`kcmc_tpu_torch/backends/__init__.py`)
and its pure-NumPy oracle (`backends/numpy_backend.py`, `_np_kernels.py`)
against kcmc_tpu's.

The registry's names, errors and root exports equal the reference's;
`bf16_round` equals `ml_dtypes`' cast bit for bit on every float32
class; the port's `backend="numpy"` runs give the reference's NumPy
backend's bytes (transforms, fields, frames and diagnostics) for every
model at 64²-128² with 4-8 frames and K <= 256; a minimal third-party
backend (only `prepare_reference` / `process_batch`), registered in
both packages, runs `correct()`, `correct_file()` and a serve stream;
the scheduler's synchronous dispatch serves the numpy oracle; warmup
on it equals the reference's; and the oracle imports no torch. No test
compiles anything."""

import os
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu_torch.backends import _np_kernels
from kcmc_tpu_torch.utils.synthetic import (
    make_drift_stack,
    make_drift_stack_3d,
    make_piecewise_stack,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the registry -------------------------------------------------------------


def test_registry_names_and_root_exports_equal_the_references():
    from kcmc_tpu_torch import backends

    assert kcmc_tpu_torch.available_backends() == ["numpy", "torch"]
    assert kcmc_tpu.available_backends() == ["jax", "numpy"]
    for name in ("available_backends", "get_backend", "register_backend"):
        assert getattr(kcmc_tpu_torch, name) is getattr(backends, name)
        assert callable(getattr(kcmc_tpu, name))
    fb = kcmc_tpu_torch.get_backend("numpy", kcmc_tpu_torch.CorrectorConfig())
    assert type(fb).__name__ == "NumpyBackend" and fb.name == "numpy"
    tb = kcmc_tpu_torch.get_backend("torch", kcmc_tpu_torch.CorrectorConfig(), device="cpu")
    assert tb.name == "torch" and str(tb.device) == "cpu" and tb.mesh is None
    assert not tb._plan.active
    meshed = kcmc_tpu_torch.get_backend("torch", kcmc_tpu_torch.CorrectorConfig(),
                                        device="cpu", mesh=("cpu", "cpu"))
    assert meshed.mesh == (torch.device("cpu"),) * 2 and str(meshed.device) == "cpu"


@pytest.mark.parametrize("where", ["get_backend", "corrector"])
def test_unknown_backend_raises_the_references_error(where):
    def message(pkg):
        with pytest.raises(ValueError) as e:
            if where == "get_backend":
                pkg.get_backend("jax" if pkg is kcmc_tpu_torch else "torch",
                                pkg.CorrectorConfig())
            else:
                pkg.MotionCorrector(backend="jax" if pkg is kcmc_tpu_torch else "torch")
        return str(e.value)

    got, want = message(kcmc_tpu_torch), message(kcmc_tpu)
    assert got == "unknown backend 'jax'; available: ['numpy', 'torch']"
    assert want == "unknown backend 'torch'; available: ['jax', 'numpy']"


def test_numpy_backend_refuses_the_card_and_banded_matching():
    with pytest.raises(ValueError, match="runs on the host CPU"):
        kcmc_tpu_torch.MotionCorrector(backend="numpy", device="cuda")
    for pkg in (kcmc_tpu, kcmc_tpu_torch):
        with pytest.raises(ValueError, match="no banded-matching mirror"):
            pkg.MotionCorrector(backend="numpy", match_radius=12.0)
    mc = kcmc_tpu_torch.MotionCorrector(backend="numpy", device="cpu", mesh_devices=2)
    assert mc.backend_name == "numpy" and mc.backend.mesh is None
    assert mc.backend.runtime_info()["mesh_devices_ignored"] == 2


def test_numpy_backend_imports_no_torch():
    """The oracle shares no code with the port's torch path: importing
    it (and the registry) pulls in no torch, jax, ml_dtypes or kcmc_tpu."""
    code = textwrap.dedent(
        """
        import sys
        import kcmc_tpu_torch.backends.numpy_backend
        from kcmc_tpu_torch.backends import get_backend
        from kcmc_tpu_torch.config import CorrectorConfig
        get_backend("numpy", CorrectorConfig())
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("torch", "jax", "ml_dtypes", "kcmc_tpu")]
        assert not bad, bad
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": REPO}, timeout=120)
    assert out.returncode == 0, out.stderr


# -- bf16 rounding ------------------------------------------------------------


def _bits(*words) -> np.ndarray:
    return np.array(words, np.uint32).view(np.float32)


BF16_CLASSES = {
    # normal values of every magnitude, both signs
    "normals": np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    * np.float32(10.0) ** np.random.default_rng(1).integers(-30, 30, 4096).astype(np.float32),
    # exact ties of the lower 16 bits, with an even and an odd kept lsb
    "ties": _bits(0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000, 0x00008000,
                  0x00018000, 0x7F7E8000, 0x47FF8000),
    "subnormals": np.concatenate([_bits(1, 0x8000_0001, 0x7FFF, 0x8000, 0x116C2, 0x7FFFFF,
                                        0x807FFFFF),
                                  np.random.default_rng(2).integers(1, 1 << 23, 512)
                                  .astype(np.uint32).view(np.float32)]),
    "zeros": _bits(0, 0x80000000),
    "infinities": _bits(0x7F800000, 0xFF800000),
    "nans": _bits(0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FBFFFFF, 0x7FFFFFFF,
                  0xFFFFFFFF, 0x7FC00001),
    "overflow": _bits(0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF, 0xFF7F8001),
}


@pytest.mark.parametrize("cls", sorted(BF16_CLASSES))
def test_bf16_round_equals_ml_dtypes_bitwise(cls):
    x = BF16_CLASSES[cls]
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    got = _np_kernels.bf16_round(x)
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- the oracle against the reference's NumPy backend ------------------------


CASES = {
    "translation": lambda: make_drift_stack(6, (64, 64), model="translation", seed=0).stack,
    "rigid": lambda: make_drift_stack(6, (64, 64), model="rigid", seed=1).stack,
    "similarity": lambda: make_drift_stack(6, (64, 64), model="similarity", seed=2).stack,
    "affine": lambda: make_drift_stack(6, (80, 80), model="affine", seed=3).stack,
    "homography": lambda: make_drift_stack(6, (80, 80), model="homography", seed=4).stack,
    "piecewise": lambda: make_piecewise_stack(4, (64, 64), seed=5).stack,
    "pyramid": lambda: make_drift_stack(4, (128, 128), model="similarity", seed=6).stack,
    "rigid3d": lambda: make_drift_stack_3d(4, (16, 64, 64), seed=7).stack,
}
OPTIONS = {
    "translation": dict(quality_metrics=True),
    "affine": dict(quality_metrics=True, template_iters=1),
    "homography": dict(sanitize_input=True),
    "pyramid": dict(model="similarity", n_octaves=2),
}


def _pair(model, stack, **kw):
    args = dict(model=model, backend="numpy", batch_size=4, max_keypoints=128, **kw)
    args.update(OPTIONS.get(model, {}))
    if model == "pyramid":
        args["max_keypoints"] = 256
    return [pkg.MotionCorrector(**args).correct(stack, output_dtype="input")
            for pkg in (kcmc_tpu, kcmc_tpu_torch)]


def _assert_bytes_equal(want, got):
    for k in ("transforms", "fields", "corrected"):
        a, b = getattr(want, k), getattr(got, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
    assert sorted(want.diagnostics) == sorted(got.diagnostics)
    for k, v in want.diagnostics.items():
        assert v.tobytes() == got.diagnostics[k].tobytes(), k
    assert sorted(want.timing) == sorted(got.timing)
    assert want.timing["pipeline"] == got.timing["pipeline"]


@pytest.mark.parametrize("model", sorted(CASES))
def test_numpy_backend_bytes_equal_the_references(model):
    stack = CASES[model]()
    if model == "rigid3d":
        stack = np.asarray(stack, np.float32)
    elif model == "translation":  # a camera's uint16 frames, cast back on the host
        stack = np.clip(stack * 40000, 0, 65535).astype(np.uint16)
    want, got = _pair(model, stack)
    assert want.transforms is not None or want.fields is not None
    _assert_bytes_equal(want, got)


# -- a third-party backend with only the original seam ------------------------


class _CentroidBackend:
    """A plugin with only __init__, prepare_reference and process_batch:
    the translation between intensity centroids, the frames unwarped."""

    name = "centroid"

    def __init__(self, config, **_options):
        self.config = config

    @staticmethod
    def _centroid(frame):
        ys, xs = np.mgrid[0:frame.shape[0], 0:frame.shape[1]]
        w = np.maximum(frame, 0).astype(np.float64)
        s = max(w.sum(), 1e-12)
        return np.array([(w * xs).sum() / s, (w * ys).sum() / s])

    def prepare_reference(self, ref_frame):
        ref_frame = np.asarray(ref_frame, np.float32)
        return {"frame": ref_frame, "c": self._centroid(ref_frame)}

    def process_batch(self, frames, ref, frame_indices):
        assert frames.dtype == np.float32  # no accepts_native_dtype: cast on the host
        M = np.tile(np.eye(3, dtype=np.float32), (len(frames), 1, 1))
        for i, f in enumerate(frames):
            M[i, :2, 2] = self._centroid(f) - ref["c"]
        return {"transform": M, "corrected": np.array(frames, np.float32),
                "n_inliers": np.asarray(frame_indices, np.int32) % 7}


@pytest.fixture
def centroid_backend(request):
    import kcmc_tpu.backends as jreg
    import kcmc_tpu_torch.backends as treg

    for reg in (jreg, treg):
        reg.register_backend("centroid")(_CentroidBackend)

    def unregister():
        for reg in (jreg, treg):
            reg._REGISTRY.pop("centroid", None)

    request.addfinalizer(unregister)
    return "centroid"


@pytest.mark.parametrize("entry", ["correct", "correct_file", "serve"])
def test_third_party_backend_runs_in_both_packages(centroid_backend, entry, tmp_path):
    stack = np.clip(make_drift_stack(10, (48, 48), seed=8).stack * 40000, 0,
                    65535).astype(np.uint16)
    kw = dict(model="translation", backend=centroid_backend, batch_size=4)
    want = kcmc_tpu.MotionCorrector(**kw).correct(stack, output_dtype="input")
    assert kcmc_tpu_torch.available_backends() == ["centroid", "numpy", "torch"]
    mc = kcmc_tpu_torch.MotionCorrector(**kw)
    assert mc.backend_name == "centroid"
    if entry == "correct":
        got = mc.correct(stack, output_dtype="input")
        _assert_bytes_equal(want, got)
    elif entry == "correct_file":
        from kcmc_tpu_torch.io import write_stack

        path = str(tmp_path / "in.tif")
        write_stack(path, stack)
        got = mc.correct_file(path, chunk_size=4)
        assert got.transforms.tobytes() == want.transforms.tobytes()
        assert got.corrected.tobytes() == want.corrected.tobytes()
        np.testing.assert_array_equal(got.diagnostics["n_inliers"],
                                      want.diagnostics["n_inliers"])
    else:
        from kcmc_tpu_torch.serve import StreamScheduler

        sched = StreamScheduler(mc).start()
        try:
            s = sched.open_session(tenant="plugin")
            sched.submit(s.sid, stack[:3])
            sched.submit(s.sid, stack[3:])
            got = sched.close_session(s.sid, timeout=120)
        finally:
            sched.stop()
        assert got.transforms.tobytes() == want.transforms.tobytes()


def test_serve_stream_of_the_numpy_oracle_equals_correct():
    """The scheduler's synchronous dispatch (the oracle has no
    process_batch_async): a stream submitted in uneven pieces equals a
    one-shot `correct()` by bytes, and the degraded twin is the oracle
    too."""
    from kcmc_tpu_torch.serve import StreamScheduler

    stack = make_drift_stack(11, (48, 48), seed=9).stack
    kw = dict(model="translation", backend="numpy", batch_size=4, max_keypoints=64)
    truth = kcmc_tpu_torch.MotionCorrector(**kw).correct(stack)
    mc = kcmc_tpu_torch.MotionCorrector(**kw)
    sched = StreamScheduler(mc).start()
    try:
        s = sched.open_session(tenant="oracle", emit_frames=True)
        sched.submit(s.sid, stack[:5])
        sched.submit(s.sid, stack[5:])
        got = sched.close_session(s.sid, timeout=120)
        twin = sched._get_degraded_backend()
    finally:
        sched.stop()
    assert got.transforms.tobytes() == truth.transforms.tobytes()
    np.testing.assert_array_equal(got.corrected, truth.corrected)
    assert twin.name == "numpy" and twin.config.n_hypotheses == 32


def test_warmup_on_the_numpy_oracle_equals_the_references():
    """A backend without a plan runtime warms through its entry points,
    as the reference's warmup does on its numpy backend: the same
    programs built and no stamp counters (the port's summary adds its
    kernel libraries, none here)."""
    kw = dict(model="translation", backend="numpy", batch_size=2, max_keypoints=64,
              plan_buckets=(48,), template_update_every=4)
    for pkg in (kcmc_tpu, kcmc_tpu_torch):  # no plan runtime: no configured buckets
        with pytest.raises(ValueError, match="no shape buckets"):
            pkg.MotionCorrector(**kw).warmup()
    want = kcmc_tpu.MotionCorrector(**kw).warmup(buckets=(48,), dtypes=("float32", "uint16"))
    got = kcmc_tpu_torch.MotionCorrector(**kw).warmup(buckets=(48,),
                                                       dtypes=("float32", "uint16"))
    assert got["libraries"] == {}
    for k in ("buckets", "dtypes", "programs", "programs_built"):
        assert got[k] == want[k], k
    assert set(got) - {"libraries", "libraries_s"} == set(want)
    assert "stamp_misses" not in got and "plan_cache" not in got
