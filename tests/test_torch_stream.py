"""File-scale runs of the PyTorch port (`device="cpu"`): `correct_file`
writes the bytes of `write_stack` of `correct()`'s output; a run killed
by an injected fatal device fault resumes from its checkpoint and writes
the bytes of an uninterrupted run (plain, deflate, rolling template,
Zarr and HDF5 outputs), and a rerun is idempotent; stale signatures
restart; bad argument combinations raise the reference's errors;
registration-only runs feed `apply_correction_file`; and
`common_valid_region` equals the reference's. One `correct_file` run
against backend="jax"; everything else against the port's own
in-memory path or function by function."""

import hashlib
import os
import warnings

import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu import corrector as jcorrector
from kcmc_tpu_torch.io import open_stack, read_stack, write_stack
from kcmc_tpu_torch.io.formats import make_writer
from kcmc_tpu_torch.utils.faults import FatalFaultError
from kcmc_tpu_torch.utils.metrics import transform_rmse
from kcmc_tpu_torch.utils.synthetic import make_drift_stack

SHAPE = (96, 96)
# 128 keypoints: these tests hold bytes, resume and argument checks, not
# registration accuracy, and the plain patch cut dominates their time
KW = dict(batch_size=4, max_keypoints=128, retry_backoff_s=1e-4, retry_backoff_max_s=2e-4)
KILL = "device:step=4:fatal"  # the fifth batch: frames 16-19


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: torch's intra-op threads only slow them
    down when several test processes share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 24-frame 96x96 uint16 TIFF, a second channel of the same motion
    (deflate), and the port's in-memory run of the first."""
    d = make_drift_stack(24, SHAPE, seed=0)
    stack = np.clip(d.stack * 1000 + 100, 0, 65535).astype(np.uint16)
    root = tmp_path_factory.mktemp("stream")
    tif, ch2 = str(root / "in.tif"), str(root / "ch2.tif")
    write_stack(tif, stack)
    write_stack(ch2, (65535 - stack) // 2, compression="deflate")
    mem = kcmc_tpu_torch.MotionCorrector(device="cpu", **KW).correct(
        stack, output_dtype="input")
    return {"tif": tif, "ch2": ch2, "stack": stack, "mem": mem}


@pytest.fixture(scope="module")
def rolling(data):
    """The in-memory run with a rolling template every 8 frames."""
    return kcmc_tpu_torch.MotionCorrector(
        device="cpu", template_update_every=8, **KW).correct(data["stack"], output_dtype="input")


def _digest(path) -> str:
    """sha256 of a file, of every file of a directory store, or of an
    HDF5 file's dataset (HDF5 object headers embed creation times, so
    the reference's contract there is the dataset's bytes)."""
    h = hashlib.sha256()
    if path.endswith(".h5"):
        import h5py

        with h5py.File(path, "r") as f:
            h.update(np.ascontiguousarray(f["data"][...]).tobytes())
        return h.hexdigest()
    paths = [path] if os.path.isfile(path) else sorted(
        os.path.join(r, f) for r, _, fs in os.walk(path) for f in fs)
    for p in paths:
        h.update(os.path.relpath(p, path).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def test_correct_file_writes_correct_bytes(data, tmp_path):
    """The output file is `write_stack` of correct()'s uint16 output,
    byte for byte, and the transforms are bit-equal."""
    out = str(tmp_path / "out.tif")
    res = kcmc_tpu_torch.MotionCorrector(device="cpu", **KW).correct_file(
        data["tif"], output=out, chunk_size=8)
    write_stack(tmp_path / "want.tif", data["mem"].corrected)
    assert _digest(out) == _digest(str(tmp_path / "want.tif"))
    np.testing.assert_array_equal(res.transforms, data["mem"].transforms)
    assert res.corrected.shape == (0,) + SHAPE
    assert res.timing["feeder"]["decoder"] == "native"
    assert res.timing["robustness"]["faults_injected"] == 0


@pytest.mark.parametrize("case", ["plain", "deflate", "rolling", "zarr", "hdf5"])
def test_kill_and_resume_byte_identical(data, rolling, tmp_path, case):
    """Kill by an injected fatal device fault, then resume: the output
    is byte-identical to the uninterrupted run's (correct()'s frames,
    test_correct_file_writes_correct_bytes; with a rolling template
    too), `restored_frames` counts the checkpointed frames, and a rerun
    is idempotent."""
    if case == "hdf5":
        pytest.importorskip("h5py")
    ext = {"zarr": ".zarr", "hdf5": ".h5"}.get(case, ".tif")
    comp = "deflate" if case in ("deflate", "zarr") else "none"
    kw = dict(KW, template_update_every=8) if case == "rolling" else KW
    args = dict(chunk_size=8, compression=comp)
    full, out = str(tmp_path / f"full{ext}"), str(tmp_path / f"out{ext}")
    ckpt = str(tmp_path / "run.ckpt.npz")
    want = rolling if case == "rolling" else data["mem"]
    w = make_writer(full, 24, SHAPE, np.dtype(np.uint16), compression=comp)
    w.append_batch(want.corrected)
    w.close()
    killed = kcmc_tpu_torch.MotionCorrector(device="cpu", fault_plan=KILL, **kw)
    with pytest.raises(FatalFaultError):
        killed.correct_file(data["tif"], output=out, checkpoint=ckpt, checkpoint_every=8,
                            **args)
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", **kw)
    got = mc.correct_file(data["tif"], output=out, checkpoint=ckpt, checkpoint_every=8,
                          **args)
    assert got.timing["restored_frames"] == 16
    assert _digest(out) == _digest(full)
    np.testing.assert_array_equal(got.transforms, want.transforms)
    again = mc.correct_file(data["tif"], output=out, checkpoint=ckpt, checkpoint_every=8,
                            **args)
    assert again.timing["restored_frames"] == 24
    assert _digest(out) == _digest(full)
    np.testing.assert_array_equal(again.transforms, want.transforms)


def test_stale_signature_restarts_and_neutral_knobs_resume(data, tmp_path):
    src = str(tmp_path / "in8.tif")
    write_stack(src, data["stack"][:8])
    args = dict(output=str(tmp_path / "out.tif"), checkpoint=str(tmp_path / "c.npz"))
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", **KW)
    mc.correct_file(src, **args)
    # retry and I/O knobs are normalized out of the signature: resume
    res = kcmc_tpu_torch.MotionCorrector(
        device="cpu", **dict(KW, retry_attempts=5, writer_depth=0, io_prefetch=3)
    ).correct_file(src, **args)
    assert res.timing["restored_frames"] == 8
    # a knob that changes the results: the checkpoint is stale, restart
    res = kcmc_tpu_torch.MotionCorrector(device="cpu", n_hypotheses=64, **KW).correct_file(
        src, **args)
    assert res.timing["restored_frames"] == 0
    assert res.transforms.shape == (8, 3, 3)
    # a replaced input of the same shape restarts too
    write_stack(src, data["stack"][8:16])
    res = mc.correct_file(src, **args)
    assert res.timing["restored_frames"] == 0


@pytest.mark.parametrize("kw,match", [
    ({"checkpoint": "c.npz"}, "checkpoint requires output"),
    ({"checkpoint": "c.npz", "output": "o.tif", "array": True}, "file-path source"),
    ({"emit_frames": False, "output": "o.tif"}, "registration-only"),
    ({"stall_abort": 0}, "stall_abort must be positive"),
])
def test_bad_argument_combinations_raise(data, tmp_path, kw, match):
    """correct_file rejects the reference's bad argument combinations
    with its messages."""
    kw = dict(kw)
    src = data["stack"] if kw.pop("array", False) else data["tif"]
    for k in ("checkpoint", "output"):
        if k in kw:
            kw[k] = str(tmp_path / kw[k])
    errs = []
    for mc in (kcmc_tpu.MotionCorrector(backend="numpy", batch_size=4),
               kcmc_tpu_torch.MotionCorrector(device="cpu", batch_size=4)):
        with pytest.raises(ValueError, match=match) as e:
            mc.correct_file(src, **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.int32, np.uint32])
def test_integer_cast_matches_reference(dtype):
    """Rounding and clipping float32 frames to an integer output dtype
    gives the reference's values, also at int32's top, which float32
    cannot hold (ROADMAP queue 3, fault D)."""
    from kcmc_tpu_torch.corrector import _cast_output

    info = np.iinfo(dtype)
    arr = np.array([[-3e9, -1.5, -0.5, 0.49, 2.5, 254.6, 65535.4, 4e4, 2.2e9, 3e9,
                     float(info.min), float(info.max)]], np.float32)
    want = jcorrector._cast_output(arr, np.dtype(dtype))
    got = _cast_output(arr, np.dtype(dtype))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_object_urls_and_frame_rank_raise(data, tmp_path):
    """correct_file takes object-store URLs (it raised NotImplementedError
    for them until the port had an object store): a bucket without a
    manifest and an output scheme with no registered client raise the
    reference's errors."""
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", batch_size=4)
    with pytest.raises(FileNotFoundError, match="no usable stack manifest"):
        mc.correct_file(f"emu://{tmp_path}/none")
    with pytest.raises(ValueError, match="no client registered for scheme 's3'"):
        mc.correct_file(data["tif"], output="s3://bucket/out")
    with pytest.raises(ValueError, match="3D frames"):
        kcmc_tpu_torch.MotionCorrector(model="rigid3d", device="cpu").correct_file(data["tif"])


@pytest.mark.parametrize("every", [0, 8])
def test_registration_only_then_apply_file(data, rolling, tmp_path, every):
    """emit_frames=False recovers correct()'s transforms (with a rolling
    template too); apply_correction_file of a second channel equals the
    in-memory apply_correction cast to the file's dtype."""
    kw = dict(KW, template_update_every=every)
    want = rolling if every else data["mem"]
    reg = kcmc_tpu_torch.MotionCorrector(device="cpu", **kw).correct_file(
        data["tif"], emit_frames=False, chunk_size=8)
    np.testing.assert_array_equal(reg.transforms, want.transforms)
    assert reg.corrected.shape == (0,) + SHAPE
    if every:
        return
    out = str(tmp_path / "ch2_out.tif")
    kcmc_tpu_torch.apply_correction_file(data["ch2"], out, transforms=reg.transforms,
                                         chunk_size=10, device="cpu")
    ch2 = read_stack(data["ch2"])
    mem = kcmc_tpu_torch.apply_correction(ch2, reg.transforms, output_dtype="input",
                                          device="cpu")
    np.testing.assert_array_equal(read_stack(out), mem)
    with pytest.raises(ValueError, match="24 pages but 23"):
        kcmc_tpu_torch.apply_correction_file(data["ch2"], out, transforms=reg.transforms[1:],
                                             device="cpu")


def _transforms_2d(seed, n, drift):
    rng = np.random.default_rng(seed)
    M = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    th = rng.uniform(-0.05, 0.05, n)
    M[:, 0, 0] = M[:, 1, 1] = np.cos(th)
    M[:, 0, 1], M[:, 1, 0] = -np.sin(th), np.sin(th)
    M[:, :2, 2] = rng.uniform(-drift, drift, (n, 2))
    return M


def _transforms_3d(seed, n):
    rng = np.random.default_rng(seed)
    M = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    M[:, :3, 3] = rng.uniform(-3, 3, (n, 3))
    M[:, 0, 2] = rng.uniform(-0.05, 0.05, n)  # a z-dependent shear
    return M


@pytest.mark.parametrize("case", ["2d", "2d_wide", "3d", "empty"])
def test_common_valid_region_matches(case):
    if case == "3d":
        M, shape = _transforms_3d(1, 300), (12, 40, 48)
    elif case == "empty":
        M, shape = _transforms_2d(2, 5, 0.0), (64, 80)
        M[0, 0, 2], M[1, 0, 2] = 70.0, -70.0  # opposite drifts past the frame
    else:
        M, shape = _transforms_2d(0, 300 if case == "2d_wide" else 7, 9.0), (64, 80)
    if case == "empty":
        for fn in (jcorrector.common_valid_region, kcmc_tpu_torch.common_valid_region):
            with pytest.raises(ValueError, match="no region is covered"):
                fn(M, shape, **({"device": "cpu"} if fn is not
                                jcorrector.common_valid_region else {}))
        return
    want = jcorrector.common_valid_region(M, shape)
    assert kcmc_tpu_torch.common_valid_region(M, shape, device="cpu") == want


# slow: the reference's batch programs compile for this one run (16 s of
# junit time in a six-worker tier-1 run, a quarter of the three file
# suites' budget); everything else here is held function by function
@pytest.mark.slow
def test_correct_file_matches_jax_backend(data):
    """The one backend="jax" run of this file: correct_file on the same
    TIFF, transforms within the tolerance of the port's JAX runs."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = kcmc_tpu.MotionCorrector(backend="jax", batch_size=4).correct_file(
            data["tif"], chunk_size=8)
    got = kcmc_tpu_torch.MotionCorrector(device="cpu", batch_size=4).correct_file(
        data["tif"], chunk_size=8)
    assert transform_rmse(got.transforms, want.transforms, SHAPE) <= 1e-3
    for k in ("n_inliers", "n_matches", "n_keypoints"):
        np.testing.assert_array_equal(got.diagnostics[k], want.diagnostics[k])
    with open_stack(data["tif"]) as ts:
        assert ts.backend == "native"
