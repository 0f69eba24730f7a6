"""The port's robustness layer against kcmc_tpu's: fault-plan grammar and
seeded draws, retry delays, the transient/fatal split, the config's
checks, stream checkpoints (parts, checksums, quarantine, the rewind to
the last good prefix), and the degradation ladder of `correct_file`
against the reference's `backend="numpy"` run under the same fault
specs. The failover rung, which the reference's numpy primary never
takes, is held by the port's own invariants and against the port's
NumpyBackend oracle, which it runs; a real error of the batch program
raises."""

import dataclasses
import errno
import os
import warnings

import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu.utils import checkpoint as jckpt
from kcmc_tpu.utils import faults as jfaults
from kcmc_tpu_torch.io import write_stack
from kcmc_tpu_torch.io.tiff import read_stack
from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.utils import checkpoint as tckpt
from kcmc_tpu_torch.utils import faults as tfaults
from kcmc_tpu_torch.utils.metrics import RobustnessReport, transform_rmse
from kcmc_tpu_torch.utils.synthetic import make_drift_stack

SHAPE = (96, 96)
FAST = dict(retry_backoff_s=1e-4, retry_backoff_max_s=2e-4)
KW = dict(batch_size=4, **FAST)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: torch's intra-op threads only slow them
    down when several test processes share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tif(tmp_path_factory):
    """A 24-frame 96x96 uint16 drift recording."""
    d = make_drift_stack(24, SHAPE, seed=0)
    path = str(tmp_path_factory.mktemp("faults") / "in.tif")
    write_stack(path, np.clip(d.stack * 1000 + 100, 0, 65535).astype(np.uint16))
    return path


@pytest.fixture(scope="module")
def clean(tif):
    """The port's clean in-memory run of the recording (correct_file
    gives its frames and transforms bit for bit, test_torch_stream.py)."""
    return kcmc_tpu_torch.MotionCorrector(device="cpu", **KW).correct(
        read_stack(tif), output_dtype="input")


# ---------------------------------------------------------------------------
# grammar, draws, delays, the transient split


SPECS = [
    "device:step=2:transient",
    "device:step=1:times=2, io_read:step=0:raise",
    "device:p=0.5:always, failover:always",
    "io_read:p=0.3:times=5, device:step=7:fatal",
    "checkpoint:corrupt_part=1, device:always:p=0.2",
    "transport:stall=0.5, scheduler:step=2, object:step=1:flip, fleet:times=2",
]


def _draws(mod, spec, seed):
    """Which attempts of a fixed sequence of operations each plan fails."""
    plan = mod.FaultPlan.from_spec(spec, seed=seed)
    seen = []
    for surface in ("device", "io_read", "failover", "transport", "scheduler",
                    "fleet", "object"):
        for _ in range(6):
            step = plan.op_index(surface)
            for attempt in range(3):
                try:
                    plan.maybe_fail(surface, step)
                    seen.append((surface, step, attempt, None))
                except mod.FaultError as e:
                    seen.append((surface, step, attempt, type(e).__name__, str(e)))
            seen.append(("stall", plan.take_stall(surface, step)))
    seen.append(("corrupt", [plan.take_checkpoint_corruption(p) for p in range(3)]))
    return seen, plan.injected


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, 11])
def test_fault_plan_draws_match(spec, seed):
    assert _draws(tfaults, spec, seed) == _draws(jfaults, spec, seed)


@pytest.mark.parametrize("spec", [
    "nope:1", "device:step=x", "device:times=0", "device:p=2", "device:corrupt_part=1",
    "checkpoint:step=1", "device:stall=1", "device:flip", "device:wat", "", "device:bogus=1",
])
def test_fault_spec_errors_match(spec):
    errs = []
    for mod in (jfaults, tfaults):
        with pytest.raises(ValueError) as e:
            mod.FaultPlan.from_spec(spec)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("kw", [
    {}, {"attempts": 5, "backoff_s": 0.1, "backoff_max_s": 0.5, "jitter": 0.5, "seed": 1},
    {"jitter": 0.0, "backoff_s": 0.1, "backoff_max_s": 10.0}, {"seed": 9, "jitter": 1.0},
])
def test_retry_delays_match(kw):
    a, b = jfaults.RetryPolicy(**kw), tfaults.RetryPolicy(**kw)
    assert [b.delay(k) for k in range(8)] == [a.delay(k) for k in range(8)]


def test_default_retry_policies_match():
    cfg = kcmc_tpu_torch.CorrectorConfig(retry_attempts=4, seed=3, retry_jitter=0.5)
    jcfg = kcmc_tpu.CorrectorConfig(retry_attempts=4, seed=3, retry_jitter=0.5)
    for off in (0, 1, 2):
        a = jfaults.default_io_retry_policy(jcfg, seed_offset=off)
        b = tfaults.default_io_retry_policy(cfg, seed_offset=off)
        assert b.attempts == a.attempts
        assert [b.delay(k) for k in range(4)] == [a.delay(k) for k in range(4)]
    assert tfaults.default_io_retry_policy(cfg.replace(retry_attempts=1)) is None
    assert tfaults.default_io_retry_policy(None).attempts == 3


def test_classify_transient_split_matches():
    class DeviceError(Exception):
        pass

    cases = [
        (jfaults.TransientFaultError("x"), tfaults.TransientFaultError("x")),
        (jfaults.FatalFaultError("x"), tfaults.FatalFaultError("x")),
    ]
    shared = [OSError("read failed"), TimeoutError("slow"), ConnectionResetError("peer"),
              FileNotFoundError("gone"), PermissionError("no"), IsADirectoryError("d"),
              ValueError("shape"), RuntimeError("CUDA error: an illegal memory access"),
              KeyboardInterrupt(), DeviceError("UNAVAILABLE: link"), DeviceError("rank")]
    for j, t in cases:
        assert tfaults.classify_transient(t) == jfaults.classify_transient(j)
    for e in shared:
        for extra in ((), (DeviceError,)):
            assert tfaults.classify_transient(e, extra) == jfaults.classify_transient(e, extra)
    # the port's backend declares no transient device errors: a CUDA
    # error (a RuntimeError) is fatal
    assert kcmc_tpu_torch.MotionCorrector(device="cpu").backend.transient_error_types == ()


def test_device_surface_split():
    """The batch program does no I/O: on the device surface an OSError
    is fatal, and only injected transient faults stay transient."""
    class DeviceError(Exception):
        pass

    assert tfaults.classify_device_transient(tfaults.TransientFaultError("x"))
    assert tfaults.classify_device_transient(DeviceError("UNAVAILABLE"), (DeviceError,))
    for e in (OSError(errno.EIO, "I/O error"), OSError(errno.EMFILE, "too many files"),
              TimeoutError("slow"), ConnectionResetError("peer"),
              tfaults.FatalFaultError("x"), RuntimeError("CUDA error")):
        assert not tfaults.classify_device_transient(e)


@pytest.mark.parametrize("kw", [
    {"retry_attempts": 0}, {"retry_backoff_s": 0.0}, {"retry_backoff_max_s": 0.01},
    {"retry_jitter": 1.5}, {"fault_plan": "nope:1"}, {"writer_depth": -1}, {"io_workers": -1}, {"io_prefetch": -1},
])
def test_config_checks_match(kw):
    errs = []
    for cls in (kcmc_tpu.CorrectorConfig, kcmc_tpu_torch.CorrectorConfig):
        with pytest.raises(ValueError) as e:
            cls(**kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_config_carries_robustness_fields_and_failover_names():
    jcfg = kcmc_tpu.CorrectorConfig(retry_attempts=5, fault_plan="device:step=1",
                                    io_workers=3, writer_depth=0, failover_backend=None,
                                    object_timeout_s=2.0, object_hedge_ms=0.0,
                                    object_chunk_frames=8, object_part_bytes=1 << 20)
    cfg = kcmc_tpu_torch.config_from_dict(dataclasses.asdict(jcfg))
    for name in ("retry_attempts", "fault_plan", "io_workers", "writer_depth",
                 "failover_backend", "object_timeout_s", "object_hedge_ms",
                 "object_chunk_frames", "object_part_bytes"):
        assert getattr(cfg, name) == getattr(jcfg, name)
    # the object store's knobs, with the code that reads them
    obj = [f.name for f in dataclasses.fields(cfg) if f.name.startswith("object_")]
    assert sorted(obj) == ["object_chunk_frames", "object_hedge_ms", "object_part_bytes",
                           "object_timeout_s"]
    with pytest.raises(ValueError, match="failover_backend"):
        kcmc_tpu_torch.MotionCorrector(device="cpu", failover_backend="jax")


# ---------------------------------------------------------------------------
# stream checkpoints


def _segments(seed, n):
    rng = np.random.default_rng(seed)
    return [{"transform": rng.normal(size=(4, 3, 3)).astype(np.float32),
             "n_inliers": rng.integers(0, 99, 4).astype(np.int32)} for _ in range(n)]


def _save(mod, path):
    """Three parts of two segments each, with the per-part writer
    snapshots a rewind returns to."""
    meta = {"sig": {"a": 1}, "parts": []}
    for p in range(3):
        meta = mod.save_stream_checkpoint(
            path, dict(meta, done=8 * (p + 1), n_parts=p, writer={"n_pages": 8 * (p + 1)}),
            _segments(p, 2), p,
        )


@pytest.mark.parametrize("writer_mod", ["port", "reference"])
def test_checkpoint_round_trip_matches(tmp_path, writer_mod):
    path = str(tmp_path / "run.ckpt.npz")
    _save(tckpt if writer_mod == "port" else jckpt, path)
    want = jckpt.load_stream_checkpoint(path)
    got = tckpt.load_stream_checkpoint(path)
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1]) == 6
    for g, w in zip(got[1], want[1]):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("part", [0, 1, 2])
def test_corrupt_part_quarantine_and_rewind_match(tmp_path, part):
    """A corrupt part is quarantined to .corrupt and the load rewinds to
    the last good prefix (or restarts at part 0), as the reference's."""
    results = []
    for mod in (jckpt, tckpt):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        path = str(d / "run.ckpt.npz")
        _save(tckpt, path)
        plan = (jfaults if mod is jckpt else tfaults).FaultPlan.from_spec(
            f"checkpoint:corrupt_part={part}")
        report = RobustnessReport()
        with pytest.warns(RuntimeWarning, match="corrupt"):
            state = mod.load_stream_checkpoint(path, fault_plan=plan, report=report)
        results.append((
            None if state is None else (state[0], len(state[1])),
            [os.path.basename(q) for q in report.quarantined_parts],
            sorted(os.listdir(d)),
        ))
    assert results[0] == results[1]
    if part:
        assert results[1][0][0]["done"] == 8 * part


# ---------------------------------------------------------------------------
# the degradation ladder


def _run_port(tif, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return kcmc_tpu_torch.MotionCorrector(device="cpu", **KW, **kw).correct_file(
            tif, chunk_size=8)


@pytest.mark.parametrize("spec,extra", [
    ("device:step=1:transient:times=2", {}),  # the retries absorb it
    ("device:step=4:always", {"failover_backend": None}),  # frames marked failed
])
def test_ladder_matches_reference_numpy(tif, spec, extra):
    """Retry counts, failed frames and the interpolated transforms equal
    the reference's numpy run under the same fault spec."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = kcmc_tpu.MotionCorrector(backend="numpy", fault_plan=spec, **KW,
                                        **extra).correct_file(tif, chunk_size=8)
    got = _run_port(tif, fault_plan=spec, **extra)
    assert got.timing["robustness"] == want.timing["robustness"]
    if "frames_failed" in want.diagnostics:
        np.testing.assert_array_equal(got.diagnostics["frames_failed"],
                                      want.diagnostics["frames_failed"])
        assert got.diagnostics["frames_failed"].sum() == 4
    else:
        assert "frames_failed" not in got.diagnostics
    assert transform_rmse(got.transforms, want.transforms, SHAPE) <= 1e-4


def _oracle_batch(mc, stack, lo, hi):
    """The port's NumpyBackend (through `get_backend`, with its own
    prepared reference) on frames lo..hi-1: what the failover rung must
    have run. Returns (transforms, frames cast like the run's)."""
    fb = kcmc_tpu_torch.get_backend("numpy", mc.config)
    ref = fb.prepare_reference(np.asarray(stack[0], np.float32))
    out = fb.process_batch(stack[lo:hi], ref, np.arange(lo, hi))
    frames = np.clip(np.rint(out["corrected"]), 0, 65535).astype(stack.dtype)
    return out["transform"], frames


FAILOVER = np.arange(24) // 4 == 2  # device:step=2 is the batch of frames 8..11


def test_failover_rung_invariants(tif, clean, tmp_path):
    """A fault that exhausts the retries leaves one failover; the
    failover names the batch; every other frame equals a clean run's,
    and the failed-over batch equals the NumpyBackend oracle's run of
    it, bit for bit (the rung runs the oracle, not the code under
    test)."""
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", fault_plan="device:step=2:always", **KW)
    with pytest.warns(RuntimeWarning, match="failover backend"):
        got = mc.correct_file(tif, chunk_size=8, output=str(tmp_path / "out.tif"))
    rb = got.timing["robustness"]
    assert (rb["device_retries"], rb["backend_failovers"], rb["failover_frames"],
            rb["failed_frames"]) == (2, 1, 4, 0)
    assert mc._robustness.failover_frame_indices == [8, 9, 10, 11]
    written = read_stack(str(tmp_path / "out.tif"))
    np.testing.assert_array_equal(got.transforms[~FAILOVER], clean.transforms[~FAILOVER])
    np.testing.assert_array_equal(written[~FAILOVER], clean.corrected[~FAILOVER])
    transforms, frames = _oracle_batch(mc, read_stack(tif), 8, 12)
    np.testing.assert_array_equal(got.transforms[FAILOVER], transforms)
    np.testing.assert_array_equal(written[FAILOVER], frames)


def test_failover_frame_indices_and_correct_ladder(tif, clean):
    """correct() walks the same ladder: the failover names frames 8-11,
    and a transient fault the retries absorb leaves the output bit-equal
    to a clean run's; an io_read fault is retried by the loader."""
    stack = read_stack(tif)
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", fault_plan="device:step=2:always", **KW)
    with pytest.warns(RuntimeWarning, match="frames 8..11 failed 3 attempt"):
        got = mc.correct(stack, output_dtype="input")
    assert mc._robustness.failover_frame_indices == [8, 9, 10, 11]
    np.testing.assert_array_equal(got.corrected[~FAILOVER], clean.corrected[~FAILOVER])
    np.testing.assert_array_equal(got.corrected[FAILOVER], _oracle_batch(mc, stack, 8, 12)[1])
    got = _run_port(tif, fault_plan="device:step=1:times=2, io_read:step=1:transient")
    rb = got.timing["robustness"]
    assert (rb["device_retries"], rb["io_retries"], rb["faults_injected"]) == (2, 1, 3)
    # without an output, correct_file returns correct()'s cast frames
    np.testing.assert_array_equal(got.corrected, clean.corrected)
    np.testing.assert_array_equal(got.transforms, clean.transforms)


def test_real_batch_program_error_raises(tif, monkeypatch):
    """A non-transient error from inside the batch program propagates:
    no retry, no failover, no failed frames."""
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", **KW)
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    # the seam the pipelined dispatch calls
    monkeypatch.setattr(mc.backend, "process_batch_async", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        mc.correct_file(tif, chunk_size=8)
    assert len(calls) == 1 and mc._robustness.device_retries == 0
    assert mc._failover_backend is None


@pytest.mark.parametrize("exc", [
    OSError(errno.EIO, "Input/output error"), ConnectionResetError("peer"),
    TimeoutError("slow"),
], ids=["eio", "connreset", "timeout"])
def test_batch_program_os_error_raises(tif, monkeypatch, exc):
    """An OSError from inside the batch program is a fault of the
    program (it does no I/O): it propagates with no retry and no
    failover, whatever classify_transient says of it elsewhere."""
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", **KW)
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise exc

    # the seam the pipelined dispatch calls
    monkeypatch.setattr(mc.backend, "process_batch_async", broken)
    with pytest.raises(type(exc)):
        mc.correct_file(tif, chunk_size=8)
    assert len(calls) == 1 and mc._robustness.device_retries == 0
    assert mc._robustness.backend_failovers == 0 and mc._failover_backend is None


@pytest.mark.parametrize("how", ["missing", "eio"])
def test_kernel_source_read_failure_is_a_build_fault(tmp_path, monkeypatch, how):
    """`load` reads the kernel's sources to name its library; an OSError
    there surfaces as a RuntimeError like any other build fault."""
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    if how == "missing":
        monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    else:
        def eio(self):
            raise OSError(errno.EIO, "Input/output error", str(self))

        monkeypatch.setattr(type(cuda_build.CSRC), "read_bytes", eio)
    with pytest.raises(RuntimeError, match="cannot build or load"):
        cuda_build.load("warp")


def test_kernel_load_failure_is_not_an_io_error(tmp_path, monkeypatch):
    """An OSError loading a kernel library surfaces as a RuntimeError, so
    the ladder never retries or fails over a build fault."""
    bogus = tmp_path / "not_a_library.so"
    bogus.write_bytes(b"\0" * 64)
    monkeypatch.setattr(cuda_build, "target", lambda name: bogus)
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="cannot build or load"):
        cuda_build.load("warp")
    assert not tfaults.classify_transient(RuntimeError("cannot build or load"))
