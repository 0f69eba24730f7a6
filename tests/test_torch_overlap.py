"""The port's pipelined dispatch (`upload_overlap`) on the CPU, against
its serial upload and against kcmc_tpu's pipeline report.

With the overlap on, the upload worker stages the next batch through
the backend's staging ring while the current one runs; the outputs must
be byte-identical to `upload_overlap=False` on an uneven tail, with
rolling templates on either path, on a native uint16 upload and through
a killed and resumed `correct_file`. `timing["pipeline"]` has the
reference's keys and counts on the same stack (one JAX run), no upload
worker outlives a run, a failed staging raises instead of falling back,
and a staging slot is refilled only after its previous copy's event.
"""

from __future__ import annotations

import hashlib
import threading
import traceback
import weakref

import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu_torch.backends.torch_backend import _StagingRing
from kcmc_tpu_torch.io.tiff import write_stack
from kcmc_tpu_torch.utils import synthetic
from kcmc_tpu_torch.utils.faults import FatalFaultError

SHAPE = (64, 64)
T = 30  # 3 x 8 + 6: the tail batch rides a staged slot too
KW = dict(batch_size=8, max_keypoints=128, retry_backoff_s=1e-4, retry_backoff_max_s=2e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# thread -> the stack that started it, for every thread started while
# this file runs (`record_thread_starts`); names the origin of a
# `kcmc-upload` thread that outlives its run
_STARTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@pytest.fixture(scope="module", autouse=True)
def record_thread_starts():
    real = threading.Thread.start

    def start(self):
        _STARTS[self] = "".join(traceback.format_stack()[:-1])
        return real(self)

    threading.Thread.start = start
    yield
    threading.Thread.start = real


@pytest.fixture(scope="module")
def data():
    return synthetic.make_drift_stack(n_frames=T, shape=SHAPE, model="translation",
                                      max_drift=4.0, seed=11)


def mk(**kw):
    return kcmc_tpu_torch.MotionCorrector(device="cpu", **{**KW, **kw})


def _same(a, b):
    np.testing.assert_array_equal(a.corrected, b.corrected)
    np.testing.assert_array_equal(a.transforms, b.transforms)
    for k in ("n_inliers", "n_matches", "warp_ok"):
        np.testing.assert_array_equal(a.diagnostics[k], b.diagnostics[k])


def _upload_threads():
    return [t.name for t in threading.enumerate() if t.name.startswith("kcmc-upload")]


def _describe_upload_threads() -> str:
    """Each live `kcmc-upload` thread's name, ident and the stack that
    started it (a thread started before this file ran has none)."""
    out = []
    for t in threading.enumerate():
        if t.name.startswith("kcmc-upload"):
            stack = _STARTS.get(t, "  (started before this file's tests)\n")
            out.append(f"{t.name} ident={t.ident} alive={t.is_alive()} started at:\n{stack}")
    return "\n".join(out)


@pytest.fixture(scope="module")
def serial(data):
    return mk(upload_overlap=False).correct(data.stack)


def test_overlap_byte_identical_across_uneven_tail(data, serial):
    on = mk().correct(data.stack)
    _same(on, serial)
    assert on.timing["pipeline"]["upload_overlap"] is True
    assert on.timing["pipeline"]["upload_waits"] == 3  # every batch after the first


@pytest.mark.parametrize("device_templates", [True, False], ids=["device", "host"])
def test_overlap_byte_identical_with_rolling_templates(data, device_templates):
    kw = dict(template_update_every=10, template_window=6, device_templates=device_templates)
    on = mk(**kw).correct(data.stack)
    off = mk(upload_overlap=False, **kw).correct(data.stack)
    _same(on, off)
    pipe = on.timing["pipeline"]
    # the device path keeps the window in flight across the boundaries
    assert pipe["drain_flushes"] == (1 if device_templates else 3)
    assert pipe["template_updates"] == 2 and pipe["device_templates"] is device_templates


def test_overlap_byte_identical_native_uint16_upload(data):
    """The staged slot carries the native uint16 batch, cast on the
    device, as the inline upload does; the integer output cast too."""
    u16 = np.clip(data.stack * 40000, 0, 65535).astype(np.uint16)
    on = mk().correct(u16, output_dtype="input")
    off = mk(upload_overlap=False).correct(u16, output_dtype="input")
    assert on.corrected.dtype == np.uint16
    _same(on, off)


def _digest(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_correct_file_kill_and_resume_byte_identical(data, tmp_path):
    """A uint16 TIFF killed by a fatal device fault at the fourth batch
    and resumed, both with the overlap on, writes the bytes of an
    uninterrupted serial run; the window (batches 1 and 2) drains before
    the kill raises, so the checkpoint holds the first 24 frames."""
    src = str(tmp_path / "in.tif")
    write_stack(src, np.clip(data.stack * 40000, 0, 65535).astype(np.uint16))
    args = dict(chunk_size=8, checkpoint_every=8)
    full = str(tmp_path / "full.tif")
    ref = mk(upload_overlap=False).correct_file(src, output=full, **args)
    out, ckpt = str(tmp_path / "out.tif"), str(tmp_path / "run.ckpt.npz")
    with pytest.raises(FatalFaultError):
        mk(fault_plan="device:step=3:fatal").correct_file(src, output=out, checkpoint=ckpt,
                                                          **args)
    assert _upload_threads() == [], _describe_upload_threads()
    got = mk().correct_file(src, output=out, checkpoint=ckpt, **args)
    assert got.timing["restored_frames"] == 24
    assert got.timing["pipeline"]["drain_flushes"] == 1  # one batch was left
    assert _digest(out) == _digest(full)
    np.testing.assert_array_equal(got.transforms, ref.transforms)


def test_pipeline_report_matches_reference(data):
    """timing["pipeline"] and the upload_wait stall against kcmc_tpu's on
    the same stack and config: device rolling templates, so the window
    stays in flight across two boundaries (one drain), and every batch
    but the first of each segment waits on a staged upload."""
    kw = dict(model="translation", batch_size=8, max_keypoints=128,
              template_update_every=10, template_window=6)
    want = kcmc_tpu.MotionCorrector(backend="jax", **kw).correct(data.stack)
    got = kcmc_tpu_torch.MotionCorrector(device="cpu", **kw).correct(data.stack)
    assert got.timing["pipeline"] == want.timing["pipeline"]
    assert got.timing["pipeline"] == {"drain_flushes": 1, "template_updates": 2,
                                      "device_templates": True, "upload_overlap": True,
                                      "upload_waits": 3}
    assert "upload_wait" in got.timing["stalls_s"] and "upload_wait" in want.timing["stalls_s"]
    assert got.timing["stall_counts"]["upload_wait"] == want.timing["stall_counts"]["upload_wait"]
    assert np.abs(got.transforms - want.transforms).max() < 1e-3


def test_overlap_off_stays_inline(data, serial):
    pipe = serial.timing["pipeline"]
    assert pipe["upload_overlap"] is False and pipe["upload_waits"] == 0
    assert "upload_wait" not in serial.timing["stalls_s"]
    assert pipe["drain_flushes"] == 1 and "drain_sync" in serial.timing["stalls_s"]


def test_upload_worker_joined_after_run(data):
    mk().correct(data.stack)
    assert _upload_threads() == [], _describe_upload_threads()


def test_failed_staging_raises_and_never_falls_back(data, monkeypatch):
    """An upload that fails on the worker (a refused pinned allocation,
    a failed copy) raises from correct(): no serial fallback, no ladder
    rung, and the worker is joined."""
    mc = mk()
    calls = []

    def broken(frames):
        calls.append(1)
        raise RuntimeError("pinned allocation refused")

    monkeypatch.setattr(mc.backend, "stage_upload", broken)
    with pytest.raises(RuntimeError, match="pinned allocation refused"):
        mc.correct(data.stack)
    assert calls and _upload_threads() == [], _describe_upload_threads()
    assert mc._robustness.device_retries == 0 and mc._failover_backend is None


def test_dropped_slot_after_escalation_uploads_inline():
    """A slot staged for the bounded backend is dropped once the
    escalation replaced it, and that batch uploads inline: fewer staged
    slots are taken than waited on."""
    rng = np.random.default_rng(2)
    scene = synthetic.render_scene(rng, (320, 320), n_blobs=300)
    far = np.eye(3, dtype=np.float32)
    far[:2, 2] = (140.25, 3.5)
    stack = np.stack([scene] * 2 + [synthetic._warp_scene(scene, far)] * 8).astype(np.float32)
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", batch_size=2, max_keypoints=256)
    taken = []
    orig = mc._get_escalation_backend

    def esc():
        b = orig()
        if not hasattr(b, "_spied"):
            b._spied = True
            inner = b.process_batch_async

            def spy(frames, *a, **k):
                taken.append(type(frames).__name__)
                return inner(frames, *a, **k)

            b.process_batch_async = spy
        return b

    mc._get_escalation_backend = esc
    with pytest.warns(RuntimeWarning, match="switching the remaining batches"):
        res = mc.correct(stack)
    assert res.escalated_at == 8
    # batch 4 was staged for the bounded backend: dropped, uploaded inline
    assert taken == ["ndarray"]
    assert res.timing["pipeline"]["upload_waits"] == 4


class _Event:
    def __init__(self):
        self.waited = 0

    def synchronize(self):
        self.waited += 1


def test_staging_slot_refilled_only_after_its_copy_event():
    """The ring hands its slots out in turn; a slot whose copy is still
    recorded waits on that copy's event before it is refilled."""
    ring = _StagingRing(2, pinned=False)
    a = ring.acquire((4, 8), torch.uint16)
    a.event = ev = _Event()
    a.lock.release()
    b = ring.acquire((4, 8), torch.uint16)
    assert b is not a and ev.waited == 0
    b.lock.release()
    again = ring.acquire((4, 8), torch.uint16)
    assert again is a and ev.waited == 1
    again.lock.release()
    # another shape or dtype has its own slots
    other = ring.acquire((4, 8), torch.float32)
    assert other is not a and other is not b
    other.lock.release()
