"""The port's resident serve plane (kcmc_tpu_torch/serve/, obs/slo.py,
`python -m kcmc_tpu_torch serve`) on the CPU, held against the port's
one-shot runs and against the JAX package's serve plane
(kcmc_tpu/serve/) on 48x48 and 64x64 translation streams, batch 8,
K=128:

* scheduler parity (tests/test_serve_parity.py's cases): two concurrent
  sessions with an uneven interleave, and a session that closes mid-
  window, equal to the port's one-shot `correct()` within 1e-4 px with
  integers equal; the same two streams through the JAX package's
  `StreamScheduler(MotionCorrector(backend="jax"))` (the one
  `backend="jax"` run of this file) within 1e-3 px and +-2 inliers;
* the wire both ways: the port's ServeClient against the JAX package's
  ServeServer over `backend="numpy"`, and the JAX package's client
  against the port's server;
* journals: a stopped scheduler journals and a new one resumes to the
  uninterrupted transforms; a journal of the other package's backend
  is refused with the reference's message, both ways;
* load: the degraded rung engaging before a 429 `OverloadedError`, and
  the registration-only dispatch (no corrected download);
* observability: the `metrics` and `trace` verbs, the SLO gauges with
  `slo_objectives`, `render_prometheus` of a live scrape, the CLI's
  `metrics` / `trace` against a live server;
* the `serve` subcommand as a child (ready line, one session, SIGTERM,
  the `served` record and exit 0), and no thread left after `stop()`.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu.serve.client import ServeClient as JClient
from kcmc_tpu.serve.scheduler import StreamScheduler as JScheduler
from kcmc_tpu.serve.server import ServeServer as JServer
from kcmc_tpu_torch.obs.latency import render_prometheus
from kcmc_tpu_torch.serve.client import ServeClient
from kcmc_tpu_torch.serve.journal import journal_path
from kcmc_tpu_torch.serve.scheduler import OverloadedError, StreamScheduler
from kcmc_tpu_torch.serve.server import ServeServer
from kcmc_tpu_torch.utils.synthetic import make_drift_stack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
KW = dict(model="translation", batch_size=8, max_keypoints=128, n_hypotheses=32)
LIFECYCLE = {
    "request.admission", "request.queue_wait", "request.batch_form",
    "request.dispatch", "request.device", "request.drain",
    "request.delivery", "request.total",
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(n, seed=0, shape=(48, 48)):
    d = make_drift_stack(n, shape, model="translation", max_drift=3.0, seed=seed)
    return d.stack.astype(np.float32)


def _port(**kw):
    return kcmc_tpu_torch.MotionCorrector(device="cpu", **KW, **kw)


def _numpy(**kw):
    return kcmc_tpu.MotionCorrector(backend="numpy", **KW, **kw)


@pytest.fixture(scope="module")
def streams():
    """Two 64x64 streams (8-11 inliers a frame: the 48x48 scene has
    two, where the JAX backend's polish and the port's part by 1/16 px
    on the reference frame itself) and the port's one-shot runs."""
    s1, s2 = _stack(20, seed=0, shape=(64, 64)), _stack(14, seed=1, shape=(64, 64))
    return {"s1": s1, "s2": s2, "t1": _port().correct(s1), "t2": _port().correct(s2)}


def _assert_close(res, truth, tol=TOL):
    assert np.abs(res.transforms - truth.transforms).max() < tol
    for key in ("n_inliers", "n_matches"):
        np.testing.assert_array_equal(res.diagnostics[key], truth.diagnostics[key])


def _interleaved(sched, s1, s2):
    """Submit sizes unrelated to the batch size, alternating streams."""
    a = sched.open_session(tenant="A")
    b = sched.open_session(tenant="B")
    sched.submit(a.sid, s1[:7])
    sched.submit(b.sid, s2[:3])
    sched.submit(a.sid, s1[7:9])
    sched.submit(b.sid, s2[3:14])
    sched.submit(a.sid, s1[9:20])
    return (sched.close_session(a.sid, timeout=180), sched.close_session(b.sid, timeout=180))


@pytest.fixture(scope="module")
def port_pair(streams):
    sched = StreamScheduler(_port()).start()
    try:
        return _interleaved(sched, streams["s1"], streams["s2"])
    finally:
        sched.stop()


# -- scheduler parity ---------------------------------------------------------


@pytest.mark.parametrize("which", ["A", "B"])
def test_two_concurrent_sessions_match_oneshot(streams, port_pair, which):
    res = port_pair[0] if which == "A" else port_pair[1]
    _assert_close(res, streams["t1"] if which == "A" else streams["t2"])
    assert res.timing["n_frames"] == (20 if which == "A" else 14)


def test_session_closing_mid_window_leaves_other_stream_exact():
    s1, s2 = _stack(9, seed=2), _stack(24, seed=3)
    t1, t2 = _port().correct(s1), _port().correct(s2)
    sched = StreamScheduler(_port()).start()
    try:
        a = sched.open_session(tenant="closer")
        b = sched.open_session(tenant="survivor")
        sched.submit(b.sid, s2[:16])
        sched.submit(a.sid, s1)  # one full batch and a padded tail
        ra = sched.close_session(a.sid, timeout=180)  # closes mid-traffic
        sched.submit(b.sid, s2[16:])
        rb = sched.close_session(b.sid, timeout=180)
    finally:
        sched.stop()
    assert ra.timing["n_frames"] == 9
    _assert_close(ra, t1)
    _assert_close(rb, t2)


def test_emit_session_pixels_and_explicit_reference_match_oneshot():
    """An emitting session returns the one-shot run's corrected frames;
    an explicit reference equals a one-shot run against it."""
    stack = _stack(12, seed=5)
    truth = _port().correct(stack)
    ref_truth = _port(reference=stack[3]).correct(stack)
    sched = StreamScheduler(_port()).start()
    try:
        s = sched.open_session(tenant="pix", emit_frames=True)
        r = sched.open_session(tenant="ref", reference=stack[3])
        sched.submit(s.sid, stack)
        sched.submit(r.sid, stack)
        res = sched.close_session(s.sid, timeout=180)
        rres = sched.close_session(r.sid, timeout=180)
    finally:
        sched.stop()
    assert res.corrected.shape == truth.corrected.shape
    assert np.abs(res.corrected - truth.corrected).max() < TOL
    _assert_close(rres, ref_truth)


def test_rolling_template_stream_matches_oneshot():
    stack = _stack(32, seed=4)
    truth = _port(template_update_every=16).correct(stack)
    sched = StreamScheduler(_port(template_update_every=16)).start()
    try:
        s = sched.open_session(tenant="roll")
        for lo in range(0, 32, 5):  # submit size coprime with E and B
            sched.submit(s.sid, stack[lo:lo + 5])
        res = sched.close_session(s.sid, timeout=180)
    finally:
        sched.stop()
    assert np.abs(res.transforms - truth.transforms).max() < TOL


def test_same_streams_through_the_jax_scheduler(streams, port_pair):
    """The JAX package's scheduler over backend="jax" on the same
    interleave: the port within 1e-3 px and +-2 inliers of it, the
    tolerance the port holds against backend="jax" one-shot runs."""
    sched = JScheduler(kcmc_tpu.MotionCorrector(backend="jax", **KW)).start()
    try:
        want = _interleaved(sched, streams["s1"], streams["s2"])
    finally:
        sched.stop()
    for got, ref in zip(port_pair, want):
        assert np.abs(got.transforms - ref.transforms).max() < 1e-3
        gap = np.abs(got.diagnostics["n_inliers"].astype(int)
                     - ref.diagnostics["n_inliers"].astype(int))
        assert gap.max() <= 2
        assert got.timing["n_frames"] == ref.timing["n_frames"]


# -- the wire, both ways -------------------------------------------------------


def _wire_session(client, stack):
    """open, two submits, results until drained, close, stats."""
    sid = client.open_session(tenant="wire")
    client.submit(sid, stack[:5])
    client.submit(sid, stack[5:])
    seen = []
    while sum(len(s["transform"]) for s in seen) < len(stack):
        span = client.results(sid, timeout=60.0)
        assert span is not None
        seen.append(span)
    final = client.close_session(sid)
    assert [s["first_frame"] for s in seen] == list(
        np.cumsum([0] + [s["n"] for s in seen[:-1]]))
    return np.concatenate([s["transform"] for s in seen]), final, client.stats()


def test_port_client_against_reference_numpy_server():
    stack = _stack(12, seed=6)
    truth = _numpy().correct(stack)
    with JServer(_numpy(), port=0) as srv, ServeClient(port=srv.port) as c:
        spans, final, st = _wire_session(c, stack)
    np.testing.assert_array_equal(final["transforms"], truth.transforms)
    np.testing.assert_array_equal(spans, truth.transforms)
    np.testing.assert_array_equal(final["diagnostics"]["n_inliers"],
                                  truth.diagnostics["n_inliers"])
    assert final["frames"] == 12 and st["frames_done"] == 12


def test_reference_client_against_port_server():
    stack = _stack(12, seed=6)
    truth = _port().correct(stack)
    with ServeServer(_port(), port=0) as srv, JClient(port=srv.port) as c:
        spans, final, st = _wire_session(c, stack)
        assert c.ping()
    np.testing.assert_array_equal(final["transforms"], truth.transforms)
    np.testing.assert_array_equal(spans, truth.transforms)
    np.testing.assert_array_equal(final["diagnostics"]["n_inliers"],
                                  truth.diagnostics["n_inliers"])
    assert final["frames"] == 12 and st["frames_done"] == 12
    assert final["timing"]["n_frames"] == 12


def test_wire_format_is_the_references():
    from kcmc_tpu.serve import proto as jproto
    from kcmc_tpu_torch.serve import proto as tproto

    arr = np.arange(24, dtype=np.uint16).reshape(2, 3, 4)
    d = {"a": arr, "b": np.float32(2.5), "c": "x"}
    assert tproto.encode_arrays(d) == jproto.encode_arrays(d)
    got = tproto.decode_arrays(jproto.encode_arrays(d))
    np.testing.assert_array_equal(got["a"], arr)
    assert got["a"].dtype == arr.dtype and tproto.MAX_LINE == jproto.MAX_LINE


# -- journals ------------------------------------------------------------------


def _wait_done(sched, sess, n, timeout=60.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        with sched._lock:
            if sess.done >= n:
                return
        time.sleep(0.02)
    raise AssertionError(f"session never drained {n} frames")


def _journal_of(make_sched, mc, stack, jdir, sid="J1"):
    sched = make_sched(mc).start()
    s = sched.open_session(tenant="t", session_id=sid)
    sched.submit(s.sid, stack[:14], first=0)
    _wait_done(sched, s, 14)
    sched.stop()  # graceful drain: journals, then fails the open stream
    assert os.path.exists(journal_path(str(jdir), sid))


def test_scheduler_stop_journals_and_resume_is_exact(tmp_path):
    stack = _stack(24, seed=2)
    truth = _port().correct(stack)
    kw = dict(serve_journal_dir=str(tmp_path), serve_journal_every=4)
    _journal_of(StreamScheduler, _port(**kw), stack, tmp_path)
    sched = StreamScheduler(_port(**kw)).start()
    try:
        sess, cursor, resumed = sched.resume_session("J1")
        assert resumed and cursor == 14
        d = sched.submit("J1", stack[10:], first=10)  # replay before the cursor
        assert d["deduped"] == 4 and d["accepted"] == 10
        res = sched.close_session("J1", timeout=120)
        st = sched.stats()
    finally:
        sched.stop()
    assert res.timing["n_frames"] == 24
    assert np.abs(res.transforms - truth.transforms).max() < TOL
    assert res.timing["robustness"]["resumed_from_frame"] == 14
    assert st["resilience"]["sessions_resumed"] == 1
    assert not os.path.exists(journal_path(str(tmp_path), "J1"))


@pytest.mark.parametrize("writer", ["numpy", "torch"])
def test_journal_of_the_other_backend_is_refused(tmp_path, writer):
    """A journal the JAX package wrote (backend "numpy") is refused by
    the port's server, and the port's ("torch") by the JAX package's,
    with the reference's message."""
    stack = _stack(16, seed=7)
    kw = dict(serve_journal_dir=str(tmp_path), serve_journal_every=4)
    ports = (StreamScheduler, _port(**kw))
    refs = (JScheduler, _numpy(**kw))
    (wsched, wmc), (rsched, rmc) = (refs, ports) if writer == "numpy" else (ports, refs)
    _journal_of(wsched, wmc, stack, tmp_path)
    reader = "torch" if writer == "numpy" else "numpy"
    sched = rsched(rmc).start()
    try:
        with pytest.raises(ValueError) as e:
            sched.resume_session("J1")
    finally:
        sched.stop()
    assert str(e.value) == (
        f"session 'J1' was journaled on backend {writer!r}; this server runs "
        f"{reader!r} — restart with the original backend to resume it")


# -- load ----------------------------------------------------------------------


def test_degrade_engages_before_rejection():
    sched = StreamScheduler(_port(serve_queue_depth=12, serve_degrade_watermark=0.5)).start()
    try:
        stack = _stack(16)
        s = sched.open_session(tenant="hot")
        with pytest.warns(RuntimeWarning, match="degraded consensus"):
            dec = sched.submit(s.sid, stack[:12])  # past the 50% watermark
        assert dec["degraded"] is True
        with pytest.raises(OverloadedError) as ei:
            sched.submit(s.sid, stack[:13])
        assert ei.value.code == 429
        st = sched.stats()
        assert st["admission"]["degrade_events"] == 1
        assert st["admission"]["rejected_submits"] == 1
        assert st["admission"]["rejected_frames"] == 13
        res = sched.close_session(s.sid, timeout=120)
        assert res.timing["n_frames"] == 12
        st = sched.stats()
        assert st["admission"]["degraded_batches"] >= 1
        db = sched._degraded_backend
        assert isinstance(db, kcmc_tpu_torch.backends.torch_backend.TorchBackend)
        assert db._plan.rung == "degraded" and db.config.transform_polish == 0
        assert db.config.n_hypotheses == 16 and db.device == sched.mc.backend.device
    finally:
        sched.stop()


def test_registration_only_sessions_download_no_frames(monkeypatch):
    """A session that wants no pixels dispatches with emit_frames=False
    (no corrected download starts), an emitting one with True."""
    seen = []
    orig = kcmc_tpu_torch.backends.torch_backend.TorchBackend.process_batch_async

    def spy(self, *a, **k):
        out = orig(self, *a, **k)
        seen.append((k.get("emit_frames"), sorted(out.download.bufs)))
        return out

    monkeypatch.setattr(kcmc_tpu_torch.backends.torch_backend.TorchBackend,
                        "process_batch_async", spy)
    stack = _stack(8, seed=8)
    sched = StreamScheduler(_port(serve_degrade_watermark=1.0)).start()
    try:
        a = sched.open_session(tenant="reg")
        sched.submit(a.sid, stack)
        ra = sched.close_session(a.sid, timeout=120)
        b = sched.open_session(tenant="pix", emit_frames=True)
        sched.submit(b.sid, stack)
        rb = sched.close_session(b.sid, timeout=120)
    finally:
        sched.stop()
    assert [s[0] for s in seen] == [False, True]
    assert "corrected" not in seen[0][1] and "corrected" in seen[1][1]
    assert len(ra.corrected) == 0 and rb.corrected.shape == stack.shape
    np.testing.assert_array_equal(ra.transforms, rb.transforms)


# -- the supervisor and the ladder ----------------------------------------------


def _fail_primary_once(monkeypatch, exc):
    """The first dispatch raises `exc`, as a kernel build or launch
    failure would on the card (the callers run without the degraded
    rung, so it is the primary backend's)."""
    cls = kcmc_tpu_torch.backends.torch_backend.TorchBackend
    orig = cls.process_batch_async
    fired = []

    def flaky(self, *a, **k):
        if not fired:
            fired.append(self)
            raise exc
        return orig(self, *a, **k)

    monkeypatch.setattr(cls, "process_batch_async", flaky)
    return fired


@pytest.mark.parametrize("failover", ["numpy", None])
@pytest.mark.parametrize("how", ["injected", "build_error"])
def test_fatal_dispatch_error_fails_the_stream(monkeypatch, how, failover):
    """A fatal dispatch error — an injected fatal device fault, or a
    kernel library that cannot be built — reaches the stream's result
    (and a CLI run's exit code) with or without a failover rung: the
    batch never reruns on the CPU and the backend is not quarantined;
    a stream opened after a one-off build error runs on the card's
    backend as before."""
    from kcmc_tpu_torch.utils.faults import FatalFaultError

    kw = {"serve_degrade_watermark": 1.0, "failover_backend": failover}
    if how == "injected":
        kw["fault_plan"] = "device:step=1:fatal"
        raises = dict(expected_exception=FatalFaultError)
    else:
        _fail_primary_once(monkeypatch, RuntimeError("cannot build or load detect.so"))
        raises = dict(expected_exception=RuntimeError, match="cannot build or load detect.so")
    stack = _stack(16, seed=5)
    sched = StreamScheduler(_port(**kw)).start()
    try:
        s = sched.open_session(tenant="fatal")
        sched.submit(s.sid, stack, first=0)
        with pytest.raises(**raises):
            sched.close_session(s.sid, timeout=120)
        if how == "build_error":
            after = sched.open_session(tenant="after")
            sched.submit(after.sid, stack, first=0)
            res = sched.close_session(after.sid, timeout=120)
        st = sched.stats()
    finally:
        sched.stop()
    assert st["supervisor"]["backend_rebuilds"] == 0
    if how == "build_error":
        truth = _port().correct(stack)
        assert res.timing["robustness"]["backend_failovers"] == 0
        assert np.abs(res.transforms - truth.transforms).max() < TOL


def test_transient_strikes_quarantine_and_rebuild():
    """Transient faults walk the ladder (retried on the card's backend)
    and strike the supervisor: at the strike limit it quarantines the
    backend, rebuilds it off the request path and swaps it in, with the
    stream's transforms unchanged."""
    stack = _stack(24, seed=6)
    truth = _port().correct(stack)
    sched = StreamScheduler(_port(fault_plan="device:times=2:transient",
                                  retry_backoff_s=0.001, serve_backend_strikes=1)).start()
    first = sched.mc.backend
    try:
        s = sched.open_session(tenant="strikes")
        with pytest.warns(RuntimeWarning, match="quarantined after repeated transient"):
            sched.submit(s.sid, stack, first=0)
            res = sched.close_session(s.sid, timeout=120)
        st = sched.stats()
    finally:
        sched.stop()
    assert st["supervisor"]["backend_rebuilds"] == 1 and sched.mc.backend is not first
    rb = res.timing["robustness"]
    assert res.timing["n_frames"] == 24 and rb["device_retries"] >= 1
    assert rb["backend_failovers"] == 0 and rb["failed_frames"] == 0
    assert np.abs(res.transforms - truth.transforms).max() < TOL


# -- observability -------------------------------------------------------------


def _drive(c, n=16, seed=0):
    sid = c.open_session(tenant="obs")
    c.submit(sid, _stack(n, seed=seed))
    seen = 0
    while seen < n:
        got = c.results(sid, timeout=60.0)
        assert got is not None
        seen += got["n"]
    c.close_session(sid)
    return sid


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """One traced, SLO-armed server: its metrics and spans after a
    session, and the CLI's scrape of it."""
    from kcmc_tpu_torch.__main__ import main as tmain
    import contextlib
    import io

    d = tmp_path_factory.mktemp("live")
    mc = _port(trace_shard_dir=str(d), slo_objectives="full:0.000001:0.99;avail:0.999")
    out = {}
    with ServeServer(mc, port=0) as srv:
        with ServeClient(port=srv.port) as c:
            _drive(c)
            out["trace_id"] = c.last_trace["trace_id"]
            out["metrics"] = c.metrics()
            out["spans"] = c.trace_dump()
        for argv in (["metrics", f"127.0.0.1:{srv.port}", "--text"],
                     ["trace", f"127.0.0.1:{srv.port}", "--json"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert tmain(argv) == 0
            out["cli_" + argv[0]] = buf.getvalue()
        from kcmc_tpu_torch.obs import log as tlog

        if tlog.cli_logging_active():
            tlog.reset_cli_logging()
    return out


def test_metrics_verb_reports_every_segment(live):
    m = live["metrics"]
    assert m["schema"] == "kcmc_metrics/1" and m["latency_telemetry"] is True
    segs = m["plane"]["segments"]
    assert LIFECYCLE <= set(segs), sorted(segs)
    assert m["plane"]["totals"]["request.total"]["count"] == 16
    assert m["counters"]["frames_done"] == 16 and m["gauges"]["batch_size"] == 8


def test_slo_gauges_burn_and_render(live):
    slo = live["metrics"]["slo"]
    assert {o["name"] for o in slo["objectives"]} == {"latency_full_lt_1e-06s", "availability"}
    assert slo["burn_rates"]["latency_full_lt_1e-06s"]["5m"] > 1.0
    assert slo["burn_rates"]["availability"]["5m"] == 0.0
    text = render_prometheus(live["metrics"])
    burns = [ln for ln in text.splitlines() if ln.startswith("kcmc_slo_burn_rate{")]
    assert len(burns) == 8
    assert any('window="5m"' in ln and not ln.endswith(" 0") for ln in burns)
    assert "kcmc_slo_target" in text
    from kcmc_tpu.obs.latency import render_prometheus as jrender

    assert text == jrender(live["metrics"])


def test_trace_verb_and_cli_scrapes(live):
    from kcmc_tpu_torch.obs.registry import SPAN_NAMES

    spans = live["spans"]
    names = {s["name"] for s in spans}
    assert {"rpc.server", "request.device", "request.total"} <= names <= set(SPAN_NAMES)
    assert live["trace_id"] in {s.get("trace_id") for s in spans}
    # the CLI scraped the same server: Prometheus text, and the stitched
    # spans of its trace verb
    assert "kcmc_request_latency_seconds_bucket" in live["cli_metrics"]
    assert "kcmc_slo_burn_rate" in live["cli_metrics"]
    summary = json.loads(live["cli_trace"].strip().splitlines()[-1])
    assert summary["kind"] == "kcmc_trace" and summary["n_spans"] >= len(spans)


def test_slo_spec_and_serve_knobs_validated_at_config_time():
    with pytest.raises(ValueError, match="slo_objectives"):
        _port(slo_objectives="full:nope")
    with pytest.raises(ValueError, match="trace_shard_cap"):
        _port(trace_shard_cap=0)
    with pytest.raises(ValueError, match="serve_inflight"):
        _port(serve_inflight=0)


# -- lifecycle -------------------------------------------------------------------


def test_stop_joins_every_thread(tmp_path):
    """Scheduler, degraded and rebuild warm-ups, heartbeat, TCP server:
    nothing of the plane is alive after stop()."""
    before = set(threading.enumerate())
    mc = _port(serve_journal_dir=str(tmp_path), slo_objectives="avail:0.99")
    with ServeServer(mc, port=0, heartbeat_s=0.05) as srv:
        srv.scheduler._spawn_warmup(srv.scheduler._rebuild_backend, "kcmc-serve-backend-rebuild")
        with ServeClient(port=srv.port) as c:
            _drive(c, n=8)
    left = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not left, [t.name for t in left]


def test_kernel_library_builds_once_under_concurrent_threads(tmp_path, monkeypatch):
    """Warm-up threads may reach a library's first build beside the
    scheduler thread: the builds are serialized, one compiler run per
    library, every caller finds it built (a stand-in compiler here)."""
    from kcmc_tpu_torch.ops import cuda_build

    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
                    'sleep 0.2; : > "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(fake))
    cuda_build.set_lib_dir(tmp_path / "libs")
    runs = cuda_build.NVCC_RUNS
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    got, errors = [], []

    def build():
        try:
            got.append(cuda_build.build(["warp", "detect"]))
        except Exception as e:
            errors.append(e)

    try:
        ts = [threading.Thread(target=build) for _ in range(2 * (os.cpu_count() or 4))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
        cuda_build.set_lib_dir(None)
    assert not errors and not any(t.is_alive() for t in ts)
    assert cuda_build.NVCC_RUNS - runs == 2
    assert sum(not g["warp"]["cached"] for g in got) == 1
    assert all(p.suffix == ".so" for p in (tmp_path / "libs").iterdir())


def test_serve_subcommand_child_ready_metrics_and_sigterm(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    p = subprocess.Popen(
        [sys.executable, "-m", "kcmc_tpu_torch", "--device", "cpu", "serve", "--port", "0",
         "--batch-size", "8", "--max-keypoints", "128", "--hypotheses", "32"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(tmp_path))
    try:
        ready = json.loads(p.stdout.readline())
        assert ready["serving"] is True and ready["backend"] == "torch"
        assert ready["batch_size"] == 8 and ready["port"] > 0
        stack = _stack(8, seed=9)
        with ServeClient(port=ready["port"]) as c:
            sid = c.open_session()
            c.submit(sid, stack)
            final = c.close_session(sid)
        np.testing.assert_array_equal(final["transforms"], _port().correct(stack).transforms)
        m = subprocess.run([sys.executable, "-m", "kcmc_tpu_torch", "metrics",
                            f"127.0.0.1:{ready['port']}"], capture_output=True, text=True,
                           env=env, timeout=60)
        assert m.returncode == 0, m.stderr
        assert json.loads(m.stdout)["counters"]["frames_done"] == 8
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode == 0, err[-2000:]
    served = json.loads(out.strip().splitlines()[-1])
    assert served["served"] is True and served["stats"]["frames_done"] == 8
