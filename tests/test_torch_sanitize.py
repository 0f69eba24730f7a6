"""The port's runtime concurrency sanitizer (kcmc_tpu_torch/analysis/
sanitize.py), on the cases of the reference's tests/test_sanitize.py:

* instrumented locks: creation-site identity, order-edge recording,
  cycle conviction, RLock reentrancy and the Condition alias, wait and
  reacquire;
* the deadlock watchdog and the leak checker (threads, the port's
  telemetry path claims, the port's shared decode pools exempt by
  ownership);
* `disable` restoring the factories, the `stats` shape, `main`
  wrapping a command;
* the port's AsyncBatchWriter, heartbeat and a whole `correct_file`
  run (upload worker, prefetch thread, writer) sanitize-clean and
  leak-free, and the serve scheduler under concurrent stats() probes;
* the static lock-order graph: one executed order against a written
  reverse order is convicted, and `enable()` merges the port's own
  graph (non-empty, keyed by the port's lock definition sites);
* `KCMC_SANITIZE=1` arming the sanitizer through the CLI's `main`.

Every test arms and disarms the sanitizer itself.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest
import torch

from kcmc_tpu_torch.analysis import sanitize


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def san():
    owned = not sanitize.active()
    if owned:
        sanitize.enable(watchdog_s=0.3, static=False)
    yield sanitize
    sanitize.take_violations()
    if owned:
        sanitize.disable()


def test_lock_order_cycle_is_a_violation(san):
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    v = san.take_violations()
    assert v and "lock-order violation" in v[0], v
    assert "test_torch_sanitize.py" in v[0]


def test_consistent_order_is_quiet(san):
    a = threading.Lock()
    b = threading.Lock()
    for _ in range(3):
        with a:
            with b:
                pass
    assert san.take_violations() == []


def test_strict_mode_raises_and_releases(san):
    st = sanitize._STATE
    a = threading.Lock()
    b = threading.Lock()  # a lock's identity is its creation line
    with a:
        with b:
            pass
    st.strict = True
    try:
        with b:
            with pytest.raises(RuntimeError, match="lock-order violation"):
                a.acquire()
        assert not a.locked() and not b.locked()
    finally:
        st.strict = False
    assert san.take_violations()


def test_rlock_reentrancy_and_condition_alias_are_quiet(san):
    lock = threading.RLock()
    cond = threading.Condition(lock)
    with lock:
        with cond:  # same identity: no self-edge
            cond.notify_all()
    assert cond.site == lock.site
    assert san.take_violations() == []


def test_condition_wait_releases_and_reacquires(san):
    lock = threading.RLock()
    cond = threading.Condition(lock)
    hits = []

    def waiter():
        with cond:
            hits.append("waiting")
            cond.wait(timeout=5.0)
            hits.append("woke")

    t = threading.Thread(target=waiter, name="kcmc-test-waiter")
    t.start()
    for _ in range(100):
        if hits:
            break
        time.sleep(0.01)
    with cond:  # must be acquirable while the waiter waits
        cond.notify_all()
    t.join(timeout=5.0)
    assert hits == ["waiting", "woke"]
    assert san.take_violations() == []


def test_watchdog_dumps_on_held_lock_with_waiters(san, capsys):
    st = sanitize._STATE
    old_ws = st.watchdog_s
    st.stop_watchdog()
    st.watchdog_s = 0.3
    st.start_watchdog()
    lock = threading.Lock()

    def hold():
        with lock:
            time.sleep(0.9)

    t = threading.Thread(target=hold, name="kcmc-test-holder")
    t.start()
    time.sleep(0.1)

    def want():
        with lock:
            pass

    t2 = threading.Thread(target=want, name="kcmc-test-waiter")
    t2.start()
    t.join(timeout=5.0)
    t2.join(timeout=5.0)
    v = san.take_violations()
    st.stop_watchdog()
    st.watchdog_s = old_ws
    st.start_watchdog()
    assert any("deadlock suspect" in x for x in v), v
    assert "all-thread stack dump" in capsys.readouterr().err


def test_leak_checker_catches_thread_and_path_claim(san):
    from kcmc_tpu_torch.obs import run as obs_run

    before = san.leak_snapshot()
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="kcmc-test-leaky", daemon=True)
    t.start()
    claimed = obs_run._claim_path("/tmp/kcmc-sanitize-leak.jsonl", "rX")
    leaks = san.check_leaks(before, grace_s=0.1)
    try:
        assert any("kcmc-test-leaky" in x for x in leaks), leaks
        assert any("kcmc-sanitize-leak" in x for x in leaks), leaks
    finally:
        obs_run._release_path(claimed)
        stop.set()
        t.join(timeout=5.0)
    assert san.check_leaks(before, grace_s=0.5) == []


def test_leak_checker_exempts_the_ports_shared_pools_by_ownership(san):
    """The shared decode pools of kcmc_tpu_torch.io.feeder are read by
    module name: their worker threads are exempt by ownership even when
    their names are not the exempt prefixes."""
    from kcmc_tpu_torch.io import feeder

    before = san.leak_snapshot()
    pool = feeder.shared_pool("thread", 2)
    assert pool._ex.submit(lambda: 7).result(timeout=10) == 7
    owned = {t.ident for t in pool._ex._threads}
    assert owned and owned <= sanitize._shared_pool_threads()
    old = sanitize.LEAK_EXEMPT_THREADS
    try:
        sanitize.LEAK_EXEMPT_THREADS = ()  # ownership alone exempts them
        assert sanitize.check_leaks(before, grace_s=0.1) == []
    finally:
        sanitize.LEAK_EXEMPT_THREADS = old


def test_disable_restores_threading_factories():
    if sanitize.active():
        pytest.skip("the sanitizer is armed for this whole process")
    sanitize.enable(watchdog_s=0.0, static=False)
    assert threading.Lock is sanitize._lock_factory
    assert hasattr(threading.Lock(), "site")
    sanitize.disable()
    assert threading.Lock is sanitize._REAL_LOCK
    assert threading.RLock is sanitize._REAL_RLOCK
    assert threading.Condition is sanitize._REAL_CONDITION
    assert not hasattr(threading.Lock(), "site")
    assert sanitize.stats() == {"active": False}


def test_stats_shape(san):
    lock = threading.Lock()
    with lock:
        pass
    s = san.stats()
    assert s["active"] is True
    assert s["locks_instrumented"] >= 1
    assert s["acquisitions"] >= 1
    assert set(s) == {"active", "locks_instrumented", "acquisitions", "order_edges",
                      "static_edges", "violations"}


def test_main_wraps_a_command(monkeypatch):
    calls = {}

    def fake_call(cmd, env=None):
        calls["cmd"], calls["env"] = cmd, env
        return 0

    import subprocess
    import sys

    monkeypatch.setattr(subprocess, "call", fake_call)
    rc = sanitize.main(["--watchdog", "2", "--strict", "pytest", "tests/x.py", "-q"])
    assert rc == 0
    assert calls["env"]["KCMC_SANITIZE"] == "1"
    assert calls["env"]["KCMC_SANITIZE_WATCHDOG"] == "2.0"
    assert calls["env"]["KCMC_SANITIZE_STRICT"] == "1"
    assert calls["cmd"][:3] == [sys.executable, "-m", "pytest"]
    assert "--sanitize" not in calls["cmd"] and "tests/x.py" in calls["cmd"]
    with pytest.raises(SystemExit) as e:
        sanitize.main(["--"])
    assert e.value.code == 2


def test_static_graph_convicts_single_executed_order(san):
    """One executed order + the static reverse edge = violation, no
    unlucky interleaving required (the reference's case)."""
    a = threading.Lock()
    b = threading.Lock()
    # inject the static edge a->b (as static_order_edges would for a
    # written `with self._a: with self._b:` nesting)
    st = sanitize._STATE
    st.static_edges.add((a.site, b.site))
    with b:  # runtime executes ONLY the reverse order
        with a:
            pass
    v = san.take_violations()
    assert v and "lock-order violation" in v[0], v


def test_enable_merges_the_ports_static_graph(monkeypatch, capsys):
    """`static_order_edges()` over the port is non-empty and keyed by
    the port's lock DEFINITION sites (a `threading.Lock/RLock/Condition`
    constructor on that line of that file); `enable()` merges exactly
    it, with no runtime-only fallback line."""
    if sanitize.active():
        pytest.skip("the sanitizer is armed for this whole process")
    seen = {}
    real = sanitize.static_order_edges
    monkeypatch.setattr(sanitize, "static_order_edges",
                        lambda root=None: seen.setdefault("edges", real(root)))
    sanitize.enable(watchdog_s=0.0)
    try:
        err = capsys.readouterr().err
        assert "static lock-order graph unavailable" not in err
        edges = seen["edges"]
        assert edges and sanitize.stats()["static_edges"] == len(edges)
    finally:
        sanitize.disable()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for site in {s for e in edges for s in e}:
        path, line = site
        assert path.startswith("kcmc_tpu_torch/"), site
        with open(os.path.join(repo, path), encoding="utf-8") as f:
            src = f.read().splitlines()[line - 1]
        assert any(c in src for c in ("Lock(", "RLock(", "Condition(")), (site, src)


def test_env_arms_the_sanitizer_through_the_cli(monkeypatch, tmp_path, capsys):
    if sanitize.active():
        pytest.skip("the sanitizer is armed for this whole process")
    from kcmc_tpu_torch.__main__ import main
    from kcmc_tpu_torch.io import write_stack
    from kcmc_tpu_torch.obs import log as tlog

    path = str(tmp_path / "s.tif")
    write_stack(path, np.zeros((2, 8, 8), np.uint16))
    monkeypatch.setenv("KCMC_SANITIZE", "1")
    monkeypatch.setenv("KCMC_SANITIZE_STATIC", "0")
    monkeypatch.setenv("KCMC_SANITIZE_WATCHDOG", "0")
    try:
        assert main(["info", path]) == 0
        assert sanitize.active()
        assert sanitize._STATE.watchdog_s == 0.0 and not sanitize._STATE.strict
    finally:
        sanitize.disable()
        tlog.reset_cli_logging()
    assert '"n_frames": 2' in capsys.readouterr().out
    monkeypatch.setenv("KCMC_SANITIZE", "0")
    assert not sanitize.maybe_enable_from_env() and not sanitize.active()


def test_take_violations_drains_the_retrace_sentinel_too(san):
    with sanitize.retrace_sentinel(label="t"):
        sanitize.note_compile("register", (64, 64), "float32")
    a = threading.Lock()
    b = threading.Lock()
    with a, b:
        pass
    with b, a:
        pass
    v = san.take_violations()
    assert len(v) == 2 and "retrace sentinel [t]" in v[0] and "lock-order" in v[1]


# -- the port's threads run sanitize-clean -----------------------------------


def test_async_writer_cross_thread_paths_sanitize_clean(san):
    from kcmc_tpu_torch.io.async_writer import AsyncBatchWriter

    class SlowWriter:
        n_pages = 0

        def __init__(self):
            self.batches = []
            self.fail_after = None

        def append_batch(self, frames, n_threads=0):
            time.sleep(0.001)
            if self.fail_after is not None and len(self.batches) >= self.fail_after:
                raise RuntimeError("disk full")
            self.batches.append(frames)

        def checkpoint_state(self):
            return {"pages": len(self.batches)}

        def close(self):
            pass

    w = AsyncBatchWriter(SlowWriter(), depth=2)
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            w.stats()
            time.sleep(0.0005)

    rt = threading.Thread(target=reader, name="kcmc-test-stats")
    rt.start()
    for i in range(20):
        w.append_batch([i])
    w.flush()
    stop.set()
    rt.join(timeout=5.0)
    assert w.stats()["batches"] == 20
    w.close()

    # exactly-once error surfacing across two racing closers
    inner = SlowWriter()
    inner.fail_after = 0
    w2 = AsyncBatchWriter(inner, depth=1)
    w2.append_batch([1])
    time.sleep(0.1)
    raised = []

    def closer():
        try:
            w2.close()
        except RuntimeError as e:
            raised.append(e)

    ts = [threading.Thread(target=closer, name=f"kcmc-test-closer-{i}") for i in range(2)]
    [t.start() for t in ts]
    [t.join(5.0) for t in ts]
    assert len(raised) == 1, raised
    assert san.take_violations() == []


def test_heartbeat_cross_thread_start_stop_sanitize_clean(san):
    from kcmc_tpu_torch.obs.heartbeat import Heartbeat

    beats = []
    hb = Heartbeat(0.01, lambda: "tick", emit=beats.append)
    assert hasattr(hb._lifecycle, "site")  # built while armed: instrumented
    hb.start()
    time.sleep(0.05)
    stopper = threading.Thread(target=hb.stop, name="kcmc-test-stopper")
    stopper.start()
    stopper.join(timeout=5.0)
    assert not hb.running
    assert beats
    assert san.take_violations() == []


def test_correct_file_run_sanitize_clean_and_leak_free(san, tmp_path):
    """A whole streaming run with telemetry armed — the upload worker,
    the prefetch thread, the background writer, the records writer —
    records no violation and leaves no thread, socket or path claim."""
    from kcmc_tpu_torch import MotionCorrector
    from kcmc_tpu_torch.io import read_stack, write_stack
    from kcmc_tpu_torch.utils.synthetic import make_drift_stack

    d = make_drift_stack(12, (48, 48), seed=0)
    src = str(tmp_path / "in.tif")
    write_stack(src, np.clip(d.stack * 40000, 0, 65535).astype(np.uint16))
    before = san.leak_snapshot()
    mc = MotionCorrector(device="cpu", batch_size=4, max_keypoints=64,
                         frame_records_path=str(tmp_path / "r.jsonl"))
    res = mc.correct_file(src, output=str(tmp_path / "out.tif"), chunk_size=4)
    assert read_stack(tmp_path / "out.tif").shape == (12, 48, 48)
    assert res.timing["pipeline"]["upload_overlap"]
    assert san.stats()["locks_instrumented"] > 0
    assert san.take_violations() == []
    assert san.check_leaks(before) == []


def test_scheduler_stats_under_concurrent_load_sanitize_clean(san):
    """The reference's scheduler case: drive the port's StreamScheduler
    on the CPU with a client while another thread hammers stats() and
    snapshot(); no order violation."""
    from kcmc_tpu_torch import MotionCorrector
    from kcmc_tpu_torch.serve.scheduler import StreamScheduler

    mc = MotionCorrector(device="cpu", batch_size=4, max_keypoints=32, n_hypotheses=16)
    frames = np.random.default_rng(0).random((12, 32, 32), np.float32)
    with StreamScheduler(mc) as sched:
        stop = threading.Event()

        def prober():
            while not stop.is_set():
                assert sched.stats()["batch_size"] == 4
                sched.snapshot()
                time.sleep(0.001)

        pt = threading.Thread(target=prober, name="kcmc-test-prober")
        pt.start()
        sess = sched.open_session(tenant="t")
        for lo in range(0, len(frames), 3):
            sched.submit(sess.sid, frames[lo:lo + 3])
        res = sched.close_session(sess.sid, timeout=60.0)
        stop.set()
        pt.join(timeout=5.0)
        assert res.transforms is not None and len(res.transforms) == 12
    assert san.take_violations() == []
