"""The port's serve fleet (kcmc_tpu_torch/serve/fleet.py, autoscale.py,
router.py, obs/top.py, `python -m kcmc_tpu_torch router` and `top`) on
the CPU, held against the reference's (kcmc_tpu/serve/) on 48x48
translation streams, batch 8, K=64:

* tests/test_serve_fleet.py's cases on the port's modules: the `fleet`
  fault grammar, rendezvous placement (join, leave, rank), the health
  ladder and soft evidence, merge exactness, the wait hint, the `top`
  fleet block, router parity and graceful migration over two in-process
  port servers, admission, the client budget, the autoscaler and the
  config validation;
* against the reference on identical inputs: `rank`/`place` over
  several replica sets, `merge_fleet_metrics` and `predicted_wait_s`
  equal; the wire both ways (the reference's client through the port's
  router, the port's router in front of a reference server);
* the lost-context rule: a replica reporting `device_lost` goes DEAD,
  its other streams (idle, or with batches in flight and queued) are
  released with a 503 and migrate, and the stream whose batch raised
  fails and is never migrated;
* the autoscaler's first decision is free whatever the host's uptime
  (the reference's holds on a host booted less than a cooldown ago);
* one CLI child: `--device cpu router --spawn 2`, a bound replica
  SIGKILLed mid-stream, no lost or duplicated frames, `top --once`,
  SIGTERM to the `routed` record with no replica left.
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
from kcmc_tpu_torch.config import CorrectorConfig
from kcmc_tpu_torch.obs.latency import SegmentLatencies
from kcmc_tpu_torch.serve import scheduler as scheduler_mod
from kcmc_tpu_torch.serve.client import ServeClient, ServeError
from kcmc_tpu_torch.serve.fleet import (
    DEAD,
    HEALTHY,
    SUSPECT,
    Replica,
    ReplicaHealth,
    merge_fleet_metrics,
    place,
    predicted_wait_s,
    rank,
)
from kcmc_tpu_torch.serve.journal import journal_path, load_session_journal
from kcmc_tpu_torch.serve.router import FleetRouter
from kcmc_tpu_torch.serve.server import ServeServer
from kcmc_tpu_torch.utils.faults import FatalFaultError, FaultPlan
from kcmc_tpu_torch.utils.synthetic import make_drift_stack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
KW = dict(model="translation", batch_size=8, max_keypoints=64, n_hypotheses=32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_port_cli_logging():
    """`main` routes the port's advisories through its logger with a
    handler on the captured stderr; undo it after every test."""
    yield
    from kcmc_tpu_torch.obs import log as tlog

    if tlog.cli_logging_active():
        tlog.reset_cli_logging()


def _stack(n=24, seed=0, shape=(48, 48)):
    d = make_drift_stack(n, shape, model="translation", max_drift=3.0, seed=seed)
    return d.stack.astype(np.float32)


def _port(**kw):
    return kcmc_tpu_torch.MotionCorrector(device="cpu", **KW, **kw)


def _truth(stack):
    return _port().correct(stack).transforms


# -- fault grammar: the fleet surface -------------------------------------------


def test_fleet_fault_surface_grammar():
    plan = FaultPlan.from_spec("fleet:step=1:raise, fleet:stall=2")
    plan.maybe_fail("fleet", 0)
    with pytest.raises(FatalFaultError):
        plan.maybe_fail("fleet", 1)
    # stall clauses are consumed (scrape-stall injection)
    assert plan.take_stall("fleet", 5) == 2.0
    assert plan.take_stall("fleet", 6) == 0.0


# -- rendezvous placement -----------------------------------------------------


def test_placement_deterministic_and_order_independent():
    rids = [f"10.0.0.{i}:7733" for i in range(4)]
    keys = [f"sess-{i}" for i in range(64)]
    got = {k: place(k, rids) for k in keys}
    assert got == {k: place(k, list(reversed(rids))) for k in keys}
    assert set(got.values()) == set(rids)
    assert place("k", []) is None


def test_placement_leave_moves_only_departed_share():
    rids = [f"10.0.0.{i}:7733" for i in range(4)]
    keys = [f"sess-{i}" for i in range(200)]
    before = {k: place(k, rids) for k in keys}
    after = {k: place(k, rids[:3]) for k in keys}
    for k in keys:
        if before[k] != rids[3]:
            assert after[k] == before[k]
        else:
            assert after[k] in rids[:3]


def test_placement_join_moves_only_won_share():
    rids = [f"10.0.0.{i}:7733" for i in range(4)]
    keys = [f"sess-{i}" for i in range(200)]
    before = {k: place(k, rids) for k in keys}
    after = {k: place(k, rids + ["10.0.0.9:7733"]) for k in keys}
    moved = [k for k in keys if after[k] != before[k]]
    assert moved and all(after[k] == "10.0.0.9:7733" for k in moved)
    assert len(moved) < len(keys) // 2


def test_rank_is_a_full_deterministic_order():
    rids = [f"r{i}" for i in range(5)]
    order = rank("some-session", rids)
    assert sorted(order) == sorted(rids)
    assert order == rank("some-session", list(reversed(rids)))
    assert order[0] == place("some-session", rids)


REPLICA_SETS = {
    "two": ["127.0.0.1:41001", "127.0.0.1:41002"],
    "four": [f"10.0.0.{i}:7733" for i in range(4)],
    "seven": [f"node-{i}.fleet:{7000 + i}" for i in range(7)],
}


@pytest.mark.parametrize("which", sorted(REPLICA_SETS))
def test_rank_and_place_equal_the_references(which):
    """A fleet mixing both packages' routers places every key alike."""
    from kcmc_tpu.serve import fleet as jfleet

    rids = REPLICA_SETS[which]
    for i in range(300):
        key = f"fr-{i:04d}" if i % 3 else f"session/{i}"
        assert place(key, rids) == jfleet.place(key, rids)
        assert rank(key, rids) == jfleet.rank(key, rids)


# -- replica health machine ---------------------------------------------------


def test_health_hard_evidence_ladder_and_hysteresis():
    h = ReplicaHealth(suspect_probes=2, dead_probes=3)
    assert h.state == HEALTHY
    h.observe(False, hard=True)
    assert h.state == HEALTHY  # one bad scrape is not evidence
    h.observe(False, hard=True)
    assert h.state == SUSPECT
    h.observe(True)
    assert h.state == SUSPECT  # recovery needs suspect_probes good scrapes
    h.observe(True)
    assert h.state == HEALTHY
    h.observe(False, hard=True)
    h.observe(True)
    h.observe(True)
    for _ in range(3):
        h.observe(False, hard=True)
    assert h.state == DEAD
    h.observe(True)
    assert h.state == DEAD  # sticky


def test_health_soft_evidence_never_kills():
    h = ReplicaHealth(suspect_probes=2, dead_probes=3)
    for _ in range(20):
        h.observe(False, hard=False)
    assert h.state == SUSPECT


# -- merge exactness ----------------------------------------------------------


def _two_payloads(seed=3):
    rng = np.random.default_rng(seed)
    a, b, union = SegmentLatencies(), SegmentLatencies(), SegmentLatencies()
    for i, v in enumerate(rng.uniform(1e-4, 0.5, size=200)):
        rung = ("full", "latency", "degraded")[i % 3]
        (a if i % 2 else b).observe("request.total", float(v), rung=rung)
        (a if i % 2 else b).observe("request.dispatch", float(v) / 3, rung=rung)
        union.observe("request.total", float(v), rung=rung)
        union.observe("request.dispatch", float(v) / 3, rung=rung)
    payloads = {
        "r-a:1": {"plane": {"histograms": a.hist_dicts()},
                  "counters": {"frames_done": 100, "rejected_frames": 2},
                  "gauges": {"queued_frames": 3, "sessions_open": 1},
                  "sessions": {"s1": {"tenant": "x", "frames": 5}}},
        "r-b:2": {"plane": {"histograms": b.hist_dicts()},
                  "counters": {"frames_done": 50},
                  "gauges": {"queued_frames": 4, "inflight_batches": 2},
                  "sessions": {"s2": {"tenant": "y", "frames": 7}}},
    }
    return payloads, union


def test_merge_fleet_metrics_is_exact():
    """Merging per-replica exports reproduces what ONE process observing
    every request would have recorded — summaries equal to the digit."""
    payloads, union = _two_payloads()
    merged = merge_fleet_metrics(payloads)
    want = union.report()["totals"]["request.total"]
    assert merged["plane"]["totals"]["request.total"] == want
    assert merged["counters"]["frames_done"] == 150
    assert merged["gauges"]["queued_frames"] == 7
    assert merged["sessions"]["s2"]["replica"] == "r-b:2"
    assert merged["fleet"]["n_replicas"] == 2 and merged["fleet"]["n_healthy"] == 2


def test_merge_and_wait_hint_equal_the_references():
    from kcmc_tpu.serve import fleet as jfleet

    payloads, _ = _two_payloads(seed=7)
    sl = SegmentLatencies()
    sl.observe("fleet.migrate", 0.25)
    kw = dict(extra_hists=sl.hist_dicts(),
              states={"r-a:1": HEALTHY, "r-b:2": SUSPECT, "r-c:3": DEAD})
    got = merge_fleet_metrics(payloads, **kw)
    want = jfleet.merge_fleet_metrics(payloads, **kw)
    assert got == want
    for qos in (None, "latency", "batch"):
        for queued, cap in ((0, 64), (100, 64), (7, 0)):
            assert predicted_wait_s(got, queued, cap, qos_class=qos) == (
                jfleet.predicted_wait_s(want, queued, cap, qos_class=qos))
    assert predicted_wait_s({}, 10, 100) is None


def test_predicted_wait_hint():
    sl = SegmentLatencies()
    for _ in range(10):
        sl.observe("request.total", 0.1)
    merged = merge_fleet_metrics({"r:1": {"plane": {"histograms": sl.hist_dicts()}}})
    hint = predicted_wait_s(merged, queued=100, capacity=100)
    assert hint is not None and hint > 0.1  # scaled by backlog
    assert predicted_wait_s({}, 10, 100) is None  # no history
    assert predicted_wait_s(merged, 10, 0) is None


def test_top_renders_fleet_block():
    from kcmc_tpu_torch.obs.top import _merge_stats, render

    sl = SegmentLatencies()
    sl.observe("request.total", 0.02)
    merged = merge_fleet_metrics(
        {"10.0.0.1:7733": {"plane": {"histograms": sl.hist_dicts()},
                           "gauges": {"sessions_open": 2}}},
        states={"10.0.0.1:7733": HEALTHY, "10.0.0.2:7733": DEAD},
    )
    stats = _merge_stats({
        "a": {"supervisor": {"backend_strikes": 1, "loop_beat_age_s": 40.0}},
        "b": {"supervisor": {"backend_strikes": 2, "backend_rebuilding": True}},
    })
    assert stats["supervisor"]["backend_strikes"] == 3
    out = render(merged, stats, "fleet(2)")
    assert "fleet: 2 replicas, 1 healthy" in out
    assert "10.0.0.2:7733" in out and "DEAD" in out
    assert "WEDGED" in out and "rebuilding=yes" in out


# -- in-process fleet: proxying + migration -----------------------------------


def _inproc_fleet(tmp_path, n=2, probe_interval=0.2, mc_kw=None, **cfg_kw):
    jdir = str(tmp_path / "journals")
    servers = [
        ServeServer(_port(serve_journal_dir=jdir, serve_journal_every=4,
                          **(mc_kw or {})), port=0).start()
        for _ in range(n)
    ]
    reps = [Replica("127.0.0.1", s.port) for s in servers]
    cfg = CorrectorConfig(fleet_probe_interval_s=probe_interval, **cfg_kw)
    router = FleetRouter(reps, port=0, config=cfg, journal_dir=jdir).start()
    return servers, reps, router, jdir


def _stop(router, servers):
    router.stop()
    for s in servers:
        s.stop()


def _wait_journal(jdir, sid, frames=4, timeout=60.0):
    jp = journal_path(jdir, sid)
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if os.path.exists(jp):
            got = load_session_journal(jp)
            if got and int(got[0]["done"]) >= frames:
                return
        time.sleep(0.05)
    raise AssertionError("journal never became durable")


def _sid_on(rid, rids, prefix):
    """A session id that rendezvous placement puts on `rid`."""
    return next(f"{prefix}{i}" for i in range(1000) if place(f"{prefix}{i}", rids) == rid)


def test_router_proxies_a_full_stream_parity_exact(tmp_path):
    stack = _stack(24, seed=4)
    truth = _truth(stack)
    servers, reps, router, _ = _inproc_fleet(tmp_path)
    try:
        with ServeClient(port=router.port) as c:
            assert c.ping()
            sid = c.open_session(tenant="t", session_id="P1")
            c.submit(sid, stack[:12])
            c.submit(sid, stack[12:])
            out = c.close_session(sid)
            m = c.metrics()
            st = c.stats()
    finally:
        _stop(router, servers)
    assert out["frames"] == 24
    assert np.abs(out["transforms"] - truth).max() < TOL
    assert st["router"] is True and st["sessions_routed"] == 1
    assert m["fleet"]["n_replicas"] == 2
    assert st["replicas"][place("P1", [r.rid for r in reps])]["sessions"] == 0


def test_migration_on_replica_death_is_parity_exact(tmp_path):
    """Stop (drain, which journals) the bound replica mid-stream; the
    router migrates the session to the survivor on the next forward and
    the stream finishes parity-exact with no client-visible error."""
    stack = _stack(24, seed=5)
    truth = _truth(stack)
    servers, reps, router, jdir = _inproc_fleet(tmp_path)
    by_rid = {r.rid: s for r, s in zip(reps, servers)}
    try:
        with ServeClient(port=router.port) as c:
            sid = c.open_session(tenant="t", session_id="M1")
            c.submit(sid, stack[:12])
            _wait_journal(jdir, sid)
            victim_rid = router.stats()["sessions"][sid]
            by_rid[victim_rid].stop()  # drains + journals, then dies
            c.submit(sid, stack[12:])  # forward fails -> migrate
            out = c.close_session(sid)
        st = router.stats()
        mig = router.fleet_metrics()["plane"]["totals"]["fleet.migrate"]
    finally:
        _stop(router, servers)
    assert out["frames"] == 24
    assert np.abs(out["transforms"] - truth).max() < TOL
    assert st["migrations_total"] == 1 and st["migration_failures"] == 0
    assert st["migrations"][0]["from"] == victim_rid
    assert st["sessions"] == {}  # closed sessions unbind
    assert mig["count"] == 1


def test_lost_context_replica_goes_dead_and_only_its_healthy_stream_migrates(
        tmp_path, monkeypatch):
    """A sticky CUDA error, injected: the first batch of stream X on
    replica A raises an illegal-address error, the context probe says
    the context is lost, and every later batch on A would raise too. A
    reports `device_lost` with X among its `failed_sessions`; the router
    takes the flag as hard evidence, A goes DEAD, stream Y (journaled on
    A) migrates to B and finishes parity-exact, and X fails to its
    client without ever being migrated."""
    monkeypatch.setattr(scheduler_mod, "device_context_lost", lambda device: True)
    stack_y, stack_x = _stack(24, seed=8), _stack(16, seed=9)
    truth_y = _truth(stack_y)
    servers, reps, router, jdir = _inproc_fleet(
        tmp_path, fleet_suspect_probes=1, fleet_dead_probes=2)
    rids = [r.rid for r in reps]
    a_rid = rids[0]
    a_backend = servers[0].scheduler.mc.backend
    sid_y, sid_x = _sid_on(a_rid, rids, "Y"), _sid_on(a_rid, rids, "X")
    try:
        with ServeClient(port=router.port) as c:
            c.open_session(tenant="y", session_id=sid_y)
            c.submit(sid_y, stack_y[:12])
            _wait_journal(jdir, sid_y, frames=12)  # nothing of Y left on A

            def sticky(*a, **k):
                raise RuntimeError("CUDA error: an illegal memory access was encountered")

            a_backend.process_batch_async = sticky
            c.open_session(tenant="x", session_id=sid_x)
            c.submit(sid_x, stack_x)
            t0 = time.monotonic()
            while router.replica_states()[a_rid] != DEAD:
                assert time.monotonic() - t0 < 30.0, router.replica_states()
                time.sleep(0.05)
            c.submit(sid_y, stack_y[12:])
            out_y = c.close_session(sid_y)
            with pytest.raises(ServeError) as ei:
                c.close_session(sid_x)
        st = router.stats()
        a_sup = servers[0].scheduler.stats()["supervisor"]
    finally:
        _stop(router, servers)
    assert a_sup["device_lost"] is True and sid_x in a_sup["failed_sessions"]
    assert sid_y not in a_sup["failed_sessions"]
    assert "not migrated" in str(ei.value) and ei.value.code == 500
    assert out_y["frames"] == 24
    assert np.abs(out_y["transforms"] - truth_y).max() < TOL
    assert [m["session"] for m in st["migrations"]] == [sid_y]
    assert st["migrations_total"] == 1 and st["sessions"] == {}


def test_lost_context_releases_the_streams_in_flight_beside_the_one_that_raised(
        tmp_path, monkeypatch):
    """The lost-context rule under concurrent traffic: stream Y has a
    batch in flight on replica A, and more queued, when a batch of
    stream X raises the sticky error. A stops dispatching and releases
    Y with a 503; only X is listed failed. Y migrates from its journal,
    its results reach the client with no frame lost or duplicated, and
    it finishes parity-exact; X fails and is never migrated."""
    monkeypatch.setattr(scheduler_mod, "device_context_lost", lambda device: True)
    stack_y, stack_x = _stack(32, seed=10), _stack(16, seed=11)
    truth_y = _truth(stack_y)
    servers, reps, router, jdir = _inproc_fleet(tmp_path)
    rids = [r.rid for r in reps]
    a_rid = rids[0]
    a_sched = servers[0].scheduler
    a_backend = a_sched.mc.backend
    orig = a_backend.process_batch_async
    sid_y, sid_x = _sid_on(a_rid, rids, "Y"), _sid_on(a_rid, rids, "X")
    x_frames = {f.tobytes() for f in stack_x}
    held, gate, poisoned = threading.Event(), threading.Event(), []

    def sticky(batch, *a, **k):
        if poisoned or any(f.tobytes() in x_frames for f in np.asarray(batch)):
            if not poisoned:  # Y's work on A when X's batch raises
                y = a_sched._sessions[sid_y]
                poisoned.append((len(a_sched._window), len(y.pending)))
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        if not held.is_set():
            held.set()  # Y's second batch holds the scheduler thread
            assert gate.wait(30.0)
        return orig(batch, *a, **k)

    got, firsts = 0, []
    try:
        with ServeClient(port=router.port) as c:
            c.open_session(tenant="y", session_id=sid_y)
            c.submit(sid_y, stack_y[:8])
            _wait_journal(jdir, sid_y, frames=8)
            a_backend.process_batch_async = sticky
            c.submit(sid_y, stack_y[8:24])
            assert held.wait(30.0)
            c.open_session(tenant="x", session_id=sid_x)
            c.submit(sid_x, stack_x)
            gate.set()
            t0 = time.monotonic()
            while router.replica_states()[a_rid] != DEAD:
                assert time.monotonic() - t0 < 30.0, router.replica_states()
                time.sleep(0.05)
            a_sup = servers[0].scheduler.stats()["supervisor"]
            c.submit(sid_y, stack_y[24:])
            while got < 32:
                span = c.results(sid_y, timeout=60.0)
                firsts.append(int(span["first_frame"]))
                assert firsts[-1] == got
                got += int(span["n"])
            out_y = c.close_session(sid_y)
            with pytest.raises(ServeError) as ei:
                c.close_session(sid_x)
        st = router.stats()
    finally:
        gate.set()
        _stop(router, servers)
    # (Y's batches in flight, Y's frames queued): its second batch is
    # dispatched and undrained when X's raises
    assert poisoned[0][0] >= 1, poisoned[0]
    assert a_sup["device_lost"] is True and a_sup["failed_sessions"] == [sid_x]
    assert "not migrated" in str(ei.value) and ei.value.code == 500
    assert out_y["frames"] == 32
    assert np.abs(out_y["transforms"] - truth_y).max() < TOL
    assert [m["session"] for m in st["migrations"]] == [sid_y]
    assert st["migrations"][0]["from"] == a_rid
    assert st["migrations_total"] == 1 and st["migration_failures"] == 0


def test_lost_context_refuses_new_work_with_503(monkeypatch):
    """After the loss a server answers opens, resumes and the released
    streams' submits with 503 (`DeviceLostError`), so a router places
    and migrates them elsewhere."""
    monkeypatch.setattr(scheduler_mod, "device_context_lost", lambda device: True)
    srv = ServeServer(_port(), port=0).start()
    backend = srv.scheduler.mc.backend
    orig = backend.process_batch_async
    calls = []

    def sticky(batch, *a, **k):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return orig(batch, *a, **k)

    backend.process_batch_async = sticky
    try:
        with ServeClient(port=srv.port) as c:
            c.open_session(tenant="y", session_id="Y")
            c.submit("Y", _stack(8, seed=14))
            assert int(c.results("Y", timeout=60.0)["n"]) == 8
            c.open_session(tenant="x", session_id="X")
            c.submit("X", _stack(8, seed=15))
            t0 = time.monotonic()
            while not srv.scheduler.stats()["supervisor"]["device_lost"]:
                assert time.monotonic() - t0 < 30.0
                time.sleep(0.02)
            codes = []
            for call in (lambda: c.submit("Y", _stack(8, seed=16)),
                         lambda: c.open_session(tenant="z", session_id="Z"),
                         lambda: c.resume_session_info("Y")):
                with pytest.raises(ServeError) as ei:
                    call()
                codes.append(ei.value.code)
            with pytest.raises(ServeError) as ex:
                c.close_session("X")
        sup = srv.scheduler.stats()["supervisor"]
    finally:
        srv.stop()
    assert codes == [503, 503, 503]
    assert ex.value.code == 500 and "illegal memory access" in str(ex.value)
    assert sup["failed_sessions"] == ["X"]


def test_cpu_device_has_no_context_to_lose():
    assert scheduler_mod.device_context_lost("cpu") is False


# -- the wire both ways, against the reference --------------------------------


def test_reference_client_streams_through_the_port_router(tmp_path):
    from kcmc_tpu.serve.client import ServeClient as JClient

    stack = _stack(16, seed=12)
    truth = _truth(stack)
    servers, reps, router, _ = _inproc_fleet(tmp_path)
    try:
        with JClient(port=router.port) as c:
            sid = c.open_session(tenant="ref", session_id="J1")
            c.submit(sid, stack)
            got = 0
            while got < 16:
                span = c.results(sid, timeout=60.0)
                assert int(span["first_frame"]) == got
                got += int(span["n"])
            out = c.close_session(sid)
            assert c.metrics(timeout=5.0)["fleet"]["n_replicas"] == 2
    finally:
        _stop(router, servers)
    assert out["frames"] == 16
    assert np.abs(out["transforms"] - truth).max() < TOL


def test_port_router_adopts_a_reference_server():
    from kcmc_tpu.serve.server import ServeServer as JServer

    stack = _stack(16, seed=13)
    truth = kcmc_tpu.MotionCorrector(backend="numpy", **KW).correct(stack).transforms
    jsrv = JServer(kcmc_tpu.MotionCorrector(backend="numpy", **KW), port=0).start()
    router = FleetRouter([Replica("127.0.0.1", jsrv.port)], port=0,
                         config=CorrectorConfig(fleet_probe_interval_s=0.2)).start()
    try:
        with ServeClient(port=router.port) as c:
            sid = c.open_session(tenant="adopt", session_id="A1")
            c.submit(sid, stack)
            out = c.close_session(sid)
        t0 = time.monotonic()
        while router.stats()["replicas"][f"127.0.0.1:{jsrv.port}"]["probes"] < 2:
            assert time.monotonic() - t0 < 30.0
            time.sleep(0.05)
        states = router.replica_states()
    finally:
        router.stop()
        jsrv.stop()
    assert out["frames"] == 16
    assert np.abs(out["transforms"] - truth).max() < TOL
    assert set(states.values()) == {HEALTHY}


# -- admission, client budget -------------------------------------------------


def test_admission_watermark_rejects_with_hint():
    r1 = Replica("127.0.0.1", 1, ready={"queue_depth": 64})
    sl = SegmentLatencies()
    sl.observe("request.total", 0.2)
    r1.last_metrics = {
        "plane": {"histograms": sl.hist_dicts()},
        "gauges": {"queued_frames": 60},
    }
    router = FleetRouter([r1], port=0, config=CorrectorConfig(fleet_queue_watermark=0.5))
    try:
        resp = router._admission_reject()
        assert resp is not None and resp["code"] == 429
        assert resp["queued"] == 60 and resp["limit"] == 32
        assert resp["predicted_wait_s"] > 0
        assert router.stats()["sessions_rejected"] == 1
        router.config = CorrectorConfig(fleet_queue_watermark=1.0)
        assert router._admission_reject() is None  # 1.0 = off
    finally:
        router._tcp.server_close()  # never started; close the socket


def test_client_budget_caps_whole_round_trip():
    """The metrics/stats `timeout=` budget bounds the WHOLE round trip,
    reconnects included, so a prober is never held past its scrape
    budget by a dead replica."""
    srv = ServeServer(_port(), port=0).start()
    c = ServeClient(port=srv.port, reconnect_backoff_s=2.0)
    try:
        assert c.metrics(timeout=5.0)["schema"] == "kcmc_metrics/1"
        srv.stop()
        c.disconnect()
        t0 = time.monotonic()
        with pytest.raises(ServeError) as ei:
            c.metrics(timeout=0.5)
        assert ei.value.code == 503
        assert time.monotonic() - t0 < 2.0
    finally:
        c.close()
        srv.stop()


# -- autoscaler ---------------------------------------------------------------


class _FakeRouter:
    def __init__(self):
        self.config = CorrectorConfig()
        self.load = {"queued_frames": 0, "capacity": 100, "n_live": 1,
                     "n_owned": 1, "e2e_p99_s": None}
        self.added: list = []
        self.drained: list = []

    def fleet_load(self):
        return dict(self.load)

    def add_replica(self, r):
        self.added.append(r)
        self.load["n_live"] += 1
        self.load["n_owned"] += 1

    def drain_replica(self, rid):
        self.drained.append(rid)
        self.load["n_live"] -= 1
        self.load["n_owned"] -= 1
        return {"replica": rid, "migrated": [], "failed": []}

    def stats(self):
        return {"replicas": {
            f"r{i}": {"spawned": True, "state": HEALTHY, "sessions": i}
            for i in range(self.load["n_owned"])
        }}


def _scaler(router, **kw):
    from types import SimpleNamespace

    from kcmc_tpu_torch.serve.autoscale import Autoscaler

    return Autoscaler(router, spawn_fn=lambda: SimpleNamespace(rid="new"), **kw)


def test_autoscaler_spawns_on_backlog_drains_on_idle():
    router = _FakeRouter()
    scaler = _scaler(router, min_replicas=1, max_replicas=2, cooldown_s=0.0)
    router.load["queued_frames"] = 80  # 0.8 > scale_up_at=0.5
    act = scaler.tick()
    assert act["action"] == "spawn" and len(router.added) == 1
    router.load["queued_frames"] = 90
    assert scaler.tick() is None  # at the ceiling
    router.load["queued_frames"] = 0
    act = scaler.tick()
    assert act["action"] == "drain" and router.drained == ["r0"]
    assert scaler.tick() is None  # at the floor


def test_autoscaler_cooldown_blocks_flapping():
    router = _FakeRouter()
    scaler = _scaler(router, min_replicas=1, max_replicas=4, cooldown_s=300.0)
    router.load["queued_frames"] = 80
    assert scaler.tick() is not None
    assert scaler.tick() is None  # cooldown armed
    assert len(router.added) == 1


def test_autoscaler_first_tick_is_free_whatever_the_uptime(monkeypatch):
    """With the monotonic clock at 100 s (a host booted 100 s ago) the
    first hot tick spawns at once; the reference's holds until the
    clock passes its cooldown, as its first action is stamped 0.0."""
    from kcmc_tpu.serve import autoscale as jautoscale

    monkeypatch.setattr(time, "monotonic", lambda: 100.0)
    router = _FakeRouter()
    scaler = _scaler(router, min_replicas=1, max_replicas=4, cooldown_s=300.0)
    router.load["queued_frames"] = 80
    assert scaler.tick()["action"] == "spawn"
    assert scaler.tick() is None  # the cooldown runs from that action
    jrouter = _FakeRouter()
    jrouter.load["queued_frames"] = 80
    from types import SimpleNamespace

    jscaler = jautoscale.Autoscaler(jrouter, spawn_fn=lambda: SimpleNamespace(rid="new"),
                                    min_replicas=1, max_replicas=4, cooldown_s=300.0)
    assert jscaler.tick() is None and jrouter.added == []


def test_autoscaler_validates_bounds():
    with pytest.raises(ValueError, match="min_replicas"):
        _scaler(_FakeRouter(), min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError, match="scale_down_at"):
        _scaler(_FakeRouter(), scale_up_at=0.2, scale_down_at=0.3)


# -- fleet config knobs -------------------------------------------------------


@pytest.mark.parametrize(
    "kw,match",
    [
        ({"fleet_probe_interval_s": 0.0}, "fleet_probe_interval_s"),
        ({"fleet_suspect_probes": 0}, "fleet_suspect_probes"),
        ({"fleet_suspect_probes": 3, "fleet_dead_probes": 2}, "fleet_dead_probes"),
        ({"fleet_wedge_threshold_s": 0.0}, "fleet_wedge_threshold_s"),
        ({"fleet_queue_watermark": 1.5}, "fleet_queue_watermark"),
        ({"fleet_scale_cooldown_s": -1.0}, "fleet_scale_cooldown_s"),
    ],
)
def test_fleet_config_validation_equals_the_references(kw, match):
    CorrectorConfig(fleet_probe_interval_s=0.5, fleet_suspect_probes=1, fleet_dead_probes=1)
    with pytest.raises(ValueError, match=match) as got:
        CorrectorConfig(**kw)
    with pytest.raises(ValueError) as want:
        kcmc_tpu.CorrectorConfig(**kw)
    assert str(got.value) == str(want.value)


# -- the CLI: a spawned fleet, SIGKILL of the bound replica, top, SIGTERM ----


def test_router_cli_spawned_fleet_survives_a_sigkill(tmp_path, capsys):
    """`--device cpu router --spawn 2` boots a fleet, prints its ready
    line, and serves one 24-frame stream while the replica it is bound
    to is SIGKILLed once its journal holds >= 4 frames: no lost and no
    duplicated frames, transforms within 1e-4 px of `correct()`; `top
    --once` on the router exits 0; SIGTERM gives the `routed` record and
    exit 0 with no replica process left."""
    from chip_smoke import listening_children, pid_alive
    from kcmc_tpu_torch.__main__ import main as tmain

    stack = _stack(24, seed=10)
    truth = _truth(stack)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kcmc_tpu_torch", "--device", "cpu", "router",
         "--port", "0", "--spawn", "2", "--probe-interval", "0.25",
         "--journal-dir", str(tmp_path / "journals"),
         "--serve-args", "--batch-size 8 --max-keypoints 64 "
         "--hypotheses 32 --journal-every 4"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"},
    )
    kids = {}
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["routing"] is True and len(ready["replicas"]) == 2
        kids = listening_children(proc.pid)
        ports = sorted(int(r.rsplit(":", 1)[1]) for r in ready["replicas"])
        assert sorted(p for p in kids if p in ports) == ports
        with ServeClient(port=ready["port"]) as c:
            sid = c.open_session(tenant="cli", session_id="K1")
            c.submit(sid, stack[:16])
            _wait_journal(ready["journal_dir"], sid)
            victim = c.stats()["sessions"][sid]
            os.kill(kids[int(victim.rsplit(":", 1)[1])], signal.SIGKILL)
            c.submit(sid, stack[16:])
            delivered = 0
            while delivered < 24:
                span = c.results(sid, timeout=60.0)
                assert int(span["first_frame"]) == delivered, "lost or duplicated frames"
                delivered += int(span["n"])
            out = c.close_session(sid)
            st = c.stats()
        assert out["frames"] == 24
        assert np.abs(out["transforms"] - truth).max() < TOL
        assert st["migrations_total"] >= 1 and st["migration_failures"] == 0
        assert tmain(["top", "--once", f"127.0.0.1:{ready['port']}"]) == 0
        assert "fleet: 2 replicas" in capsys.readouterr().out
        proc.send_signal(signal.SIGTERM)
        final = json.loads(proc.stdout.readline())
        assert final["routed"] is True and final["stats"]["sessions_routed"] == 1
        assert proc.wait(timeout=60) == 0
        assert not [p for p in kids.values() if pid_alive(p)]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        for pid in kids.values():
            if pid_alive(pid):
                os.kill(pid, signal.SIGKILL)
        if proc.stdout is not None:
            proc.stdout.close()
