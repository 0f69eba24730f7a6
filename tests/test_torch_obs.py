"""The observability of a one-shot run in the PyTorch port (obs/: the
Chrome trace, the per-frame records JSONL, the heartbeat, the run
manifest, the latency segments and the report), held function by
function against kcmc_tpu/obs on the same inputs; the two reports read
each other's artifacts; one traced end-to-end run against
backend="jax"; the timing keys against the reference's; the teardown;
and the object-store, plan and collective seams."""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu.obs import records as jrecords
from kcmc_tpu.obs import report as jreport
from kcmc_tpu.obs import trace as jtrace
from kcmc_tpu.obs import tracing as jtracing
from kcmc_tpu_torch.obs import heartbeat as theartbeat
from kcmc_tpu_torch.obs import records as trecords
from kcmc_tpu_torch.obs import registry as tregistry
from kcmc_tpu_torch.obs import report as treport
from kcmc_tpu_torch.obs import trace as ttrace
from kcmc_tpu_torch.obs import tracing as ttracing
from kcmc_tpu_torch.utils.synthetic import make_drift_stack

KW = dict(batch_size=4, max_keypoints=128)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stack():
    return make_drift_stack(8, (64, 64), seed=0).stack


def _names(trace: dict) -> list:
    return [e["name"] for e in trace["traceEvents"] if e["ph"] != "M"]


@pytest.fixture(scope="module")
def artifacts(stack, tmp_path_factory):
    """A traced, recorded port run and the reference's numpy run with the
    same knobs, both on the 8-frame 64x64 stack."""
    d = tmp_path_factory.mktemp("obs")
    out = {}
    for name, make in (
        ("port", lambda **k: kcmc_tpu_torch.MotionCorrector(device="cpu", **k)),
        ("ref", lambda **k: kcmc_tpu.MotionCorrector(backend="numpy", **k)),
    ):
        trace, recs = str(d / f"{name}.json"), str(d / f"{name}.jsonl")
        mc = make(trace_path=trace, frame_records_path=recs, **KW)
        res = mc.correct(stack)
        out[name] = {"trace": trace, "records": recs, "res": res, "mc": mc}
    return out


# -- records ---------------------------------------------------------------


def test_records_from_batch_equal_reference():
    host = {
        "n_keypoints": np.array([10, 12, 0, 7], np.int32),
        "n_matches": np.array([8, 9, 0, 5], np.int32),
        "n_inliers": np.array([7, 9, 0, 2], np.int32),
        "rms_residual": np.array([0.25, np.nan, np.inf, 1.5], np.float32),
        "template_corr": np.array([0.9, 0.8, np.nan, 0.3], np.float32),
        "coverage": np.array([1.0, 0.98, 0.5, 0.7], np.float32),
        "warp_ok": np.array([True, True, False, True]),
        "warp_rescued": np.array([False, True, False, False]),
    }
    kw = dict(n=4, failed=frozenset({12}), failover=frozenset({13}), escalated=True)
    want = jrecords.records_from_batch(10, host, "affine", **kw)
    got = trecords.records_from_batch(10, host, "affine", **kw)
    assert got == want
    assert got[1]["rms_residual_px"] is None and got[2]["failed"] and got[3]["failover"]
    # a device-resident drain hands tensors: only these columns move
    as_tensors = {k: torch.as_tensor(v) for k, v in host.items()}
    assert trecords.records_from_batch(10, as_tensors, "affine", **kw) == want
    for rec in got:
        json.dumps(rec, allow_nan=False)


def _records_file(path, n=6):
    lines = [json.dumps({"kind": "kcmc_frame_records", "version": 1})]
    lines += [json.dumps({"frame": i, "n_inliers": i}) for i in range(n)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + '\n{"frame": 6, "n_in')  # torn tail


@pytest.mark.parametrize("resume_at", [None, 4])
def test_read_jsonl_torn_tail_and_resume_pruning_equal_reference(tmp_path, resume_at):
    """The torn final line is skipped; a resume at frame 4 prunes the
    records the replay re-emits, writes a kcmc_run_resume marker and
    appends — the same file from both packages."""
    got = {}
    for name, mod in (("ref", jrecords), ("port", trecords)):
        p = str(tmp_path / f"{name}.jsonl")
        _records_file(p)
        if resume_at is not None:
            stream = mod.FrameRecordStream(p, manifest={"run": 1})
            stream.mark_resume(resume_at)
            stream.append([{"frame": i, "n_inliers": 10 * i} for i in range(resume_at, 8)])
            stream.close(summary={"frames": 8 - resume_at})
        got[name] = (open(p).read(), mod.read_jsonl(p))
    assert got["port"] == got["ref"]
    _, records, summary = got["port"][1]
    if resume_at is None:
        assert [r["frame"] for r in records] == list(range(6)) and summary is None
    else:
        assert [r["frame"] for r in records] == list(range(8))
        assert records[5]["n_inliers"] == 50 and summary["frames"] == 4
        assert '"kind": "kcmc_run_resume"' in got["port"][0]


# -- trace and tracing -----------------------------------------------------


def _drive(tr):
    with tr.span("register_batches", cat="stage"):
        pass

    def worker():
        tr.complete("upload.stage", time.perf_counter(), 1e-4, cat="upload",
                    args={"frames": 4})

    t = threading.Thread(target=worker, name="kcmc-upload_0")
    t.start()
    t.join()
    tr.counter("frames_done", {"frames": 7})
    tr.instant("checkpoint_save", args={"done": 4})


def test_tracer_to_json_schema_equals_reference():
    """Event for event the reference's schema: name/ph/ts/dur/pid/tid,
    cats and args, a thread_name row per track; timestamps differ."""
    want, got = jtrace.Tracer({"m": 1}), ttrace.Tracer({"m": 1})
    _drive(want)
    _drive(got)

    def shape(tr):
        j = tr.to_json()
        return ({k: v for k, v in j.items() if k != "traceEvents"},
                [(e["name"], e["ph"], e.get("cat"), sorted(e), e.get("args"))
                 for e in j["traceEvents"]])

    assert shape(got) == shape(want)
    evs = got.to_json()["traceEvents"]
    assert len({e["tid"] for e in evs if e["ph"] == "X"}) == 2
    for ev in evs:
        assert {"ts", "dur", "ph", "tid", "pid", "name"} <= set(ev)
    json.dumps(got.to_json())


SPANS = [
    {"name": "request.queue_wait", "t0": 1.0, "dur_s": 0.5, "trace_id": "a", "pid": 1,
     "tid": 1},
    {"name": "request.device", "t0": 1.5, "dur_s": 0.2, "trace_id": "a", "pid": 2, "tid": 3,
     "args": {"n": 4}, "span_id": "s1", "parent_id": "p0"},
    {"name": "request.total", "t0": 1.0, "dur_s": 1.6, "trace_id": "a", "pid": 1, "tid": 1},
    {"name": "rpc.client", "t0": 0.9, "dur_s": 2.0, "trace_id": "b", "pid": 1, "tid": 2},
    {"name": "fleet.migrate", "t0": 2.0, "dur_s": 0.7, "trace_id": "b", "pid": 3, "tid": 1},
    {"name": "request.drain", "t0": 3.0, "dur_s": 0.1, "pid": 1, "tid": 1},
]


def test_tracing_functions_equal_reference(tmp_path):
    assert ttracing.chrome_trace(SPANS) == jtracing.chrome_trace(SPANS)
    assert ttracing.stitch(SPANS) == jtracing.stitch(SPANS)
    for tid, spans in jtracing.stitch(SPANS).items():
        assert ttracing.critical_path(spans) == jtracing.critical_path(spans), tid
    assert ttracing.slowest(ttracing.stitch(SPANS)) == jtracing.slowest(jtracing.stitch(SPANS))
    p = str(tmp_path / "shard.jsonl")
    shard = ttracing.SpanShard(p, cap=4)
    for s in SPANS:
        shard.complete(s["name"], s["t0"], s["dur_s"], trace_id=s.get("trace_id"),
                       span_id=s.get("span_id"), parent_id=s.get("parent_id"),
                       args=s.get("args"))
    shard.close()
    with open(p, "a") as f:
        f.write('{"name": "torn')
    assert ttracing.read_span_shard(p) == jtracing.read_span_shard(p)
    assert len(ttracing.read_span_shard(p)) == 4 and shard.dropped == 2
    assert ttracing.collect_spans([str(tmp_path)]) == jtracing.collect_spans([str(tmp_path)])


# -- heartbeat -------------------------------------------------------------


def test_heartbeat_joins_and_rejects_a_bad_interval():
    with pytest.raises(ValueError, match="positive"):
        theartbeat.Heartbeat(0, lambda: "x")
    lines = []
    calls = iter(range(1000))

    def sample():
        if next(calls) == 0:
            raise RuntimeError("boom")  # muted after one diagnostic
        return "beat"

    hb = theartbeat.Heartbeat(0.005, sample, emit=lines.append).start()
    time.sleep(0.08)
    hb.stop()
    assert not hb.running and hb.beats >= 1
    assert "muting" in lines[0] and lines[1:] and set(lines[1:]) == {"beat"}
    assert not [t for t in threading.enumerate() if t.name == "kcmc-heartbeat"]


# -- the run: artifacts, names, keys ----------------------------------------


def test_port_run_artifacts_and_names(artifacts):
    """The port's trace has the reference's span vocabulary: two
    dispatch_batch spans, one upload.stage on the upload worker's own
    track, the stage spans, one frames_done counter per drained batch;
    every name is in the registry. The records hold one record per
    frame and the summary with the timing."""
    a = artifacts["port"]
    trace = json.load(open(a["trace"]))
    names = _names(trace)
    assert set(names) <= tregistry.SPAN_NAMES
    assert names.count("dispatch_batch") == 2 and names.count("frames_done") == 2
    assert {"prepare_reference", "register_batches", "drain_sync"} <= set(names)
    tracks = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M"}
    up = [e for e in trace["traceEvents"] if e["name"] == "upload.stage"]
    assert len(up) == 1 and tracks[up[0]["tid"]].startswith("kcmc-upload")
    disp = [e for e in trace["traceEvents"] if e["name"] == "dispatch_batch"]
    assert tracks[disp[0]["tid"]] == "MainThread"
    assert trace["metadata"]["manifest"]["kind"] == "kcmc_run_manifest"
    assert trace["metadata"]["manifest"]["versions"]["torch"] == torch.__version__
    header, records, summary = trecords.read_jsonl(a["records"])
    assert [r["frame"] for r in records] == list(range(8))
    assert summary["timing"]["stage_mean_s"] and "latency" in summary["timing"]
    lat = a["res"].timing["latency"]["totals"]
    assert {k: v["count"] for k, v in lat.items()} == {
        "request.dispatch": 8, "request.device": 8, "request.drain": 8}
    assert a["mc"]._telemetry is None


def test_timing_keys_equal_reference(stack, artifacts):
    """correct()'s timing keys equal the reference's on the same stack
    (the reference's numpy backend, the port on the CPU), off and on,
    and both lie in the registry's TIMING_KEYS."""
    want = kcmc_tpu.MotionCorrector(backend="numpy", **KW).correct(stack).timing
    got = kcmc_tpu_torch.MotionCorrector(device="cpu", **KW).correct(stack).timing
    assert set(got) == set(want)
    assert set(got) <= tregistry.TIMING_KEYS and set(want) <= tregistry.TIMING_KEYS
    assert got["stage_mean_s"].keys() == want["stage_mean_s"].keys()
    armed = artifacts["port"]["res"].timing, artifacts["ref"]["res"].timing
    assert set(armed[0]) == set(armed[1]) <= tregistry.TIMING_KEYS


def test_reports_read_each_others_artifacts(artifacts, capsys):
    """The reference's report accepts the port's trace and records, the
    port's accepts the reference's; on one artifact both give the same
    JSON summary."""
    for side in ("port", "ref"):
        for kind in ("records", "trace"):
            path = artifacts[side][kind]
            assert jreport.main(path, as_json=True) == 0
            want = json.loads(capsys.readouterr().out)
            assert treport.main(path, as_json=True) == 0
            got = json.loads(capsys.readouterr().out)
            assert got == want, (side, kind)
            if kind == "records":
                assert got["n_frames"] == 8 and not got["incomplete"]
                assert got["latency"]["totals"]["request.device"]["count"] == 8
    assert treport.main(artifacts["ref"]["records"]) == 0
    text = capsys.readouterr().out
    assert "Stages:" in text and "Request latency" in text


def test_jax_run_records_match_port(stack, tmp_path):
    """One backend="jax" run with records: n_keypoints and n_matches
    equal the port's, n_inliers within 2."""
    kw = dict(model="translation", **KW)
    recs = {}
    for name, mc in (
        ("jax", kcmc_tpu.MotionCorrector(backend="jax",
                                         frame_records_path=str(tmp_path / "j.jsonl"), **kw)),
        ("port", kcmc_tpu_torch.MotionCorrector(
            device="cpu", frame_records_path=str(tmp_path / "p.jsonl"), **kw)),
    ):
        mc.correct(stack)
        recs[name] = trecords.read_jsonl(mc.config.frame_records_path)[1]
    for k in ("n_keypoints", "n_matches"):
        assert [r[k] for r in recs["port"]] == [r[k] for r in recs["jax"]], k
    assert max(abs(a["n_inliers"] - b["n_inliers"])
               for a, b in zip(recs["port"], recs["jax"])) <= 2


# -- teardown --------------------------------------------------------------


def test_failed_run_flushes_postmortem_artifacts(stack, tmp_path):
    mc = kcmc_tpu_torch.MotionCorrector(
        device="cpu", trace_path=str(tmp_path / "post.json"),
        frame_records_path=str(tmp_path / "post.jsonl"), heartbeat_s=30.0,
        fault_plan="device:step=1:raise", retry_attempts=1, failover_backend=None,
        degrade_mark_failed=False, batch_size=2, max_keypoints=128)
    with pytest.raises(Exception, match="injected"):
        mc.correct(stack)
    assert mc._telemetry is None
    assert not [t for t in threading.enumerate() if t.name == "kcmc-heartbeat"]
    trace = json.load(open(tmp_path / "post.json"))
    assert "error" in trace["metadata"]
    _, records, summary = trecords.read_jsonl(str(tmp_path / "post.jsonl"))
    assert summary is not None and "error" in summary
    # the failure surfaced at dispatch of batch 1, after the window drained
    assert [r["frame"] for r in records] == [0, 1]
    # an unarmed run never arms
    plain = kcmc_tpu_torch.MotionCorrector(device="cpu", **KW)
    plain.correct(stack[:4])
    assert plain._telemetry is None


# -- seams -----------------------------------------------------------------


def test_correct_file_object_spans_resume_and_records(stack, tmp_path):
    """A traced correct_file over emu:// has object.get and object.put
    spans, writer spans and feeder counters; a killed checkpointed run
    resumed with records holds one record per frame behind a
    kcmc_run_resume marker."""
    from kcmc_tpu_torch.io import objectstore

    u16 = np.clip(stack * 40000, 0, 65535).astype(np.uint16)
    src, out = f"emu://{tmp_path}/in", f"emu://{tmp_path}/out"
    objectstore.put_stack(src, u16, chunk_frames=4)
    trace, recs = str(tmp_path / "f.json"), str(tmp_path / "f.jsonl")
    mc = kcmc_tpu_torch.MotionCorrector(device="cpu", trace_path=trace,
                                        frame_records_path=recs, **KW)
    res = mc.correct_file(src, output=out)
    names = _names(json.load(open(trace)))
    assert {"object.get", "object.put", "writer.append_batch"} <= set(names)
    assert set(names) <= tregistry.SPAN_NAMES
    assert len(trecords.read_jsonl(recs)[1]) == 8
    assert set(res.timing) <= tregistry.TIMING_KEYS
    # killed after the first checkpoint, then resumed with the records
    tif = str(tmp_path / "in.tif")
    from kcmc_tpu_torch.io import write_stack

    write_stack(tif, u16)
    ck, o2 = str(tmp_path / "run.ckpt.npz"), str(tmp_path / "o.tif")
    kill = kcmc_tpu_torch.MotionCorrector(
        device="cpu", frame_records_path=recs, fault_plan="device:step=1:raise",
        retry_attempts=1, failover_backend=None, degrade_mark_failed=False, **KW)
    with pytest.raises(Exception, match="injected"):
        kill.correct_file(tif, output=o2, checkpoint=ck, checkpoint_every=4)
    resumed = kcmc_tpu_torch.MotionCorrector(device="cpu", frame_records_path=recs,
                                             trace_path=trace, **KW)
    got = resumed.correct_file(tif, output=o2, checkpoint=ck, checkpoint_every=4)
    assert got.timing["restored_frames"] == 4
    text = open(recs).read()
    assert '"kind": "kcmc_run_resume"' in text
    assert [r["frame"] for r in trecords.read_jsonl(recs)[1]] == list(range(8))
    assert "checkpoint_resume" in _names(json.load(open(trace)))


@pytest.fixture
def compile_cache(tmp_path):
    """A temporary persistent cache, switched off afterwards so the
    process-global directory never outlives the test."""
    from kcmc_tpu_torch.plans import cache

    cache.disable_compile_cache()
    yield str(tmp_path / "cache")
    cache.disable_compile_cache()


def test_plan_spans_with_and_without_warmup(stack, tmp_path, compile_cache):
    """Bucketed: warmup's builds are plan_build spans; an unwarmed run's
    first builds are jit_compile spans; with a cache directory each
    build also has a plan_cache_miss instant."""
    kw = dict(device="cpu", plan_buckets=(64,), **KW)
    warm = kcmc_tpu_torch.MotionCorrector(trace_path=str(tmp_path / "w.json"),
                                          compile_cache_dir=compile_cache, **kw)
    warm.warmup()
    warm.correct(stack)
    names = _names(json.load(open(tmp_path / "w.json")))
    assert "jit_compile" not in names
    cold = kcmc_tpu_torch.MotionCorrector(trace_path=str(tmp_path / "c.json"), **kw)
    cold.correct(stack)
    names = _names(json.load(open(tmp_path / "c.json")))
    assert names.count("jit_compile") >= 2 and "plan_build" not in names
    from kcmc_tpu_torch.obs.trace import Tracer
    from kcmc_tpu_torch.plans import runtime

    tr = Tracer()
    runtime.add_tracer(tr)
    try:
        # another config in the same cache directory: a fresh stamp
        kcmc_tpu_torch.MotionCorrector(compile_cache_dir=compile_cache,
                                       **dict(kw, max_keypoints=96)).warmup(
                                           programs=("reference",))
    finally:
        runtime.discard_tracer(tr)
    names = _names(tr.to_json())
    assert "plan_build" in names and "plan_cache_miss" in names
    assert set(names) <= tregistry.SPAN_NAMES


def test_sharded_run_has_collective_chunk_and_shard_args(stack, tmp_path):
    trace = str(tmp_path / "m.json")
    kcmc_tpu_torch.MotionCorrector(device="cpu", mesh_devices=2, collective_chunks=2,
                                   trace_path=trace, **KW).correct(stack)
    evs = json.load(open(trace))["traceEvents"]
    chunk = [e for e in evs if e["name"] == "collective.chunk"]
    assert chunk and chunk[0]["args"]["chunks"] == 2 and chunk[0]["args"]["devices"] == 2
    disp = [e for e in evs if e["name"] == "dispatch_batch"]
    assert disp[0]["args"]["shards"] == 2 and disp[0]["args"]["frames_per_shard"] == 2


def test_config_from_reference_config_arms_the_artifacts(stack, tmp_path):
    """The four knobs carry across from a reference config, and so do
    the serve plane's span-shard and SLO knobs (resume-neutral, like
    the reference's); unknown names raise."""
    from kcmc_tpu_torch.config import DROPPED_FIELDS, SIG_NEUTRAL_FIELDS

    jcfg = kcmc_tpu.CorrectorConfig(trace_path=str(tmp_path / "t.json"),
                                    frame_records_path=str(tmp_path / "r.jsonl"),
                                    heartbeat_s=0.5, latency_telemetry=False,
                                    trace_shard_cap=8, slo_objectives="avail:0.9")
    cfg = kcmc_tpu_torch.config_from_dict(dataclasses.asdict(jcfg))
    for k in ("trace_path", "frame_records_path", "heartbeat_s", "latency_telemetry"):
        assert getattr(cfg, k) == getattr(jcfg, k) and k in SIG_NEUTRAL_FIELDS
    for k in ("trace_shard_dir", "trace_shard_cap", "slo_objectives"):
        assert getattr(cfg, k) == getattr(jcfg, k) and k in SIG_NEUTRAL_FIELDS
        assert k not in DROPPED_FIELDS
    res = kcmc_tpu_torch.MotionCorrector(config=cfg, device="cpu", heartbeat_s=0.0,
                                         **KW).correct(stack)
    assert "latency" not in res.timing  # latency_telemetry=False
    assert os.path.getsize(cfg.trace_path) and os.path.getsize(cfg.frame_records_path)
    with pytest.raises(TypeError, match="bogus"):
        kcmc_tpu_torch.config_from_dict({"bogus": 1})
