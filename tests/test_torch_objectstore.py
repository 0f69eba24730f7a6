"""The port's object store (`kcmc_tpu_torch.io.objectstore`) against
kcmc_tpu.io.objectstore: byte-identical buckets (every chunk object and
both manifest generations) for the same frames and options, each
package reading the other's buckets; the emulator and every fault case
of the reference's suite run through both packages with the same
`FaultPlan` spec and seed, with equal observations (arrays, errors and
their messages, deterministic counters); hedged reads; the config's
`object_*` fields; and the port's `correct_file` through `emu://`
(`device="cpu"`): equal to its local-file run, a fault storm and a
killed-and-resumed run byte-equal to a clean run. kcmc_tpu.io imports
no JAX, so nothing here compiles."""

import importlib
import os
import subprocess
import sys
import textwrap
import time
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import kcmc_tpu
import kcmc_tpu_torch
from kcmc_tpu_torch.config import SIG_NEUTRAL_FIELDS
from kcmc_tpu_torch.io import objectstore as tobj
from kcmc_tpu_torch.io import open_stack
from kcmc_tpu_torch.utils.faults import FatalFaultError, FaultPlan, RetryPolicy
from kcmc_tpu_torch.utils.synthetic import make_drift_stack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return SimpleNamespace(name=root, obj=mod("io.objectstore"), formats=mod("io.formats"),
                           faults=mod("utils.faults"), metrics=mod("utils.metrics"))


REF, PORT = _pkg("kcmc_tpu"), _pkg("kcmc_tpu_torch")
# near-zero backoff: these tests exercise retry LOGIC, not the sleeps
FAST = dict(seed=0, backoff_s=1e-4, backoff_max_s=2e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: torch's intra-op threads only slow them
    down when several test processes share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_url_state():
    # per-URL hedge histograms and counters are module-global: isolate
    # the tests, and join the lazy hedge pools so no worker outlives one
    for p in (REF, PORT):
        p.obj.reset_url_state()
    yield
    for p in (REF, PORT):
        p.obj._shutdown_hedge_pool(wait=True)
        p.obj.reset_url_state()


def _objects(client) -> dict:
    """{key: bytes} of every object of a bucket (chunks and manifests)."""
    return {k: client.get(k) for k in client.list("")}


def _stats(p, url) -> dict:
    """The deterministic counters of a URL (its live p95 is a timing)."""
    snap = p.obj.stats_snapshot(url)
    return {k: v for k, v in snap.items() if k not in ("p95_ms", "hedge_rate")}


def _stack(seed, shape, dtype=np.uint16):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.normal(0, 100, shape).astype(dtype)
    return rng.integers(0, 60000, shape).astype(dtype)


# ---------------------------------------------------------------------------
# the bucket format: byte for byte


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("compression", ["none", "deflate"])
@pytest.mark.parametrize("chunk_frames", [4, 8])
def test_put_stack_buckets_byte_identical(tmp_path, dtype, compression, chunk_frames):
    """put_stack of the same 13 frames (a tail chunk) writes the
    reference's bucket byte for byte — every chunk object and both
    manifest generations — and each package reads the other's."""
    stack = _stack(1, (13, 24, 20), dtype)
    buckets = {}
    for p in (REF, PORT):
        url = f"emu://{tmp_path}/{p.name}"
        p.obj.put_stack(url, stack, chunk_frames=chunk_frames, compression=compression,
                        part_bytes=2048)
        buckets[p.name] = _objects(p.obj.client_for_url(url))
    assert buckets["kcmc_tpu"] == buckets["kcmc_tpu_torch"]
    assert tobj.MANIFEST_KEY in buckets["kcmc_tpu"] and tobj.PREV_MANIFEST_KEY in buckets["kcmc_tpu"]
    for reader, writer in ((REF, PORT), (PORT, REF)):
        with reader.formats.open_stack(f"emu://{tmp_path}/{writer.name}") as ts:
            assert (len(ts), ts.frame_shape, ts.dtype) == (13, (24, 20), np.dtype(dtype))
            np.testing.assert_array_equal(ts.read(0, 13), stack)
            np.testing.assert_array_equal(ts.read(3, 10), stack[3:10])


@pytest.mark.parametrize("compression", ["none", "deflate"])
def test_streaming_writer_byte_identical(tmp_path, compression):
    """ObjectStoreWriter through make_writer, appended in uneven batches
    with checkpoint_state between them (each flushes the partial tail):
    the same states and, after every step, the same bucket."""
    stack = _stack(2, (23, 16, 12))
    writers = {p.name: p.formats.make_writer(
        f"emu://{tmp_path}/{p.name}", 23, (16, 12), np.uint16, compression=compression,
        object_opts={"chunk_frames": 5, "part_bytes": 1024}) for p in (REF, PORT)}
    lo = 0
    for hi in (3, 4, 12, 20, 23):
        states = {k: None for k in writers}
        for k, w in writers.items():
            w.append_batch(stack[lo:hi])
            states[k] = w.checkpoint_state()
        assert states["kcmc_tpu"] == states["kcmc_tpu_torch"]
        assert states["kcmc_tpu"]["n_pages"] == hi
        assert (_objects(REF.obj.client_for_url(f"emu://{tmp_path}/kcmc_tpu"))
                == _objects(PORT.obj.client_for_url(f"emu://{tmp_path}/kcmc_tpu_torch")))
        lo = hi
    for w in writers.values():
        w.close()
    with PORT.formats.open_stack(f"emu://{tmp_path}/kcmc_tpu") as ts:
        np.testing.assert_array_equal(ts.read(0, 23), stack)


# ---------------------------------------------------------------------------
# the emulator and the fault surface: both packages, the same cases


def _case_roundtrip(p, root):
    stack = _stack(0, (50, 8, 9))
    url = f"emu://{root}/b"
    p.obj.put_stack(url, stack, chunk_frames=7)
    with p.formats.open_stack(url) as ts:
        got = [np.array_equal(ts.read(lo, hi), stack[lo:hi])
               for lo, hi in ((0, 50), (3, 23), (6, 8), (49, 50))]
        meta = (len(ts), ts.frame_shape, str(ts.dtype))
    bz = f"emu://{root}/bz"
    p.obj.put_stack(bz, stack[:30], chunk_frames=7, compression="deflate")
    with p.formats.open_stack(bz) as ts:
        got.append(np.array_equal(ts.read(5, 26), stack[5:26]))
        got.append(ts.compression)
    return {"equal": got, "meta": meta, "stats": _stats(p, url)}


def _case_multipart_staging(p, root):
    store = p.obj.EmulatedObjectStore(os.path.join(root, "b"))
    uid = store.multipart_begin("big")
    store.multipart_put_part("big", uid, 0, b"aaaa")
    store.multipart_put_part("big", uid, 1, b"bbbb")
    staged = store.list("")  # staged parts are not objects
    try:
        store.head("big")
        head = None
    except p.obj.ObjectNotFound as e:
        head = type(e).__name__
    etag = store.multipart_complete("big", uid, 2)
    uid2 = store.multipart_begin("torn")
    store.multipart_put_part("torn", uid2, 0, b"x")
    try:
        store.multipart_complete("torn", uid2, 2)
        torn = None
    except OSError as e:
        torn = str(e).split(": ", 1)[1]
    store.multipart_abort("torn", uid2)
    return {"staged": staged, "head": head, "body": store.get("big"), "etag": etag,
            "torn": torn, "listed": store.list("")}


def _case_unregistered_scheme(p, root):
    try:
        p.obj.client_for_url("s3://bucket/stack")
    except ValueError as e:
        return {"error": str(e).replace(p.name + ".", "<pkg>.")}
    return {"error": None}


def _case_fault(p, root, spec, span):
    stack = _stack(2, (40, 6, 5))
    url = f"emu://{root}/b"
    p.obj.put_stack(url, stack, chunk_frames=8)
    rep = p.metrics.RobustnessReport()
    ts = p.obj.ObjectStack(url).arm(
        fault_plan=p.faults.FaultPlan.from_spec(spec, seed=1),
        retry=p.faults.RetryPolicy(**FAST), report=rep)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        first = np.array_equal(ts.read(*span), stack[span[0]:span[1]])
        again = np.array_equal(ts.read(0, 8), stack[:8])
    return {"equal": (first, again), "io_retries": rep.io_retries,
            "quarantined": rep.quarantined_parts, "stats": _stats(p, url),
            # the port has no CLI yet, so its advice names only the field
            "warned": [str(w.message).replace(root, "<root>").replace(" (CLI --io-threads)", "")
                       for w in rec]}


def _case_stall_deadline(p, root):
    stack = _stack(6, (16, 6, 5))
    url = f"emu://{root}/b"
    p.obj.put_stack(url, stack, chunk_frames=4)
    ts = p.obj.ObjectStack(url).arm(
        fault_plan=p.faults.FaultPlan.from_spec("object:step=1:stall=30", seed=1),
        retry=p.faults.RetryPolicy(seed=0, backoff_s=1e-4, deadline_s=0.05))
    t0 = time.perf_counter()
    equal = np.array_equal(ts.read(0, 8), stack[:8])
    # the wedged GET cost one deadline, not the 30 s stall
    return {"equal": equal, "fast": time.perf_counter() - t0 < 2.0, "stats": _stats(p, url)}


def _case_at_rest_quarantine(p, root):
    stack = _stack(7, (40, 6, 5))
    url = f"emu://{root}/b"
    p.obj.put_stack(url, stack, chunk_frames=8)
    client = p.obj.client_for_url(url)
    body = bytearray(client.get("chunk-00000001"))
    body[4] ^= 0xFF
    client.put("chunk-00000001", bytes(body))
    rep = p.metrics.RobustnessReport()
    ts = p.obj.ObjectStack(url).arm(retry=p.faults.RetryPolicy(**FAST), report=rep)
    try:
        ts.read(0, 40)
        err = None
    except p.obj.ObjectIntegrityError as e:
        err = str(e).replace(root, "<root>")
    return {"error": err, "corrupt": client.list("chunk-00000001.corrupt"),
            "quarantined": [q.replace(root, "<root>") for q in rep.quarantined_parts]}


def _case_corrupt_manifest(p, root):
    stack = _stack(10, (20, 6, 5))
    url = f"emu://{root}/b"
    w = p.obj.ObjectStoreWriter(url, 20, (6, 5), np.uint16, chunk_frames=8)
    w.append_batch(stack)
    w.close()
    client = p.obj.client_for_url(url)
    good = p.obj.load_manifest(client)
    client.put(p.obj.MANIFEST_KEY, client.get(p.obj.MANIFEST_KEY)[:-20] + b"garbage!")
    rep = p.metrics.RobustnessReport()
    man = p.obj.load_manifest(client, report=rep)
    listed = client.list(p.obj.MANIFEST_KEY + ".corrupt")
    client.delete(p.obj.MANIFEST_KEY)
    client.delete(p.obj.PREV_MANIFEST_KEY)
    try:
        p.obj.load_manifest(client)
        gone = None
    except p.obj.ObjectNotFound as e:
        gone = type(e).__name__
    return {"good": good, "rewound": man, "listed": listed, "gone": gone,
            "quarantined": [q.replace(root, "<root>") for q in rep.quarantined_parts]}


def _case_torn_multipart(p, root):
    stack = _stack(11, (8, 32, 32))
    url = f"emu://{root}/b"
    w = p.obj.ObjectStoreWriter(
        url, 8, (32, 32), np.uint16, chunk_frames=8, part_bytes=4096,
        fault_plan=p.faults.FaultPlan.from_spec("object:step=1:truncate", seed=1),
        retry=p.faults.RetryPolicy(**FAST))
    w.append_batch(stack)
    w.close()
    with p.formats.open_stack(url) as ts:
        equal = np.array_equal(ts.read(0, 8), stack)
    return {"equal": equal, "stats": _stats(p, url),
            "objects": _objects(p.obj.client_for_url(url))}


def _case_writer_resume(p, root):
    stack = _stack(12, (50, 8, 9))
    url, url2 = f"emu://{root}/out", f"emu://{root}/ref"
    w = p.formats.make_writer(url, 50, (8, 9), np.uint16, object_opts={"chunk_frames": 7})
    w.append_batch(stack[:10])
    state = w.checkpoint_state()  # flushes the 3-frame partial tail
    w2 = p.formats.resume_writer(url, state, object_opts={"chunk_frames": 7})
    n_resumed = w2.n_pages
    puts_before = p.obj.stats_snapshot(url)["puts"]
    w2.append_batch(stack[10:50])
    w2.close()
    w3 = p.formats.make_writer(url2, 50, (8, 9), np.uint16, object_opts={"chunk_frames": 7})
    w3.append_batch(stack)
    w3.close()
    ref = _objects(p.obj.client_for_url(url2))
    got = _objects(p.obj.client_for_url(url))
    return {"state": {k: v for k, v in state.items() if k != "zlib"}, "resumed_at": n_resumed,
            "chunks_equal": ({k: v for k, v in got.items() if "prev" not in k}
                             == {k: v for k, v in ref.items() if "prev" not in k}),
            "resumed_puts": p.obj.stats_snapshot(url)["puts"] - puts_before,
            "full_puts": p.obj.stats_snapshot(url2)["puts"]}


def _case_resume_refusals(p, root):
    stack = _stack(13, (20, 6, 5))
    out = {}
    url = f"emu://{root}/out"
    w = p.obj.ObjectStoreWriter(url, 20, (6, 5), np.uint16, chunk_frames=8)
    w.append_batch(stack[:8])
    state = w.checkpoint_state()
    client = p.obj.client_for_url(url)
    client.put("chunk-00000000", b"not the chunk")
    rep = p.metrics.RobustnessReport()
    try:
        p.obj.ObjectStoreWriter.resume(url, state, object_opts={
            "report": rep, "retry": p.faults.RetryPolicy(**FAST)})
    except OSError as e:
        out["corrupt"] = str(e).replace(root, "<root>")
    out["quarantined"] = len(rep.quarantined_parts)
    url2 = f"emu://{root}/out2"
    w2 = p.obj.ObjectStoreWriter(url2, 20, (6, 5), np.uint16, chunk_frames=8)
    w2.append_batch(stack[:8])
    w2.checkpoint_state()
    try:
        p.obj.ObjectStoreWriter.resume(url2, {"format": "object", "n_pages": 16})
    except OSError as e:
        out["behind"] = str(e).replace(root, "<root>")
    return out


CASES = {
    "roundtrip": _case_roundtrip,
    "multipart_staging": _case_multipart_staging,
    "unregistered_scheme": _case_unregistered_scheme,
    "drop": lambda p, r: _case_fault(p, r, "object:step=2:drop", (0, 40)),
    "throttle": lambda p, r: _case_fault(p, r, "object:step=1:throttle", (0, 40)),
    "flip": lambda p, r: _case_fault(p, r, "object:step=2:flip", (0, 40)),
    "truncate": lambda p, r: _case_fault(p, r, "object:step=0:truncate", (3, 5)),
    "stall_deadline": _case_stall_deadline,
    "at_rest_quarantine": _case_at_rest_quarantine,
    "corrupt_manifest": _case_corrupt_manifest,
    "torn_multipart": _case_torn_multipart,
    "writer_resume": _case_writer_resume,
    "resume_refusals": _case_resume_refusals,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulator_and_fault_cases_match_reference(tmp_path, case):
    """Each case of the reference's suite through both packages (the
    same FaultPlan spec and seed): equal observations."""
    obs = {}
    for p in (REF, PORT):
        root = str(tmp_path / p.name)
        os.makedirs(root)
        obs[p.name] = CASES[case](p, root)
    got, want = obs["kcmc_tpu_torch"], obs["kcmc_tpu"]
    assert got == want
    # and what each case is about, so equality is not vacuous
    checks = {
        "roundtrip": lambda o: all(o["equal"][:5]) and o["stats"]["gets"] >= 4,
        "multipart_staging": lambda o: (o["staged"] == [] and o["head"] == "ObjectNotFound"
                                        and o["body"] == b"aaaabbbb" and o["listed"] == ["big"]
                                        and "missing part 1" in o["torn"]),
        "unregistered_scheme": lambda o: "<pkg>.io.objectstore.register_scheme" in o["error"],
        "drop": lambda o: all(o["equal"]) and o["io_retries"] == 1 and o["stats"]["retries"] == 1,
        "throttle": lambda o: (o["stats"]["throttled"] == 1 and len(o["warned"]) == 1
                               and "object-store path degrading" in o["warned"][0]),
        "flip": lambda o: o["stats"]["refetched"] == 1 and o["quarantined"] == [],
        "truncate": lambda o: all(o["equal"]) and o["stats"]["retries"] == 1,
        "stall_deadline": lambda o: o["equal"] and o["fast"] and o["stats"]["retries"] == 1,
        "at_rest_quarantine": lambda o: ("quarantined" in o["error"] and len(o["quarantined"]) == 1
                                         and o["corrupt"] == ["chunk-00000001.corrupt"]),
        "corrupt_manifest": lambda o: (o["rewound"]["n_frames"] < o["good"]["n_frames"]
                                       and o["listed"] == [".manifest.json.corrupt"]
                                       and o["gone"] == "ObjectNotFound"),
        "torn_multipart": lambda o: o["equal"] and o["stats"]["retries"] >= 1,
        "writer_resume": lambda o: (o["resumed_at"] == 10 and o["chunks_equal"]
                                    and o["resumed_puts"] < o["full_puts"]),
        "resume_refusals": lambda o: ("corrupt at resume" in o["corrupt"] and o["quarantined"]
                                      and "behind the checkpoint cursor" in o["behind"]),
    }
    assert checks[case](got), got


@pytest.mark.parametrize("src,want", [
    ("emu://bucket/x", True), ("s3://bucket/x", True), ("gs://bucket/x", True),
    ("file:///no/such/x.tif", False), ("http://host/no/such/x.tif", False),
    ("/no/such/x.tif", False), (3, False), (None, False),
])
def test_is_object_url_matches_reference(src, want):
    """One is_object_url, the object store's: registered schemes plus s3
    and gs. Any other string is a local path to both packages (the port
    once took every scheme:// for an object URL and raised on it)."""
    assert REF.obj.is_object_url(src) is want
    assert PORT.obj.is_object_url(src) is want
    if isinstance(src, str) and not want:
        for p in (REF, PORT):
            with pytest.raises(FileNotFoundError):
                p.formats.open_stack(src)


# ---------------------------------------------------------------------------
# hedged reads (the port's; timing margins sized for a loaded host)


def test_hedge_fires_past_p95_and_first_wins(tmp_path):
    stack = _stack(8, (64, 6, 5))
    url = f"emu://{tmp_path}/b"
    tobj.put_stack(url, stack, chunk_frames=4)
    ts = tobj.ObjectStack(url).arm(retry=RetryPolicy(seed=0, backoff_s=1e-4, deadline_s=10.0),
                                   hedge_ms=30.0)
    for i in range(tobj._HEDGE_WARMUP + 2):  # warm the live histogram
        ts.read(i % 60, i % 60 + 1)
    assert tobj.stats_snapshot(url)["hedged"] == 0
    # the next primary GET stalls 1.5 s, far past p95 (floored at 30 ms):
    # the hedge fires and wins without waiting out the primary
    ts._client.fault_plan = FaultPlan.from_spec("object:step=0:stall=1.5", seed=1)
    t0 = time.perf_counter()
    np.testing.assert_array_equal(ts.read(0, 4), stack[0:4])
    assert time.perf_counter() - t0 < 1.4
    snap = tobj.stats_snapshot(url)
    assert snap["hedged"] >= 1 and snap["hedge_wins"] >= 1 and snap["p95_ms"] is not None


def test_hedge_disabled_at_zero(tmp_path):
    stack = _stack(9, (64, 6, 5))
    url = f"emu://{tmp_path}/b"
    tobj.put_stack(url, stack, chunk_frames=4)
    ts = tobj.ObjectStack(url).arm(retry=RetryPolicy(**FAST), hedge_ms=0.0)
    for i in range(tobj._HEDGE_WARMUP + 4):
        ts.read(i % 60, i % 60 + 1)
    assert ts._hedge_threshold() is None
    assert tobj.stats_snapshot(url)["hedged"] == 0


# ---------------------------------------------------------------------------
# config and the corrector's wiring


def test_object_config_fields_match_reference():
    jc, tc = kcmc_tpu.CorrectorConfig(), kcmc_tpu_torch.CorrectorConfig()
    for name in ("object_timeout_s", "object_hedge_ms", "object_chunk_frames",
                 "object_part_bytes"):
        assert getattr(tc, name) == getattr(jc, name)
        assert name in SIG_NEUTRAL_FIELDS
    assert (tc.object_timeout_s, tc.object_hedge_ms, tc.object_chunk_frames,
            tc.object_part_bytes) == (30.0, 50.0, 64, 8 << 20)
    # the io retry policy carries the per-attempt deadline
    from kcmc_tpu_torch.utils.faults import default_io_retry_policy

    assert default_io_retry_policy(tc.replace(object_timeout_s=2.5)).deadline_s == 2.5


@pytest.mark.parametrize("kw", [
    {"object_timeout_s": 0.0}, {"object_timeout_s": -1.0}, {"object_hedge_ms": -1.0},
    {"object_chunk_frames": 0}, {"object_part_bytes": 0},
])
def test_object_config_checks_match(kw):
    errs = []
    for cls in (kcmc_tpu.CorrectorConfig, kcmc_tpu_torch.CorrectorConfig):
        with pytest.raises(ValueError) as e:
            cls(**kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_input_fingerprint_of_url_matches_reference(tmp_path):
    from kcmc_tpu import corrector as jcorrector
    from kcmc_tpu_torch import corrector as tcorrector

    url = f"emu://{tmp_path}/b"
    tobj.put_stack(url, _stack(3, (9, 8, 8)), chunk_frames=4)
    got = tcorrector._input_fingerprint(url)
    assert got == jcorrector._input_fingerprint(url)
    assert got[0] == "object" and len(got[1]) == 64


SHAPE = (64, 64)
KW = dict(device="cpu", batch_size=4, max_keypoints=128,
          retry_backoff_s=1e-4, retry_backoff_max_s=2e-4)
STORM = ("object:step=1:drop, object:step=2:stall=0.2, object:step=3:flip, "
         "object:step=5:truncate, object:step=6:throttle")


@pytest.fixture(scope="module")
def bucket(tmp_path_factory):
    """8 frames of 64x64 drift as uint16, in a bucket (4-frame chunk
    objects) and in a local TIFF, and the port's local-file run."""
    from kcmc_tpu_torch.io import write_stack

    d = make_drift_stack(8, SHAPE, seed=0)
    stack = np.clip(d.stack * 40000, 0, 65535).astype(np.uint16)
    root = tmp_path_factory.mktemp("objects")
    url, tif = f"emu://{root}/in", str(root / "in.tif")
    tobj.put_stack(url, stack, chunk_frames=4)
    write_stack(tif, stack)
    local = kcmc_tpu_torch.MotionCorrector(**KW).correct_file(tif)
    return {"url": url, "root": root, "tif": tif, "stack": stack, "local": local}


def _read(url):
    with open_stack(url) as ts:
        return ts.read(0, len(ts))


@pytest.mark.parametrize("io_workers", [0, 2])
def test_correct_file_through_emu_equals_local_file(bucket, io_workers):
    """emu:// in and out: the frames and transforms of the local-file
    run; io_workers=2 reads through the thread-flavor decode pool (per-
    worker clients by the URL respec); timing carries the ingest and
    egress counters."""
    out = f"emu://{bucket['root']}/out{io_workers}"
    res = kcmc_tpu_torch.MotionCorrector(io_workers=io_workers, **KW).correct_file(
        bucket["url"], output=out)
    np.testing.assert_array_equal(_read(out), bucket["local"].corrected)
    np.testing.assert_array_equal(res.transforms, bucket["local"].transforms)
    obj = res.timing["feeder"]["object"]
    assert obj["ingest"]["gets"] > 0 and obj["egress"]["puts"] > 0
    assert obj["ingest"]["retries"] == 0
    if io_workers == 2:
        assert res.timing["feeder"]["mode"] == "thread"
    from kcmc_tpu_torch import apply_correction_file

    # apply_correction_file takes object URLs too
    applied = f"emu://{bucket['root']}/applied{io_workers}"
    apply_correction_file(bucket["url"], applied, transforms=res.transforms, device="cpu")
    assert _read(applied).shape == bucket["stack"].shape


def test_fault_storm_is_byte_identical(bucket):
    """Drop, stall, flip, truncate and throttle across the ingest and
    egress of one run (io_workers=1: every GET rides the consumer's armed
    reader; pooled workers arm only from KCMC_FAULT_PLAN, as the
    reference's): zero loss, the clean run's bucket byte for byte."""
    root = bucket["root"]
    clean = f"emu://{root}/clean"
    kcmc_tpu_torch.MotionCorrector(object_chunk_frames=4, **KW).correct_file(
        bucket["url"], output=clean)
    storm = f"emu://{root}/storm"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the throttle advisory
        res = kcmc_tpu_torch.MotionCorrector(
            object_chunk_frames=4, io_workers=1, fault_plan=STORM, object_timeout_s=2.0,
            **KW).correct_file(bucket["url"], output=storm)
    assert res.timing["robustness"]["faults_injected"] == 5
    assert res.timing["robustness"]["io_retries"] >= 1
    assert (_objects(tobj.client_for_url(storm)) == _objects(tobj.client_for_url(clean)))


def test_kill_and_resume_is_byte_identical(bucket, tmp_path):
    """Killed on the consumer side (device:step=1:fatal) and resumed from
    its checkpoint: the bucket (chunks and both manifests) of an
    uninterrupted run, with fewer PUTs. Two-frame chunk objects: a
    resumed writer rewrites the rewind generation (.manifest.prev.json)
    from its second manifest flush on, as the reference's does."""
    root = bucket["root"]
    run = dict(chunk_size=4, checkpoint_every=4)
    ref = f"emu://{root}/ref"
    kcmc_tpu_torch.MotionCorrector(object_chunk_frames=2, **KW).correct_file(
        bucket["url"], output=ref, checkpoint=str(tmp_path / "ref.npz"), **run)
    out, ckpt = f"emu://{root}/killed", str(tmp_path / "kill.npz")
    with pytest.raises(FatalFaultError):
        kcmc_tpu_torch.MotionCorrector(object_chunk_frames=2, fault_plan="device:step=1:fatal",
                                       **KW).correct_file(bucket["url"], output=out,
                                                          checkpoint=ckpt, **run)
    before = tobj.stats_snapshot(out)["puts"]
    res = kcmc_tpu_torch.MotionCorrector(object_chunk_frames=2, **KW).correct_file(
        bucket["url"], output=out, checkpoint=ckpt, **run)
    assert res.timing["restored_frames"] == 4
    assert _objects(tobj.client_for_url(out)) == _objects(tobj.client_for_url(ref))
    assert tobj.stats_snapshot(out)["puts"] - before < tobj.stats_snapshot(ref)["puts"]


def test_decode_worker_opens_emu_source_without_torch(tmp_path):
    """A decode-pool worker respecs an object source by URL and opens it
    with torch, jax and kcmc_tpu blocked (`kcmc_tpu_torch.io`, its
    `utils.faults` and `obs.latency`, and numpy only)."""
    stack = _stack(4, (10, 12, 8))
    url = f"emu://{tmp_path}/b"
    tobj.put_stack(url, stack, chunk_frames=4)
    from kcmc_tpu_torch.io import feeder

    with tobj.ObjectStack(url) as ts:
        spec = feeder.source_spec(ts, None, None)
        assert feeder.classify_source(ts) == "thread"
    assert spec == ("stack", url, ())
    code = textwrap.dedent(
        f"""
        import sys
        for m in ("torch", "jax", "kcmc_tpu"):
            sys.modules[m] = None
        import numpy as np
        import kcmc_tpu_torch.io.objectstore, kcmc_tpu_torch.obs.latency
        from kcmc_tpu_torch.io import feeder
        got = feeder._decode_span({spec!r}, 2, 9)
        assert got.shape == (7, 12, 8), got.shape
        bad = [m for m in sys.modules if m.startswith(("torch", "jax", "kcmc_tpu."))
               and sys.modules[m] is not None]
        assert not bad, bad
        print(int(got.astype(np.int64).sum()))
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": REPO}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == int(stack[2:9].astype(np.int64).sum())
    deflated = f"emu://{tmp_path}/z"
    tobj.put_stack(deflated, stack, chunk_frames=4, compression="deflate")
    with tobj.ObjectStack(deflated) as ts:
        assert feeder.classify_source(ts) == "process"
