"""Object-store-native ingest/egress with a built-in emulator (the
port's copy of kcmc_tpu/io/objectstore.py).

Production frame stacks live in GCS/S3 buckets, and the network is the
least reliable component in the pipeline — so the cloud path ships
WITH its fault model, not before it. This module is both halves:

* **Client abstraction** — `ObjectStoreClient` is a small protocol
  (range GET, atomic PUT, multipart PUT, list/head/rename/delete) any
  real cloud SDK can implement behind `register_scheme`. The built-in
  `EmulatedObjectStore` (scheme ``emu://``) backs a "bucket" with a
  local directory — atomic PUTs via tmp+rename, multipart staging that
  keeps incomplete uploads invisible, sha256 etags — so CI exercises
  every cloud failure mode with zero network access. The emulator is
  also the fault-injection point: armed with a `FaultPlan`, every op
  draws one ``object``-surface index and applies the matched clause
  (drop/throttle raise, ``stall=`` sleeps against the per-attempt
  deadline, ``truncate``/``flip`` mangle bodies so the checksum layer
  has something real to catch).

* **ObjectStack** — the streaming-reader protocol over a chunked
  bucket layout (Zarr-style: one ``chunk-NNNNNNNN`` object per
  ``chunk_frames`` frames plus a checksummed manifest). Reads ride the
  shared jittered `RetryPolicy` with per-attempt deadline caps;
  **hedged reads** fire a second ranged GET when the first exceeds the
  live latency-histogram p95 (first-wins, loser cancelled); corrupt
  bodies quarantine-and-refetch exactly like stream-checkpoint parts
  (in-flight corruption refetches; at-rest corruption quarantines the
  object and aborts loudly). Pickles by URL: `feeder.source_spec`
  respecs it, so `pooled_chunks` workers open per-worker connections
  and share the per-URL hedge/latency state in-process.

* **ObjectStoreWriter** — sharded cloud-native egress with the
  TiffWriter streaming protocol (`append_batch` / `checkpoint_state` /
  `close` / `n_pages`), so it slots under `AsyncBatchWriter` and the
  checkpoint machinery unchanged. Chunk objects upload via multipart
  PUT (verified: a torn/mangled upload fails the etag check and
  retries); a **durable high-water-mark manifest** (atomic,
  self-checksummed, previous generation kept as the rewind point)
  advances after every completed chunk, and `checkpoint_state()`
  flushes the partial tail first — so kill -9 → restart → resume
  re-uploads only past the manifest's high-water mark and the final
  chunk set is byte-identical to an uninterrupted run.

Bucket layout (one stack per URL prefix; keys relative to it)::

    chunk-00000000        frames [0, chunk_frames) — raw or zlib(6)
    chunk-00000001        frames [chunk_frames, 2*chunk_frames)
    ...
    .manifest.json        {"manifest": {...}, "sha256": <self-check>}
    .manifest.prev.json   previous manifest generation (rewind point)

The manifest records shape/dtype/compression/chunk_frames, the durable
frame count, and one ``{key, frames, sha256, size}`` entry per chunk —
everything deterministic (sorted-keys JSON, no timestamps), so resumed
and uninterrupted runs produce byte-identical manifests too — and the
port writes the reference's buckets byte for byte.

Imports numpy and the port's `utils.faults` / `obs` modules only (no
torch), so decode-pool workers open object sources light.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import threading
import time
import zlib
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from concurrent.futures import wait as _fut_wait

import numpy as np

from kcmc_tpu_torch.utils.faults import (
    FatalFaultError,
    TransientFaultError,
    classify_transient,
    default_io_retry_policy,
    resolve_fault_plan,
)

MANIFEST_KEY = ".manifest.json"
PREV_MANIFEST_KEY = ".manifest.prev.json"
_MANIFEST_FORMAT = "kcmc-object-v1"

# Defaults for standalone (non-corrector) users; CorrectorConfig's
# object_* fields override via arm()/make_writer object_opts.
_DEFAULT_CHUNK_FRAMES = 64
_DEFAULT_PART_BYTES = 8 << 20
_DEFAULT_HEDGE_MS = 50.0
_DEFAULT_TIMEOUT_S = 30.0
# Hedging needs a live p95 before it can mean anything: below this many
# recorded GETs the first read of a cold bucket would hedge against an
# empty histogram.
_HEDGE_WARMUP = 16


class ObjectStoreError(OSError):
    """Base object-store failure (classified transient by the retry
    engine unless a permanent subclass)."""


class ObjectNotFound(FileNotFoundError, ObjectStoreError):
    """Missing object/bucket — permanent; retrying cannot help."""


class ObjectStoreThrottled(ObjectStoreError):
    """HTTP 429/503-style backpressure from the store — transient, but
    counted separately so the degradation advisory can name it."""


class ObjectIntegrityError(RuntimeError):
    """At-rest corruption: the STORED object no longer matches its
    manifest checksum. Refetching cannot recover the bytes, so this is
    fatal (RuntimeError — `classify_transient` returns False); the
    corrupt object is quarantined (renamed ``*.corrupt``) before this
    raises, leaving the evidence for the operator."""


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# ---------------------------------------------------------------------------
# URL scheme registry
# ---------------------------------------------------------------------------

_SCHEMES: dict[str, object] = {}


def register_scheme(scheme: str, factory) -> None:
    """Register ``factory(path) -> client`` for ``<scheme>://<path>``
    URLs — the seam a real S3/GCS client plugs into."""
    _SCHEMES[str(scheme)] = factory


def is_object_url(source) -> bool:
    """True when `source` is an object-store URL string
    (``emu://...``, ``s3://...``, ``gs://...``)."""
    if not isinstance(source, str):
        return False
    scheme, sep, _rest = source.partition("://")
    return bool(sep) and (scheme in _SCHEMES or scheme in ("s3", "gs"))


def client_for_url(url: str, fault_plan=None):
    """Build the client for an object URL. ``emu://`` maps the URL path
    to a local bucket directory; ``s3://``/``gs://`` point at the
    `register_scheme` seam (no cloud SDK is baked into this build)."""
    url = str(url)
    scheme, sep, path = url.partition("://")
    if not sep:
        raise ValueError(f"not an object-store URL: {url!r}")
    factory = _SCHEMES.get(scheme)
    if factory is None:
        raise ValueError(
            f"no client registered for scheme {scheme!r} ({url!r}); this "
            "build ships the emu:// emulator only — implement the "
            "ObjectStoreClient protocol over your cloud SDK and add it "
            "via kcmc_tpu_torch.io.objectstore.register_scheme"
        )
    client = factory(path)
    if fault_plan is not None:
        client.fault_plan = fault_plan
    return client


# ---------------------------------------------------------------------------
# the in-process emulator
# ---------------------------------------------------------------------------


class EmulatedObjectStore:
    """Directory-backed object store with cloud PUT/GET semantics.

    One instance per "bucket" (a stack prefix): keys are paths relative
    to `root`. PUTs are atomic (tmp file + `os.replace`); multipart
    uploads stage parts under ``.multipart/<upload_id>/`` and become
    visible only at complete (assembled, then atomically renamed) — a
    kill mid-upload leaves no partial object, exactly the cloud
    contract. Etags are sha256 of the full object content, computed
    from disk so at-rest corruption is observable through `head`.

    `fault_plan` arms the ``object`` fault surface: every op draws one
    op index and applies any matched clause — see the module docstring.
    Instances are cheap and stateless beyond the root path, so
    per-worker "connections" are simply per-worker instances.
    """

    scheme = "emu"

    def __init__(self, root, fault_plan=None):
        self.root = os.fspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.fault_plan = fault_plan
        self._tmp_count = 0
        self._tmp_lock = threading.Lock()

    def url(self, key: str = "") -> str:
        return f"emu://{self.root}" + (f"/{key}" if key else "")

    def _path(self, key: str) -> str:
        key = str(key)
        p = os.path.normpath(os.path.join(self.root, key))
        if not p.startswith(os.path.normpath(self.root)):
            raise ValueError(f"object key escapes the bucket: {key!r}")
        return p

    def _gate(self, op: str, deadline_s: float | None) -> str | None:
        """Apply any matched object-surface fault clause to this op.
        Returns "truncate"/"flip" for the caller to mangle the body, or
        None; raising clauses raise here. A stall longer than the
        per-attempt deadline sleeps only the deadline, then times out
        as a transient — one wedged request can never cost more than
        `deadline_s` before the retry/hedge machinery takes over."""
        plan = self.fault_plan
        if plan is None:
            return None
        step = plan.op_index("object")
        stall = plan.take_stall("object", step)
        if stall > 0.0:
            if deadline_s is not None and stall > float(deadline_s):
                time.sleep(float(deadline_s))
                raise TimeoutError(
                    f"object {op} exceeded the {float(deadline_s):.3g}s "
                    f"per-attempt deadline (stalled {stall:.3g}s)"
                )
            time.sleep(stall)
        act = plan.take_action("object", step)
        if act == "transient":
            raise TransientFaultError(
                f"injected object fault: connection dropped during {op} "
                f"[step={step}]"
            )
        if act == "fatal":
            raise FatalFaultError(
                f"injected fatal object fault during {op} [step={step}]"
            )
        if act == "throttle":
            raise ObjectStoreThrottled(
                f"injected throttle: HTTP 429 Too Many Requests during "
                f"{op} [step={step}]"
            )
        return act  # None | truncate | flip

    @staticmethod
    def _mangle(act: str | None, data: bytes) -> bytes:
        if act == "truncate" and data:
            return data[: len(data) // 2]
        if act == "flip" and data:
            i = len(data) // 2
            return data[:i] + bytes([data[i] ^ 0x40]) + data[i + 1:]
        return data

    def _tmp(self) -> str:
        with self._tmp_lock:
            self._tmp_count += 1
            n = self._tmp_count
        return os.path.join(
            self.root, f".tmp-{os.getpid()}-{threading.get_ident()}-{n}"
        )

    def _write_atomic(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = self._tmp()
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    # -- ops ---------------------------------------------------------------

    def head(self, key: str, deadline_s: float | None = None) -> dict:
        self._gate("HEAD", deadline_s)
        p = self._path(key)
        try:
            with open(p, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise ObjectNotFound(f"{self.url(key)}: no such object") from None
        return {"size": len(data), "etag": sha256_hex(data)}

    def get(
        self,
        key: str,
        start: int = 0,
        length: int | None = None,
        deadline_s: float | None = None,
    ) -> bytes:
        """Ranged GET: bytes [start, start+length) of the object (the
        whole object with the defaults)."""
        act = self._gate("GET", deadline_s)
        p = self._path(key)
        try:
            with open(p, "rb") as f:
                f.seek(int(start))
                body = f.read() if length is None else f.read(int(length))
        except FileNotFoundError:
            raise ObjectNotFound(f"{self.url(key)}: no such object") from None
        return self._mangle(act, body)

    def put(
        self, key: str, data: bytes, deadline_s: float | None = None
    ) -> str:
        """Atomic PUT; returns the etag of the STORED content (so a
        mangled upload is detectable by the caller's verify)."""
        act = self._gate("PUT", deadline_s)
        stored = self._mangle(act, bytes(data))
        self._write_atomic(self._path(key), stored)
        return sha256_hex(stored)

    # -- multipart ---------------------------------------------------------

    def multipart_begin(self, key: str, deadline_s: float | None = None) -> str:
        self._gate("MULTIPART-BEGIN", deadline_s)
        with self._tmp_lock:
            self._tmp_count += 1
            uid = f"mp-{os.getpid()}-{self._tmp_count}"
        os.makedirs(os.path.join(self.root, ".multipart", uid), exist_ok=True)
        return uid

    def multipart_put_part(
        self,
        key: str,
        upload_id: str,
        part_index: int,
        data: bytes,
        deadline_s: float | None = None,
    ) -> str:
        act = self._gate("MULTIPART-PUT", deadline_s)
        stored = self._mangle(act, bytes(data))
        part = os.path.join(
            self.root, ".multipart", str(upload_id), f"{int(part_index):06d}"
        )
        self._write_atomic(part, stored)
        return sha256_hex(stored)

    def multipart_complete(
        self,
        key: str,
        upload_id: str,
        n_parts: int,
        deadline_s: float | None = None,
    ) -> str:
        self._gate("MULTIPART-COMPLETE", deadline_s)
        stage = os.path.join(self.root, ".multipart", str(upload_id))
        chunks = []
        for i in range(int(n_parts)):
            part = os.path.join(stage, f"{i:06d}")
            try:
                with open(part, "rb") as f:
                    chunks.append(f.read())
            except FileNotFoundError:
                raise ObjectStoreError(
                    f"{self.url(key)}: multipart upload {upload_id} is "
                    f"missing part {i} at complete"
                ) from None
        body = b"".join(chunks)
        self._write_atomic(self._path(key), body)
        self.multipart_abort(key, upload_id)  # drop the staging dir
        return sha256_hex(body)

    def multipart_abort(self, key: str, upload_id: str) -> None:
        import shutil

        stage = os.path.join(self.root, ".multipart", str(upload_id))
        shutil.rmtree(stage, ignore_errors=True)

    # -- listing / lifecycle -----------------------------------------------

    def list(self, prefix: str = "") -> list[str]:
        keys = []
        for dirpath, dirs, files in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            if rel == ".":
                rel = ""
            if rel.split(os.sep, 1)[0] == ".multipart":
                dirs[:] = []
                continue
            for name in files:
                if name.startswith(".tmp-"):
                    continue
                key = os.path.join(rel, name) if rel else name
                key = key.replace(os.sep, "/")
                if key.startswith(prefix):
                    keys.append(key)
        return sorted(keys)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def rename(self, key: str, new_key: str) -> None:
        """Server-side rename — the quarantine primitive (``*.corrupt``
        keeps the evidence out of the data path)."""
        try:
            os.replace(self._path(key), self._path(new_key))
        except FileNotFoundError:
            raise ObjectNotFound(f"{self.url(key)}: no such object") from None


register_scheme("emu", EmulatedObjectStore)


# ---------------------------------------------------------------------------
# shared per-URL read state: latency histogram, counters, advisory
# ---------------------------------------------------------------------------

# Keyed by stack URL and shared process-wide, so the consumer's reader
# and every thread-pool feeder worker aggregate into ONE live p95 and
# one set of hedge/throttle counters (timing["feeder"]["object"]).
# Process-pool workers keep their own registries — their counters are
# invisible to the consumer, which the docs call out.
_STATE_LOCK = threading.Lock()
_URL_STATE: dict[str, dict] = {}

_HEDGE_POOL: ThreadPoolExecutor | None = None
_HEDGE_POOL_LOCK = threading.Lock()


def _url_state(url: str) -> dict:
    from kcmc_tpu_torch.obs.latency import LatencyHistogram

    with _STATE_LOCK:
        st = _URL_STATE.get(url)
        if st is None:
            st = _URL_STATE[url] = {
                "hist": LatencyHistogram(),
                "stats": {
                    "gets": 0,
                    "hedged": 0,
                    "hedge_wins": 0,
                    "retries": 0,
                    "throttled": 0,
                    "refetched": 0,
                    "puts": 0,
                },
                "advised": False,
            }
        return st


def _hedge_executor() -> ThreadPoolExecutor:
    global _HEDGE_POOL
    with _HEDGE_POOL_LOCK:
        if _HEDGE_POOL is None:
            _HEDGE_POOL = ThreadPoolExecutor(
                max_workers=16, thread_name_prefix="kcmc-objget"
            )
        return _HEDGE_POOL


def _shutdown_hedge_pool(wait: bool = False) -> None:
    """Drop the lazy hedge pool; the next hedged GET rebuilds it.
    ``wait=True`` joins the workers, so no kcmc-objget thread outlives
    a test."""
    global _HEDGE_POOL
    with _HEDGE_POOL_LOCK:
        pool, _HEDGE_POOL = _HEDGE_POOL, None
    if pool is not None:
        pool.shutdown(wait=wait, cancel_futures=True)


atexit.register(_shutdown_hedge_pool)


def stats_snapshot(url: str) -> dict:
    """Counters + live latency for one stack URL (what `correct_file`
    merges into ``timing["feeder"]["object"]``)."""
    st = _url_state(str(url))
    with _STATE_LOCK:
        out = dict(st["stats"])
        hist = st["hist"]
        p95 = hist.quantile(95) if hist.count else None
    out["p95_ms"] = round(p95 * 1e3, 3) if p95 is not None else None
    gets = max(out["gets"], 1)
    out["hedge_rate"] = round(out["hedged"] / gets, 4)
    return out


def reset_url_state(url: str | None = None) -> None:
    """Drop the shared per-URL read state (tests; None = all URLs)."""
    with _STATE_LOCK:
        if url is None:
            _URL_STATE.clear()
        else:
            _URL_STATE.pop(str(url), None)


# ---------------------------------------------------------------------------
# manifest helpers (shared by reader + writer)
# ---------------------------------------------------------------------------


def _manifest_bytes(manifest: dict) -> bytes:
    body = json.dumps(manifest, sort_keys=True)
    return json.dumps(
        {"manifest": manifest, "sha256": sha256_hex(body.encode())},
        sort_keys=True,
    ).encode()


def _parse_manifest(raw: bytes) -> dict:
    """Decode + self-checksum-verify manifest bytes; raises ValueError
    on any corruption."""
    doc = json.loads(raw.decode())
    manifest, check = doc["manifest"], doc["sha256"]
    body = json.dumps(manifest, sort_keys=True)
    if sha256_hex(body.encode()) != check:
        raise ValueError("manifest self-checksum mismatch")
    if manifest.get("format") != _MANIFEST_FORMAT:
        raise ValueError(f"unknown manifest format {manifest.get('format')!r}")
    return manifest


def _get_at_rest(client, key: str, retry=None) -> bytes:
    """GET whose body provably matches the STORED object (sha vs head
    etag), retrying in-flight corruption — so a decision to quarantine
    is always about at-rest state, never a flaky wire."""
    attempts = retry.attempts if retry is not None else 3
    deadline = getattr(retry, "deadline_s", None) or _DEFAULT_TIMEOUT_S
    last: Exception | None = None
    for attempt in range(attempts):
        try:
            body = client.get(key, deadline_s=deadline)
            try:
                etag = client.head(key, deadline_s=deadline)["etag"]
            except ObjectNotFound:
                raise
            except Exception:
                etag = None  # can't confirm; accept the body
            if etag is not None and sha256_hex(body) != etag:
                raise TransientFaultError(
                    f"{key}: body/etag mismatch (in-flight corruption)"
                )
            return body
        except Exception as e:
            last = e
            if attempt == attempts - 1 or not classify_transient(e):
                raise
            if retry is not None:
                retry.sleep(retry.delay(attempt))
    raise last  # pragma: no cover — loop always returns/raises


def load_manifest(client, retry=None, report=None, quarantine=True) -> dict:
    """Load + verify the stack manifest; a corrupt current generation
    is quarantined (``.manifest.json.corrupt``) and the PREVIOUS
    generation — the last good high-water mark — is used instead.
    Raises ObjectNotFound when no usable generation exists."""
    last_err: Exception | None = None
    for key in (MANIFEST_KEY, PREV_MANIFEST_KEY):
        try:
            raw = _get_at_rest(client, key, retry=retry)
        except ObjectNotFound as e:
            last_err = e
            continue
        try:
            return _parse_manifest(raw)
        except (ValueError, KeyError, TypeError) as e:
            last_err = e
            if quarantine:
                try:
                    client.rename(key, key + ".corrupt")
                except ObjectStoreError:
                    pass
                if report is not None:
                    report.quarantined_parts.append(
                        getattr(client, "url", lambda k: k)(key)
                    )
    raise ObjectNotFound(
        f"no usable stack manifest in {getattr(client, 'root', client)!r} "
        f"(last error: {last_err})"
    )


# ---------------------------------------------------------------------------
# ingest: the streaming-reader protocol over a chunked bucket
# ---------------------------------------------------------------------------


class ObjectStack:
    """Read a chunked object-store stack through the io.formats reader
    protocol (``len`` / ``frame_shape`` / ``dtype`` / ``read(lo, hi)``).

    Robustness wiring (`arm`): the shared `FaultPlan` is pushed into
    the client (injection happens inside ops, so every consumer path is
    exercised); reads retry per the jittered `RetryPolicy` with
    per-attempt deadline caps, counting `RobustnessReport.io_retries`;
    whole-chunk GETs verify sha256 against the manifest and
    quarantine-and-refetch on mismatch; ranged (sub-chunk) GETs verify
    length. Hedging: once the per-URL latency histogram has
    `_HEDGE_WARMUP` samples, a GET outlasting max(live p95, hedge_ms)
    fires one hedge GET — first result wins, the loser is cancelled.

    Workers built from a `feeder.source_spec` respec self-arm the
    fault plan from ``KCMC_FAULT_PLAN`` so pooled chaos runs inject in
    every per-worker client, not just the consumer's.
    """

    def __init__(self, url, n_threads: int = 0, client=None):
        del n_threads  # concurrency comes from the feeder pool + hedges
        self.path = str(url)
        self._client = client if client is not None else client_for_url(url)
        self._retry = default_io_retry_policy(None)
        self._report = None
        self._tracer = None
        self._hedge_ms = _DEFAULT_HEDGE_MS
        self._timeout_s = _DEFAULT_TIMEOUT_S
        # pooled workers reopen from the spec: arm the env-var plan so
        # chaos injection follows the read into every worker client
        if getattr(self._client, "fault_plan", None) is None:
            plan = resolve_fault_plan(None)
            if plan is not None:
                self._client.fault_plan = plan
        man = load_manifest(self._client, retry=self._retry)
        self.shape = tuple(int(s) for s in man["shape"])
        self.dtype = np.dtype(str(man["dtype"]))
        self.frame_shape = self.shape[1:]
        self.compression = str(man.get("compression", "none"))
        self.chunk_frames = int(man["chunk_frames"])
        self._entries = list(man["chunks"])
        self._n = int(man["n_frames"])
        self._frame_bytes = int(
            np.prod(self.frame_shape, dtype=np.int64)
        ) * self.dtype.itemsize

    def arm(
        self,
        fault_plan=None,
        retry=None,
        report=None,
        tracer=None,
        hedge_ms: float | None = None,
        timeout_s: float | None = None,
    ) -> "ObjectStack":
        """Attach the run's robustness wiring (corrector runs call this
        right after `open_stack`). Returns self for chaining."""
        if fault_plan is not None:
            self._client.fault_plan = fault_plan
        if retry is not None:
            self._retry = retry
        if report is not None:
            self._report = report
        if tracer is not None:
            self._tracer = tracer
        if hedge_ms is not None:
            self._hedge_ms = float(hedge_ms)
        if timeout_s is not None:
            self._timeout_s = float(timeout_s)
        return self

    def __len__(self) -> int:
        return self._n

    def stats_snapshot(self) -> dict:
        return stats_snapshot(self.path)

    # -- counters / advisory ----------------------------------------------

    def _count(self, key: str, n: int = 1) -> None:
        st = _url_state(self.path)
        with _STATE_LOCK:
            st["stats"][key] += n

    def _maybe_advise(self) -> None:
        """Once per URL: name the knob when the object path degrades —
        hedge-fire rate above 20% (after warm-up) or any throttle
        retries observed."""
        st = _url_state(self.path)
        with _STATE_LOCK:
            if st["advised"]:
                return
            s = st["stats"]
            gets, hedged, throttled = s["gets"], s["hedged"], s["throttled"]
            degraded_hedge = gets >= 50 and hedged / gets > 0.2
            if not (degraded_hedge or throttled):
                return
            st["advised"] = True
            rate = hedged / max(gets, 1)
        from kcmc_tpu_torch.obs.log import advise

        advise(
            f"kcmc: {self.path}: object-store path degrading (hedge rate "
            f"{rate:.0%}, {throttled} throttled retries); raise "
            "io_workers to widen the request fan-out, "
            "or raise object_hedge_ms if hedges fire on healthy latency",
            stacklevel=3,
        )

    # -- fetch machinery ---------------------------------------------------

    def _deadline(self) -> float:
        d = getattr(self._retry, "deadline_s", None)
        return float(d) if d else self._timeout_s

    def _hedge_threshold(self) -> float | None:
        if self._hedge_ms <= 0.0:
            return None
        st = _url_state(self.path)
        with _STATE_LOCK:
            hist = st["hist"]
            if hist.count < _HEDGE_WARMUP:
                return None
            p95 = hist.quantile(95)
        if p95 is None:
            return None
        return max(float(p95), self._hedge_ms / 1e3)

    def _record(self, dur: float) -> None:
        st = _url_state(self.path)
        with _STATE_LOCK:
            st["hist"].record(dur)

    def _hedged_get(self, key: str, start: int, length: int | None) -> bytes:
        """One GET attempt, hedged: when the primary outlasts the live
        p95 (floored at hedge_ms), fire a second identical ranged GET —
        first to finish wins, the loser is cancelled (best effort: an
        already-running loser completes in its pool thread and its body
        is dropped)."""
        client, deadline = self._client, self._deadline()

        def fetch():
            t0 = time.perf_counter()
            body = client.get(
                key, start=start, length=length, deadline_s=deadline
            )
            return body, time.perf_counter() - t0

        self._count("gets")
        thresh = self._hedge_threshold()
        if thresh is None:
            body, dur = fetch()
            self._record(dur)
            return body
        ex = _hedge_executor()
        primary = ex.submit(fetch)
        try:
            body, dur = primary.result(timeout=thresh)
            self._record(dur)
            return body
        except _FutureTimeout:
            pass
        self._count("hedged")
        hedge = ex.submit(fetch)
        pending = {primary, hedge}
        err: Exception | None = None
        while pending:
            done, pending = _fut_wait(pending, return_when=FIRST_COMPLETED)
            for f in done:
                try:
                    body, dur = f.result()
                except Exception as e:
                    err = e
                    continue
                for p in pending:
                    p.cancel()
                if f is hedge:
                    self._count("hedge_wins")
                self._record(dur)
                return body
        raise err

    def _quarantine_at_rest(self, key: str, expect_sha: str) -> None:
        """A body failed its checksum: decide in-flight vs at-rest via
        the stored etag. At-rest -> quarantine + fatal (the bytes are
        gone); in-flight/unknown -> return so the caller refetches."""
        try:
            etag = self._client.head(key, deadline_s=self._deadline())["etag"]
        except Exception:
            return  # can't confirm at-rest state: treat as in-flight
        if etag == expect_sha:
            return  # stored copy is fine: the wire mangled it
        try:
            self._client.rename(key, key + ".corrupt")
        except ObjectStoreError:
            pass
        if self._report is not None:
            self._report.quarantined_parts.append(f"{self.path}/{key}")
        raise ObjectIntegrityError(
            f"{self.path}/{key}: object corrupt at rest (stored etag "
            f"{etag[:12]} != manifest {expect_sha[:12]}); quarantined as "
            f"{key}.corrupt — the frames it held are unrecoverable"
        )

    def _get_checked(
        self,
        key: str,
        start: int,
        length: int | None,
        expect_len: int,
        verify_sha: str | None,
    ) -> bytes:
        """One logical GET: hedged, retried per the policy, length- and
        checksum-verified (quarantine-and-refetch on corrupt bodies)."""
        policy = self._retry
        attempts = policy.attempts if policy is not None else 1
        for attempt in range(attempts):
            try:
                body = self._hedged_get(key, start, length)
                if len(body) != expect_len:
                    raise TransientFaultError(
                        f"{self.path}/{key}: truncated object body "
                        f"({len(body)} of {expect_len} bytes)"
                    )
                if verify_sha is not None and sha256_hex(body) != verify_sha:
                    self._count("refetched")
                    self._quarantine_at_rest(key, verify_sha)
                    raise TransientFaultError(
                        f"{self.path}/{key}: object body checksum mismatch "
                        "(in-flight corruption); refetching"
                    )
                return body
            except Exception as e:
                if isinstance(e, ObjectStoreThrottled):
                    self._count("throttled")
                    self._maybe_advise()
                if attempt == attempts - 1 or not classify_transient(e):
                    raise
                self._count("retries")
                if self._report is not None:
                    self._report.io_retries += 1
                if policy is not None:
                    policy.sleep(policy.delay(attempt))
        raise AssertionError("unreachable")  # loop always returns/raises

    def read(self, lo: int, hi: int) -> np.ndarray:
        t0 = time.perf_counter()
        lo, hi = max(0, int(lo)), min(self._n, int(hi))
        n = max(0, hi - lo)
        out = np.empty((n,) + tuple(self.frame_shape), self.dtype)
        if n == 0:
            return out
        cf = self.chunk_frames
        for ci in range(lo // cf, (hi - 1) // cf + 1):
            entry = self._entries[ci]
            base = ci * cf
            clo, chi = max(lo, base), min(hi, base + int(entry["frames"]))
            fl, fh = clo - base, chi - base  # frame span within the chunk
            whole = fl == 0 and fh == int(entry["frames"])
            if self.compression == "deflate" or whole:
                # compressed chunks cannot be ranged; whole-chunk reads
                # get the full integrity check either way
                body = self._get_checked(
                    entry["key"], 0, None,
                    expect_len=int(entry["size"]),
                    verify_sha=entry["sha256"],
                )
                if self.compression == "deflate":
                    body = zlib.decompress(body)
                frames = np.frombuffer(body, self.dtype).reshape(
                    (int(entry["frames"]),) + tuple(self.frame_shape)
                )[fl:fh]
            else:
                # genuine range request: only the needed byte span moves
                body = self._get_checked(
                    entry["key"],
                    fl * self._frame_bytes,
                    (fh - fl) * self._frame_bytes,
                    expect_len=(fh - fl) * self._frame_bytes,
                    verify_sha=None,
                )
                frames = np.frombuffer(body, self.dtype).reshape(
                    (fh - fl,) + tuple(self.frame_shape)
                )
            out[clo - lo : chi - lo] = frames
        self._maybe_advise()
        if self._tracer is not None:
            self._tracer.complete(
                "object.get",
                t0,
                time.perf_counter() - t0,
                cat="object",
                args={"lo": int(lo), "hi": int(hi)},
            )
        return out

    def close(self) -> None:
        pass  # clients are stateless; nothing to release

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# egress: sharded chunk-object writer with a durable manifest
# ---------------------------------------------------------------------------


class ObjectStoreWriter:
    """Streaming egress to a chunked object-store stack (TiffWriter
    protocol: `append_batch` / `checkpoint_state` / `close` /
    `n_pages` — slots under `AsyncBatchWriter` unchanged).

    Frames buffer until a full ``chunk_frames`` chunk exists, which
    uploads (multipart when the encoded blob exceeds ``part_bytes``)
    with write-side verification: the store's returned etag must match
    the blob's sha256, so an injected truncate/flip (or any torn
    upload) retries instead of persisting garbage. After every
    completed chunk the manifest advances atomically (previous
    generation kept as the rewind point). `checkpoint_state()` uploads
    the partial tail chunk first, so the state it returns is the
    durable high-water mark; `resume` verifies every chunk at rest
    (etag vs manifest), refuses a store behind the checkpoint cursor
    (OSError -> the corrector restarts from scratch), and reloads the
    partial tail into the buffer — so a resumed run re-uploads only
    past the high-water mark and the final chunk set is byte-identical
    to an uninterrupted run.
    """

    def __init__(
        self,
        url,
        n_frames: int,
        frame_shape: tuple,
        dtype,
        compression: str = "none",
        chunk_frames: int = _DEFAULT_CHUNK_FRAMES,
        part_bytes: int = _DEFAULT_PART_BYTES,
        client=None,
        fault_plan=None,
        retry=None,
        report=None,
        tracer=None,
    ):
        if compression not in ("none", "deflate"):
            raise ValueError(
                "object egress supports compression 'none' or 'deflate', "
                f"got {compression!r}"
            )
        self.path = str(url)
        self._client = client if client is not None else client_for_url(url)
        if fault_plan is not None:
            self._client.fault_plan = fault_plan
        self.compression = compression
        self.shape = (int(n_frames),) + tuple(int(s) for s in frame_shape)
        self.dtype = np.dtype(dtype)
        self.chunk_frames = max(1, int(chunk_frames))
        self.part_bytes = max(1, int(part_bytes))
        self._retry = retry if retry is not None else default_io_retry_policy(None)
        self._report = report
        self._tracer = tracer
        # fresh construction = fresh run (the ZarrWriter contract):
        # drop stale chunks/manifests from a previous run at this URL
        for key in self._client.list(""):
            if key.startswith("chunk-") or key.startswith(".manifest"):
                self._client.delete(key)
        self._entries: list[dict] = []  # completed full chunks
        self._buf: list[np.ndarray] = []  # tail frames (< chunk_frames)
        self._tail_dirty = False  # buffered frames not yet durable
        self._last_manifest: bytes | None = None
        self.n_pages = 0

    # -- upload machinery --------------------------------------------------

    def _encode(self, frames: np.ndarray) -> bytes:
        raw = np.ascontiguousarray(frames, self.dtype).tobytes()
        return zlib.compress(raw, 6) if self.compression == "deflate" else raw

    def _deadline(self) -> float | None:
        d = getattr(self._retry, "deadline_s", None)
        return float(d) if d else _DEFAULT_TIMEOUT_S

    def _put_verified(self, key: str, blob: bytes) -> str:
        """Upload one object (multipart past `part_bytes`), retried per
        the policy; the stored etag must equal the blob's sha256 — a
        torn or mangled upload never becomes the durable copy."""
        policy = self._retry
        attempts = policy.attempts if policy is not None else 1
        want, deadline = sha256_hex(blob), self._deadline()
        client = self._client
        t0 = time.perf_counter()
        for attempt in range(attempts):
            try:
                if len(blob) > self.part_bytes:
                    uid = client.multipart_begin(key, deadline_s=deadline)
                    try:
                        n_parts = 0
                        for off in range(0, len(blob), self.part_bytes):
                            client.multipart_put_part(
                                key, uid, n_parts,
                                blob[off : off + self.part_bytes],
                                deadline_s=deadline,
                            )
                            n_parts += 1
                        etag = client.multipart_complete(
                            key, uid, n_parts, deadline_s=deadline
                        )
                    except BaseException:
                        client.multipart_abort(key, uid)
                        raise
                else:
                    etag = client.put(key, blob, deadline_s=deadline)
                if etag != want:
                    raise TransientFaultError(
                        f"{self.path}/{key}: upload verification failed "
                        f"(stored etag {etag[:12]} != blob {want[:12]}); "
                        "re-uploading"
                    )
                st = _url_state(self.path)
                with _STATE_LOCK:
                    st["stats"]["puts"] += 1
                if self._tracer is not None:
                    self._tracer.complete(
                        "object.put",
                        t0,
                        time.perf_counter() - t0,
                        cat="object",
                        args={"key": key, "bytes": len(blob)},
                    )
                return etag
            except Exception as e:
                if isinstance(e, ObjectStoreThrottled):
                    st = _url_state(self.path)
                    with _STATE_LOCK:
                        st["stats"]["throttled"] += 1
                if attempt == attempts - 1 or not classify_transient(e):
                    raise
                st = _url_state(self.path)
                with _STATE_LOCK:
                    st["stats"]["retries"] += 1
                if self._report is not None:
                    self._report.io_retries += 1
                if policy is not None:
                    policy.sleep(policy.delay(attempt))
        raise AssertionError("unreachable")  # loop always returns/raises

    @staticmethod
    def _chunk_key(ci: int) -> str:
        return f"chunk-{ci:08d}"

    def _manifest(self, entries: list[dict]) -> dict:
        return {
            "format": _MANIFEST_FORMAT,
            "shape": list(self.shape),
            "dtype": self.dtype.str,
            "compression": self.compression,
            "chunk_frames": int(self.chunk_frames),
            "n_frames": int(sum(int(e["frames"]) for e in entries)),
            "chunks": entries,
        }

    def _flush_manifest(self, entries: list[dict]) -> None:
        data = _manifest_bytes(self._manifest(entries))
        # keep the previous generation as the rewind point (written
        # from memory: no GET in the durability path)
        if self._last_manifest is not None and self._last_manifest != data:
            self._put_verified(PREV_MANIFEST_KEY, self._last_manifest)
        self._put_verified(MANIFEST_KEY, data)
        self._last_manifest = data

    def _upload_chunk(self, ci: int, frames: np.ndarray) -> dict:
        blob = self._encode(frames)
        key = self._chunk_key(ci)
        self._put_verified(key, blob)
        return {
            "key": key,
            "frames": int(len(frames)),
            "sha256": sha256_hex(blob),
            "size": len(blob),
        }

    # -- streaming-writer protocol ----------------------------------------

    def append_batch(self, frames: np.ndarray, n_threads: int = 0) -> None:
        del n_threads  # encode cost is chunk-level; uploads dominate
        frames = np.asarray(frames)
        if tuple(frames.shape[1:]) != self.shape[1:]:
            raise ValueError(
                f"frame shape {frames.shape[1:]} != store {self.shape[1:]}"
            )
        if self.n_pages + len(frames) > self.shape[0]:
            raise ValueError(
                f"appending {len(frames)} frames past the store's "
                f"{self.shape[0]}-frame shape (at {self.n_pages})"
            )
        if len(frames) == 0:
            return
        self._buf.append(np.ascontiguousarray(frames, self.dtype))
        self.n_pages += len(frames)
        self._tail_dirty = True
        buffered = sum(len(b) for b in self._buf)
        if buffered >= self.chunk_frames:
            pending = np.concatenate(self._buf) if len(self._buf) > 1 else self._buf[0]
            off = 0
            while len(pending) - off >= self.chunk_frames:
                chunk = pending[off : off + self.chunk_frames]
                self._entries.append(
                    self._upload_chunk(len(self._entries), chunk)
                )
                off += self.chunk_frames
                self._flush_manifest(list(self._entries))
            tail = pending[off:]
            self._buf = [tail] if len(tail) else []
            self._tail_dirty = bool(len(tail))

    def _flush_tail(self) -> None:
        """Make every appended frame durable: upload the partial tail
        chunk (re-uploaded full later when more frames complete it) and
        advance the manifest to cover it."""
        if not self._tail_dirty:
            return
        tail = (
            np.concatenate(self._buf) if len(self._buf) > 1 else self._buf[0]
        )
        entry = self._upload_chunk(len(self._entries), tail)
        self._flush_manifest(list(self._entries) + [entry])
        self._buf = [tail]
        self._tail_dirty = False

    def checkpoint_state(self) -> dict:
        self._flush_tail()
        return {
            "format": "object",
            "n_pages": int(self.n_pages),
            # deflate chunk bytes are zlib-build-sensitive, exactly the
            # TIFF/Zarr deflate pin
            "zlib": zlib.ZLIB_RUNTIME_VERSION,
        }

    @classmethod
    def resume(
        cls, url, state: dict, compression: str = "none", object_opts=None
    ) -> "ObjectStoreWriter":
        """Resume against the durable manifest. OSError on anything the
        resume contract cannot honor (store behind the checkpoint
        cursor, at-rest chunk corruption below it, layout mismatch) —
        the corrector's resume handler restarts from scratch on
        OSError, exactly like a torn TIFF."""
        opts = dict(object_opts or {})
        if state.get("format") != "object":
            raise OSError(f"{url}: checkpoint writer state is not object")
        client = opts.get("client")
        if client is None:
            client = client_for_url(url, fault_plan=opts.get("fault_plan"))
        elif opts.get("fault_plan") is not None:
            client.fault_plan = opts["fault_plan"]
        retry = opts.get("retry") or default_io_retry_policy(None)
        report = opts.get("report")
        try:
            man = load_manifest(client, retry=retry, report=report)
        except ObjectNotFound as e:
            raise OSError(f"{url}: no usable egress manifest at resume: {e}") from e
        if str(man.get("compression", "none")) != compression:
            raise OSError(
                f"{url}: store compression {man.get('compression')!r} does "
                f"not match the resume compression {compression!r}"
            )
        try:
            n = int(state["n_pages"])
        except (KeyError, TypeError, ValueError) as e:
            raise OSError(f"{url}: malformed object writer state: {e}") from e
        durable = int(man["n_frames"])
        if durable < n:
            raise OSError(
                f"{url}: durable high-water mark {durable} is behind the "
                f"checkpoint cursor {n} (manifest rewound or egress torn)"
            )
        self = object.__new__(cls)
        self.path = str(url)
        self._client = client
        self.compression = compression
        self.shape = tuple(int(s) for s in man["shape"])
        self.dtype = np.dtype(str(man["dtype"]))
        self.chunk_frames = int(man["chunk_frames"])
        self.part_bytes = max(1, int(opts.get("part_bytes", _DEFAULT_PART_BYTES)))
        self._retry = retry
        self._report = report
        self._tracer = opts.get("tracer")
        self._last_manifest = None
        deadline = getattr(retry, "deadline_s", None) or _DEFAULT_TIMEOUT_S
        # verify every chunk at rest below the cursor; reload the
        # partial tail into the buffer so its chunk re-uploads FULL
        entries: list[dict] = []
        buf: list[np.ndarray] = []
        base = 0
        for e in man["chunks"]:
            frames_e = int(e["frames"])
            if base >= n:
                break  # past the cursor: stale bytes, overwritten later
            try:
                etag = client.head(e["key"], deadline_s=deadline)["etag"]
            except ObjectNotFound:
                etag = None
            if etag != e["sha256"]:
                if etag is not None:
                    try:
                        client.rename(e["key"], e["key"] + ".corrupt")
                    except ObjectStoreError:
                        pass
                    if report is not None:
                        report.quarantined_parts.append(
                            f"{url}/{e['key']}"
                        )
                raise OSError(
                    f"{url}: chunk object {e['key']} "
                    f"{'corrupt' if etag is not None else 'missing'} at "
                    "resume (durable frames lost below the checkpoint "
                    "cursor)"
                )
            keep = min(frames_e, n - base)
            if keep == self.chunk_frames:
                entries.append(dict(e))
            else:
                # partial tail: pull its live frames back into the
                # buffer so future appends complete the chunk in place
                body = _get_at_rest(client, e["key"], retry=retry)
                if sha256_hex(body) != e["sha256"]:
                    raise OSError(
                        f"{url}: chunk object {e['key']} unreadable at "
                        "resume (checksum mismatch)"
                    )
                if compression == "deflate":
                    body = zlib.decompress(body)
                frames = np.frombuffer(body, self.dtype).reshape(
                    (frames_e,) + self.shape[1:]
                )
                buf = [np.array(frames[:keep])]
            base += frames_e
        self._entries = entries
        self._buf = buf
        self._tail_dirty = False
        self.n_pages = n
        return self

    def close(self) -> None:
        self._flush_tail()


def put_stack(
    url,
    stack: np.ndarray,
    chunk_frames: int = _DEFAULT_CHUNK_FRAMES,
    compression: str = "none",
    part_bytes: int = _DEFAULT_PART_BYTES,
    client=None,
) -> str:
    """Upload an in-memory stack as a chunked object-store stack (the
    test/bench fixture helper — and the way a local stack becomes a
    bucket-resident one). Returns the URL."""
    stack = np.asarray(stack)
    w = ObjectStoreWriter(
        url,
        len(stack),
        tuple(stack.shape[1:]),
        stack.dtype,
        compression=compression,
        chunk_frames=chunk_frames,
        part_bytes=part_bytes,
        client=client,
    )
    w.append_batch(stack)
    w.close()
    return str(url)
