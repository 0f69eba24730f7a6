"""Feeder-side scale-out: process-based decode pools + sharded ingest
(the port's copy of kcmc_tpu/io/feeder.py, without the object store).

Host TIFF decode on the single-core pure-Python deflate fallback binds
far below what the card registers, and the single-producer prefetch
thread of `io/reader.py` cannot fill it. This module is the host half of
closing that gap:

* **DecodePool** — a pool of decode workers. Two flavors behind one
  interface: ``kind="process"`` (a spawn-context ProcessPoolExecutor)
  for the GIL-bound pure-Python codecs (deflate/LZW/packbits TIFF
  fallback, zlib Zarr chunks), ``kind="thread"`` where decode releases
  the GIL (uncompressed python TIFF — file reads + frombuffer). Work
  items are SEEKABLE page spans: each worker opens its own reader
  handle from a pickleable source spec and decodes ``read(lo, hi)``
  independently, so there is no shared file cursor and no cross-worker
  coordination.
* **pooled_chunks** — the sharded chunk iterator: each chunk's page
  range splits into per-worker spans submitted concurrently, chunks are
  reassembled IN ORDER on the consumer thread, and at most ``prefetch``
  chunks are in flight (bounded memory: ~prefetch x chunk_size frames).
  No extra threads: the consumer itself tops up the submission window
  and blocks only on the head chunk, so a ``KeyboardInterrupt`` lands
  in the consumer exactly like any synchronous read (the
  ``ChunkedStackLoader`` contract), and a worker crash surfaces as an
  exception carrying the worker-side traceback — never a hang or a
  truncated-but-clean end of stream.
* **shared_pool** — a process-wide pool registry so every run (and
  every stream) in one process shares ONE warm pool per
  (kind, workers) instead of paying spawn + import per run.

`ChunkedStackLoader` (io/reader.py) routes through this module when
`io_workers >= 2` and the source classifies as pool-friendly;
`CorrectorConfig.io_workers` / `io_prefetch` are the
config surface, and `correct_file` derives the prefetch depth from its
dispatch window (depth x batch frames ahead).
"""

from __future__ import annotations

import atexit
import os
import threading
import time
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from concurrent.futures.process import BrokenProcessPool

import numpy as np

# Auto worker-count ceiling: decode workers beyond this see diminishing
# returns against the host-to-device feed they fill, and a multi-card host has
# better uses for its remaining cores (the dispatch thread, the writer).
_AUTO_WORKER_CAP = 8


def resolve_workers(requested: int) -> int:
    """The `io_workers` value -> a concrete worker count
    (0 = auto: one per CPU, capped at 8; N >= 1 = exactly N)."""
    n = int(requested)
    if n > 0:
        return n
    return max(1, min(os.cpu_count() or 1, _AUTO_WORKER_CAP))


def derive_prefetch(io_prefetch: int, batch: int, chunk: int, depth: int = 3) -> int:
    """Prefetch depth in CHUNKS for a streaming run (0 = auto).

    Auto keeps `depth x batch` decoded frames ahead of the consumer —
    one chunk per in-flight dispatch-window slot plus one being
    consumed — replacing the fixed prefetch=2 of the single-producer
    era, whose two chunks could starve a deep mesh window.
    """
    if io_prefetch and io_prefetch > 0:
        return int(io_prefetch)
    frames_ahead = max(1, int(depth) * max(1, int(batch)))
    return max(2, -(-frames_ahead // max(1, int(chunk))) + 1)


# ---------------------------------------------------------------------------
# source classification + worker-side respec
# ---------------------------------------------------------------------------


def classify_source(source) -> str | None:
    """Which pool flavor (if any) pays for this reader.

    "process": decode is GIL-bound pure-Python codec work — the
    deflate/LZW/packbits TIFF fallback, zlib/gzip Zarr chunks — where
    thread fan-out serializes on the interpreter lock.
    "thread": decode releases the GIL (uncompressed python-path TIFF,
    raw Zarr chunks) — concurrent chunk fetch helps, processes add only
    pickling.
    None: the legacy single-producer prefetch thread is already right —
    the native TIFF decoder fans its own threads out per read, h5py is
    not thread-safe, and memmap-backed sources are one memcpy.
    """
    from kcmc_tpu_torch.io.formats import ZarrStack, _MiniZarr
    from kcmc_tpu_torch.io.tiff import TiffStack

    if isinstance(source, TiffStack):
        if source.backend == "native":
            return None
        return "thread" if source.compression == 1 else "process"
    if isinstance(source, ZarrStack):
        inner = source.source
        if isinstance(inner, _MiniZarr):
            return "process" if inner._zlib else "thread"
    return None


def source_spec(source, source_path, reader_options: dict | None):
    """A pickleable respec workers reopen the source from, or None when
    the source has no cross-process identity (in-memory arrays, reader
    objects without a path). Python-decode TIFF sources pin
    ``force_python=True`` so no worker races to build (or silently
    switches to) the native decoder mid-run."""
    if source_path is None:
        return None
    from kcmc_tpu_torch.io.tiff import TiffStack

    opts = dict(reader_options or {})
    if isinstance(source, TiffStack) and source.backend == "python":
        opts["force_python"] = True
    return ("stack", os.fspath(source_path), tuple(sorted(opts.items())))


# Per-process (and per-thread, for the thread flavor) reader cache:
# opening parses metadata once; spans then seek independently.
_READER_CACHE = threading.local()


def _decode_span(spec, lo: int, hi: int) -> np.ndarray:
    """Worker entry: decode pages [lo, hi) of the respec'd source."""
    cache = getattr(_READER_CACHE, "readers", None)
    if cache is None:
        cache = _READER_CACHE.readers = {}
    reader = cache.pop(spec, None)
    if reader is None:
        _kind, path, opts = spec
        from kcmc_tpu_torch.io.formats import open_stack

        reader = open_stack(path, **dict(opts))
    cache[spec] = reader  # re-insert: dict order doubles as LRU order
    while len(cache) > 8:  # shared pools outlive runs — cap open handles
        _stale_spec, stale = next(iter(cache.items()))
        del cache[_stale_spec]
        try:
            stale.close()
        except Exception:
            pass
    return np.ascontiguousarray(reader.read(lo, hi))


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


class DecodePool:
    """A fixed pool of decode workers (see module docstring).

    ``kind="process"`` spawns fresh interpreters (spawn context — safe
    next to the CUDA runtime's threads, and `kcmc_tpu_torch`'s lazy
    package init keeps the worker's imports to `kcmc_tpu_torch.io` and
    numpy); ``kind="thread"`` shares the
    process. `submit` returns a concurrent.futures.Future whose result
    is the decoded (hi-lo, *frame_shape) array; worker exceptions
    propagate with the worker-side traceback attached, and a hard
    worker death surfaces as BrokenProcessPool (`broken` flips True so
    the shared registry replaces the pool).
    """

    def __init__(self, workers: int, kind: str = "process"):
        if kind not in ("process", "thread"):
            raise ValueError(f"DecodePool kind must be process|thread, got {kind!r}")
        if workers < 1:
            raise ValueError(f"DecodePool needs >= 1 worker, got {workers}")
        self.workers = int(workers)
        self.kind = kind
        self.broken = False
        if kind == "process":
            import multiprocessing

            # spawn, never fork: this process carries CUDA (and
            # writer) threads, and a forked child of a
            # threaded process is undefined behavior waiting to happen.
            # Spawn implies the STANDARD multiprocessing contract: a
            # script that reaches a pooled run from module level needs
            # the usual `if __name__ == "__main__":` guard. The lazy
            # kcmc_tpu_torch package init keeps each worker's import
            # numpy-light and torch-free.
            self._ex = ProcessPoolExecutor(
                max_workers=self.workers,
                mp_context=multiprocessing.get_context("spawn"),
            )
        else:
            self._ex = ThreadPoolExecutor(
                max_workers=self.workers, thread_name_prefix="kcmc-decode"
            )

    def submit(self, spec, lo: int, hi: int):
        return self._ex.submit(_decode_span, spec, lo, hi)

    def shutdown(self, wait: bool = True) -> None:
        self._ex.shutdown(wait=wait, cancel_futures=True)


_SHARED_LOCK = threading.Lock()
_SHARED: dict[tuple[str, int], DecodePool] = {}


def shared_pool(kind: str, workers: int) -> DecodePool:
    """The process-wide shared pool for (kind, workers): every
    streaming run in one process reuses the same warm
    workers instead of paying spawn + import per run. Broken pools
    (a worker died) are replaced transparently."""
    key = (kind, int(workers))
    with _SHARED_LOCK:
        pool = _SHARED.get(key)
        if pool is None or pool.broken:
            if pool is not None:
                pool.shutdown(wait=False)
            pool = _SHARED[key] = DecodePool(workers, kind)
        return pool


def shutdown_shared_pools() -> None:
    """Tear down every shared pool (interpreter exit). Safe to call
    repeatedly; pools recreate on demand."""
    with _SHARED_LOCK:
        pools = list(_SHARED.values())
        _SHARED.clear()
    for pool in pools:
        pool.shutdown(wait=False)


atexit.register(shutdown_shared_pools)


# ---------------------------------------------------------------------------
# sharded, ordered, bounded chunk iteration
# ---------------------------------------------------------------------------


def _spans(lo: int, hi: int, workers: int) -> list[tuple[int, int]]:
    """Split a chunk's page range into per-worker spans (>= 4 pages per
    span — below that the submit/pickle overhead beats the decode)."""
    n = hi - lo
    size = max(4, -(-n // max(1, workers)))
    return [(a, min(a + size, hi)) for a in range(lo, hi, size)]


def pooled_chunks(
    pool: DecodePool,
    spec,
    start: int,
    stop: int,
    chunk_size: int,
    prefetch: int,
    fault_plan=None,
    retry=None,
    report=None,
    on_wait=None,
    stats: dict | None = None,
):
    """Yield (lo, hi, frames) chunks in order, decoded by `pool`.

    The submission window holds at most `prefetch` chunks (bounded
    memory); each chunk is sharded into per-worker spans. Fault
    injection (surface ``io_read``) and transient-retry semantics match
    `ChunkedStackLoader._read`: the step index is drawn at submission
    in chunk order, injection fires at collection, and a transient
    failure (injected or worker-side) resubmits the chunk's spans up to
    the policy's attempt budget with backoff, counting
    `report.io_retries`. `on_wait(seconds)` fires when the consumer
    actually blocked on the head chunk (the `prefetch_wait` stall).

    `retry` is a utils/faults.RetryPolicy, the string ``"default"``
    (resolved through `utils.faults.default_io_retry_policy` — THE
    shared ingest-surface construction point, so backoff/jitter/
    classification cannot drift between reader, feeder, and the
    object-store path), or None (read exactly once).
    """
    from kcmc_tpu_torch.utils.faults import (
        classify_transient,
        default_io_retry_policy,
    )

    if retry == "default":
        retry = default_io_retry_policy(None)

    if stats is not None:
        stats["chunks"] = stats.get("chunks", 0)
        stats["spans"] = stats.get("spans", 0)
        stats["frames"] = stats.get("frames", 0)
        stats["io_retries"] = stats.get("io_retries", 0)
        stats.setdefault("max_inflight_chunks", 0)
    pending: deque = deque()  # (lo, hi, spans, futures, t_submit, step)
    nxt = start

    def submit_chunk() -> bool:
        nonlocal nxt
        if nxt >= stop:
            return False
        lo, hi = nxt, min(nxt + chunk_size, stop)
        nxt = hi
        step = fault_plan.op_index("io_read") if fault_plan is not None else None
        spans = _spans(lo, hi, pool.workers)
        try:
            futs = [pool.submit(spec, a, b) for a, b in spans]
        except BrokenProcessPool as e:
            # A dead worker can surface at SUBMIT time (the executor
            # noticed before our next collect): same contract as the
            # collect-side path — mark the pool broken and raise with
            # attribution, never leak the raw executor error.
            pool.broken = True
            raise RuntimeError(
                f"decode pool worker died while submitting pages "
                f"[{lo}, {hi}) of {spec[1]!r} (the pool is torn "
                "down; a rerun builds a fresh one)"
            ) from e
        pending.append((lo, hi, spans, futs, time.perf_counter(), step))
        if stats is not None:
            stats["chunks"] += 1
            stats["spans"] += len(spans)
            stats["max_inflight_chunks"] = max(
                stats["max_inflight_chunks"], len(pending)
            )
        return True

    def collect(futs):
        """Wait for one chunk's spans; returns parts. Times the
        consumer's actual blocked span for the stall telemetry."""
        t0 = None
        parts = []
        for f in futs:
            if t0 is None and not f.done():
                t0 = time.perf_counter()
            parts.append(f.result())
        if t0 is not None and on_wait is not None:
            on_wait(time.perf_counter() - t0)
        return parts

    try:
        while True:
            while len(pending) < max(1, prefetch) and submit_chunk():
                pass
            if not pending:
                return
            lo, hi, spans, futs, t_sub, step = pending.popleft()
            attempts = max(1, retry.attempts if retry is not None else 1)
            last_futs = futs
            for attempt in range(attempts):
                try:
                    if fault_plan is not None:
                        fault_plan.maybe_fail("io_read", step)
                    parts = collect(last_futs)
                    break
                except BrokenProcessPool as e:
                    pool.broken = True
                    raise RuntimeError(
                        f"decode pool worker died while decoding pages "
                        f"[{lo}, {hi}) of {spec[1]!r} (the pool is torn "
                        "down; a rerun builds a fresh one)"
                    ) from e
                except Exception as e:
                    if attempt == attempts - 1 or not classify_transient(e):
                        raise
                    if report is not None:
                        report.io_retries += 1
                    if stats is not None:
                        stats["io_retries"] += 1
                    if retry is not None:
                        retry.sleep(retry.delay(attempt))
                    # resubmit only if a span actually failed (an
                    # injected fault leaves the decoded spans reusable)
                    if any(
                        f.done() and f.exception() is not None
                        for f in last_futs
                    ):
                        last_futs = [pool.submit(spec, a, b) for a, b in spans]
            frames = parts[0] if len(parts) == 1 else np.concatenate(parts)
            if stats is not None:
                stats["frames"] += int(hi - lo)
            yield lo, hi, frames
    finally:
        for entry in pending:
            for f in entry[3]:
                f.cancel()
