"""Bounded background writeback for the streaming pipeline.

`correct_file` used to call `writer.append_batch` inside the drain
callback on the consumer thread, so TIFF/Zarr/HDF5 encode+write
serialized with device dispatch — every page written was a page the
accelerator waited for. `AsyncBatchWriter` wraps any streaming writer
(the TiffWriter protocol: `append_batch` / `checkpoint_state` /
`close`) with a bounded FIFO queue and one worker thread (the port's
copy of kcmc_tpu/io/async_writer.py):

* appends ENQUEUE and return immediately; a full queue blocks the
  caller (backpressure — bounded memory, and the blocked time is
  recorded in `stats()["backpressure_s"]` for the stall telemetry);
* the single worker preserves append order exactly;
* worker exceptions surface on the CONSUMER thread at the next
  append/flush/checkpoint_state/close, the same contract
  `ChunkedStackLoader` uses for prefetch-thread decode errors;
* `checkpoint_state()` flushes first, so the state it returns is the
  writer's durable high-water mark — a checkpoint can never claim
  frames the worker had not yet written, and kill/resume semantics are
  byte-identical to synchronous writes.
"""

from __future__ import annotations

import queue
import threading
import time


class AsyncBatchWriter:
    """Wrap a streaming writer with a depth-bounded background append
    queue. `depth` is the maximum number of batches in flight (>= 1).
    `tracer` (an obs.trace.Tracer, optional) records each worker-side
    append and consumer-side backpressure/flush wait as spans — the
    writer thread shows up as its own track in the exported trace."""

    def __init__(self, writer, depth: int = 2, tracer=None):
        if depth < 1:
            raise ValueError(f"AsyncBatchWriter depth must be >= 1, got {depth}")
        self.writer = writer
        self._tracer = tracer
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._exc: BaseException | None = None
        self._exc_lock = threading.Lock()
        self._close_lock = threading.Lock()
        # Guards the advisory counters: the worker and the consumer
        # both accumulate into _stats (write_s/batches vs
        # backpressure_s/flush_s), and stats() snapshots from whatever
        # thread asks — the race pass (`kcmc check`) holds all three
        # sides to one lock.
        self._stats_lock = threading.Lock()
        self._closed = False
        self._stats = {
            "backpressure_s": 0.0,  # consumer blocked on a full queue
            "flush_s": 0.0,  # consumer blocked draining for a checkpoint
            "write_s": 0.0,  # worker time actually encoding+writing
            "batches": 0,
        }
        self._thread = threading.Thread(
            target=self._run, name="kcmc-writer", daemon=True
        )
        self._thread.start()

    # -- worker ------------------------------------------------------------

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                with self._exc_lock:
                    failed = self._exc is not None
                if failed:  # after a failure: drain, don't write
                    continue
                frames, n_threads = item
                t0 = time.perf_counter()
                try:
                    self.writer.append_batch(frames, n_threads=n_threads)
                    dt = time.perf_counter() - t0
                    with self._stats_lock:
                        self._stats["write_s"] += dt
                        self._stats["batches"] += 1
                        batches = self._stats["batches"]
                    if self._tracer is not None:
                        self._tracer.complete(
                            "writer.append_batch", t0, dt, cat="writer",
                            args={"batch": batches},
                        )
                except BaseException as e:  # surfaced on the consumer
                    with self._exc_lock:
                        self._exc = e
            finally:
                self._q.task_done()

    def _check(self) -> None:
        # The read-and-clear is atomic across threads: a pending worker
        # failure surfaces on exactly ONE caller (two threads racing
        # into here must not both re-raise).
        with self._exc_lock:
            exc, self._exc = self._exc, None
        if exc is not None:
            raise exc

    # -- consumer-side protocol -------------------------------------------

    def append_batch(self, frames, n_threads: int = 0) -> None:
        # The closed-check and enqueue happen under the close lock:
        # otherwise a concurrent close() could slip between them, retire
        # the worker, and leave this batch silently parked behind the
        # shutdown sentinel — written to nobody. A close() racing a
        # backpressure-blocked append waits for it (the worker is still
        # draining, so the put always completes).
        with self._close_lock:
            if self._closed:
                raise ValueError("append_batch on a closed AsyncBatchWriter")
            self._check()
            item = (frames, n_threads)
            try:
                self._q.put_nowait(item)
            except queue.Full:
                t0 = time.perf_counter()
                self._q.put(item)
                dt = time.perf_counter() - t0
                with self._stats_lock:
                    self._stats["backpressure_s"] += dt
                if self._tracer is not None:
                    self._tracer.complete(
                        "writer.backpressure", t0, dt, cat="stall"
                    )
        # re-check AFTER enqueuing so a worker failure surfaces at most
        # one append late, not only at close
        self._check()

    def flush(self) -> None:
        """Block until every enqueued batch is durable in the inner
        writer (or its failure has surfaced)."""
        self._check()
        t0 = time.perf_counter()
        self._q.join()
        dt = time.perf_counter() - t0
        with self._stats_lock:
            self._stats["flush_s"] += dt
        if self._tracer is not None and dt > 0:
            self._tracer.complete("writer.flush", t0, dt, cat="stall")
        self._check()

    def checkpoint_state(self) -> dict:
        """Durable high-water-mark state: flushes, then delegates."""
        self.flush()
        return self.writer.checkpoint_state()

    @property
    def n_pages(self) -> int:
        """Pages DURABLE in the inner writer (lags appends by the queue)."""
        return self.writer.n_pages

    def stats(self) -> dict:
        with self._stats_lock:
            return dict(self._stats)

    def close(self) -> None:
        """Flush, stop the worker, close the inner writer; re-raises a
        pending worker failure.

        Idempotent AND thread-safe: when two threads close concurrently,
        exactly one performs the teardown, the other blocks until it is
        done, and a pending worker error surfaces exactly once across
        both (`_check`'s atomic read-and-clear)."""
        with self._close_lock:
            if not self._closed:
                self._closed = True
                if self._thread.is_alive():
                    self._q.put(None)
                    self._thread.join()
                self.writer.close()
        self._check()
