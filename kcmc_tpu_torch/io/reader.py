"""Background-prefetching chunked stack loader.

Overlaps host-side decode (the native threaded TIFF decoder, or any
array-like source) with device compute: a reader thread keeps a small
queue of decoded (lo, hi, ndarray) chunks ahead of the consumer, so the
card never waits on disk or decompression (the port's copy of
kcmc_tpu/io/reader.py). This is the host half of the
streaming pipeline; the device half is the orchestrator's dispatch-ahead
window (corrector.py).

Chunk reads are the run's storage-failure surface: with a
`RetryPolicy` attached (corrector runs pass theirs), transient read
errors (flaky NFS, anything
`classify_transient` accepts) are retried with exponential backoff
before surfacing; a `FaultPlan` injects deterministic faults here for
chaos testing (surface ``io_read``).
"""

from __future__ import annotations

import os
import queue
import threading
import time

import numpy as np


class ChunkedStackLoader:
    """Iterate (lo, hi, frames) chunks of a stack with background prefetch.

    source: any io.formats protocol reader (TiffStack, ZarrStack,
    HDF5Stack, ...), a path (dispatched via open_stack), or any
    array-like with numpy-style slicing along axis 0 (ndarray, memmap,
    zarr-ish).

    fault_plan / retry / report: optional robustness wiring
    (utils/faults.FaultPlan, utils/faults.RetryPolicy,
    utils/metrics.RobustnessReport) — chunk reads are retried per the
    policy, injected faults fire per the plan, retries are counted in
    the report. All None by default: the bare loader reads exactly
    once. ``retry="default"`` resolves through
    `utils.faults.default_io_retry_policy`, the shared ingest-surface
    construction point (corrector runs, the feeder, and the
    object-store path all build theirs there, so backoff/jitter/
    classification cannot drift between surfaces).

    on_wait: optional callback(seconds) invoked whenever the CONSUMER
    blocks waiting for the prefetch thread — the pipeline-stall
    telemetry hook (a well-fed pipeline never calls it).

    io_workers / pool / source_path / reader_options: the feeder-pool
    seam (io/feeder.py). With `io_workers >= 2` and a source whose decode is
    pool-friendly (`feeder.classify_source`), chunks are sharded into
    per-worker page spans and decoded by a process pool (GIL-bound
    pure-Python codecs) or a thread pool (GIL-releasing decode) with
    ordered reassembly — pass an explicit `pool` (e.g. from
    `feeder.shared_pool`) to reuse warm workers across loaders, and
    `source_path`/`reader_options` when `source` is an already-open
    reader so workers can reopen it (paths passed AS `source` respec
    themselves). `tracer` records one `feeder.decode` span per pooled
    chunk; `stats` (a dict) accumulates feeder counters in place.
    """

    def __init__(
        self,
        source,
        chunk_size: int = 64,
        start: int = 0,
        stop: int | None = None,
        prefetch: int = 2,
        n_threads: int = 0,
        fault_plan=None,
        retry=None,
        report=None,
        on_wait=None,
        io_workers: int = 0,
        pool=None,
        source_path=None,
        reader_options: dict | None = None,
        tracer=None,
        stats: dict | None = None,
    ):
        self._own = False
        if isinstance(source, (str, os.PathLike)):
            from kcmc_tpu_torch.io.formats import open_stack

            source_path = source if source_path is None else source_path
            source = open_stack(source, n_threads=n_threads)
            self._own = True
        self.source = source
        self.n_total = len(source)
        self.start = start
        self.stop = self.n_total if stop is None else min(stop, self.n_total)
        self.chunk_size = chunk_size
        self.prefetch = max(1, prefetch)
        self._fault_plan = fault_plan
        if retry == "default":
            from kcmc_tpu_torch.utils.faults import default_io_retry_policy

            retry = default_io_retry_policy(None)
        self._retry = retry
        self._report = report
        self._on_wait = on_wait
        self._tracer = tracer
        self.stats = stats if stats is not None else {}
        self._pool = None
        self._spec = None
        if pool is not None or io_workers >= 2:
            from kcmc_tpu_torch.io import feeder

            kind = feeder.classify_source(self.source)
            spec = feeder.source_spec(self.source, source_path, reader_options)
            if kind is not None and spec is not None:
                self._pool = (
                    pool
                    if pool is not None
                    else feeder.shared_pool(kind, io_workers)
                )
                self._spec = spec
                self.stats.setdefault("mode", self._pool.kind)
                self.stats.setdefault("workers", self._pool.workers)
            elif kind == "process":
                # Pool requested but unusable (no reopenable path): the
                # GIL serializes this source's pure-Python codec.
                self._advise_single_core()
        elif self._gil_bound():
            # No pool requested on a GIL-bound source: the run decodes
            # single-core (satellite of ROADMAP item 3 — make the cliff
            # visible instead of silently eating a many-x slowdown).
            self._advise_single_core()

    def _gil_bound(self) -> bool:
        from kcmc_tpu_torch.io import feeder

        return feeder.classify_source(self.source) == "process"

    def _advise_single_core(self) -> None:
        # once per run: segmented runs build one loader per span but
        # share a stats dict, so the advisory does not repeat
        if self.stats.get("single_core_advised"):
            return
        self.stats["single_core_advised"] = True
        from kcmc_tpu_torch.obs.log import advise

        name = getattr(self.source, "path", type(self.source).__name__)
        advise(
            f"kcmc: {name}: compressed pages decode through the "
            "pure-Python fallback codec on a single core (GIL-bound, "
            "a many-x slowdown); set io_workers >= 2 to decode in a "
            "process pool, or install a "
            "C++ toolchain so the native threaded decoder builds",
            stacklevel=3,
        )

    def _read_raw(self, lo: int, hi: int) -> np.ndarray:
        if hasattr(self.source, "read"):  # io.formats protocol readers
            return self.source.read(lo, hi)
        return np.asarray(self.source[lo:hi])

    def _read(self, lo: int, hi: int) -> np.ndarray:
        """One chunk read, retried per the attached policy.

        Transient failures (OS-level IO errors, injected transient
        faults) back off and retry up to the policy's attempt budget;
        fatal errors and exhausted budgets raise to the consumer.
        """
        plan, policy = self._fault_plan, self._retry
        if plan is None and policy is None:
            return self._read_raw(lo, hi)  # zero-overhead happy path
        from kcmc_tpu_torch.utils.faults import classify_transient

        step = plan.op_index("io_read") if plan is not None else None
        attempts = policy.attempts if policy is not None else 1
        for attempt in range(attempts):
            try:
                if plan is not None:
                    plan.maybe_fail("io_read", step)
                return self._read_raw(lo, hi)
            except Exception as e:
                if attempt == attempts - 1 or not classify_transient(e):
                    raise
                if self._report is not None:
                    self._report.io_retries += 1
                if policy is not None:
                    policy.sleep(policy.delay(attempt))
        raise AssertionError("unreachable")  # loop always returns/raises

    def __len__(self) -> int:
        return self.stop - self.start

    def __iter__(self):
        if self._pool is not None:
            from kcmc_tpu_torch.io import feeder

            yield from feeder.pooled_chunks(
                self._pool,
                self._spec,
                self.start,
                self.stop,
                self.chunk_size,
                self.prefetch,
                fault_plan=self._fault_plan,
                retry=self._retry,
                report=self._report,
                on_wait=self._on_wait,
                tracer=self._tracer,
                stats=self.stats,
            )
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop_flag = threading.Event()

        def producer():
            try:
                for lo in range(self.start, self.stop, self.chunk_size):
                    if stop_flag.is_set():
                        return
                    hi = min(lo + self.chunk_size, self.stop)
                    q.put((lo, hi, self._read(lo, hi)))
            except Exception as e:  # surface decode errors to consumer
                q.put(e)
                return
            except BaseException as e:
                # KeyboardInterrupt/SystemExit in the producer thread
                # are NOT decode errors, but a clean end-of-stream here
                # would let the consumer finish successfully on
                # truncated data — surface a loud, correctly-attributed
                # error instead, and let the original exception
                # terminate this thread.
                q.put(RuntimeError(
                    f"stack read interrupted by {type(e).__name__} in "
                    "the prefetch thread (not an input decode error)"
                ))
                raise
            q.put(None)

        t = threading.Thread(
            target=producer, name="kcmc-prefetch", daemon=True
        )
        t.start()
        try:
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    t0 = time.perf_counter()
                    item = q.get()
                    if self._on_wait is not None:
                        self._on_wait(time.perf_counter() - t0)
                if item is None:
                    return
                if isinstance(item, Exception):
                    # the exception object still carries the producer-
                    # side traceback; raising appends the consumer frame
                    raise item
                # the feeder counters of the prefetch-thread flavor
                # (one span per chunk), counted on the consumer
                st = self.stats
                st.setdefault("mode", "prefetch")
                st.setdefault("workers", 1)
                for k, v in (("chunks", 1), ("spans", 1), ("frames", item[1] - item[0])):
                    st[k] = st.get(k, 0) + int(v)
                yield item
        finally:
            stop_flag.set()
            # drain so the producer's blocked put() can finish
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)

    def close(self):
        if self._own:
            self.source.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
