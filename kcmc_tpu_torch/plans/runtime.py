"""PlanRuntime: the per-backend execution-plan state (the port's
counterpart of kcmc_tpu/plans/runtime.py).

One instance rides on every TorchBackend. It owns:

* the normalized bucket ladder and shape routing (plans/buckets.py);
* the plan-stamp cache handle (plans/cache.py), resolved from
  `compile_cache_dir` / the `KCMC_COMPILE_CACHE` environment variable;
  resolving it activates the persistent kernel cache of
  `ops/cuda_build.py`;
* build accounting: every program's first run per (program, shape,
  dtype, rung) goes through `timed()`, which (with a persistent cache)
  checks and writes plan stamps (a hit only when the program's kernel
  libraries were already in the cache directory), updates the counters,
  notes the build for the retrace sentinel (analysis/sanitize.py), opens
  a profiler range (`kcmc.plan_build` inside an ExecutionPlan build,
  `kcmc.jit_compile` otherwise) and emits the `plan_build` /
  `jit_compile` span plus a `plan_cache_hit` / `plan_cache_miss`
  instant to every registered tracer (obs/run.py registers the run's
  Tracer while a traced run is live);
* the bucket-routing counters (`bucket_exact` / `bucket_padded` /
  `bucket_fallback`), one count per dispatched batch.

`stats()` is the snapshot that lands in `timing["plan_cache"]`.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import time

import torch

from kcmc_tpu_torch.analysis import sanitize as _sanitize
from kcmc_tpu_torch.ops import cuda_build
from kcmc_tpu_torch.plans.buckets import normalize_buckets, route_shape
from kcmc_tpu_torch.plans.cache import PlanCache, enable_compile_cache

# -- tracer listeners ------------------------------------------------------
# Registered by RunTelemetry while a traced run is live; build events
# from any thread become spans on the live trace. Module-level because
# builds happen below the level where a run's telemetry handle is
# visible.
_LISTENER_LOCK = threading.Lock()
_TRACERS: list = []

_EVENT_CAP = 128  # bounded per-backend event history in stats()

_CODE_FPR: str | None = None  # process-wide source fingerprint (lazy)

_MATRIX_MODELS = ("translation", "rigid", "similarity", "affine", "homography")
_SOURCE_SUFFIXES = (".py", ".cu", ".cuh", ".cpp")


def add_tracer(tracer) -> None:
    with _LISTENER_LOCK:
        if tracer not in _TRACERS:
            _TRACERS.append(tracer)


def discard_tracer(tracer) -> None:
    with _LISTENER_LOCK:
        try:
            _TRACERS.remove(tracer)
        except ValueError:
            pass


def _live_tracers() -> list:
    with _LISTENER_LOCK:
        return list(_TRACERS)


def resolve_cache_dir(config) -> str | None:
    """The configured cache directory (`compile_cache_dir`, else
    `KCMC_COMPILE_CACHE`), activated process-wide; None when neither is
    set. The first directory a process activates wins."""
    path = getattr(config, "compile_cache_dir", None) or os.environ.get(
        "KCMC_COMPILE_CACHE"
    ) or None
    return enable_compile_cache(path) if path else None


def code_fingerprint() -> str:
    """Fingerprint of the installed kcmc_tpu_torch tree: sha256 over the
    sorted (relpath, size, mtime_ns) of every .py source and every
    `csrc/` and `native/` source, computed once per process. Part of
    every program key, so an edit that does not bump __version__ still
    misses the stamps of the old code."""
    global _CODE_FPR
    if _CODE_FPR is None:
        import kcmc_tpu_torch

        root = os.path.dirname(os.path.abspath(kcmc_tpu_torch.__file__))
        entries = []
        for dirpath, dirnames, files in os.walk(root):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in files:
                if not f.endswith(_SOURCE_SUFFIXES):
                    continue
                p = os.path.join(dirpath, f)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append((os.path.relpath(p, root), st.st_size, st.st_mtime_ns))
        h = hashlib.sha256()
        for e in sorted(entries):
            h.update(repr(e).encode())
        _CODE_FPR = h.hexdigest()[:16]
    return _CODE_FPR


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class PlanRuntime:
    def __init__(self, config, backend_name: str = "torch", device=None,
                 libraries=None, mesh=None):
        self.config = config
        # the mesh's shape is part of every stamp key (runtime.py:79-80)
        self.mesh_shape = (len(mesh),) if mesh is not None else None
        # program -> the kernel libraries (cuda_build names) it launches:
        # a stamp is a hit only while they are in the cache directory
        self.libraries = libraries or (lambda program: ())
        # libraries ExecutionPlan.build's nvcc round just wrote (their
        # programs run after it, so existence alone would not show it)
        self.fresh: set = set()
        self.backend_name = backend_name
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.buckets = normalize_buckets(config.plan_buckets)
        self.cache_dir = resolve_cache_dir(config)
        self.cache = PlanCache(self.cache_dir)
        # consensus-budget rung label ("full"; the reference's serving
        # scheduler tags a reduced-budget backend "degraded")
        self.rung = "full"
        self.building = False  # True inside ExecutionPlan.build
        self._lock = threading.Lock()
        self._seen: set = set()
        self._config_sha: str | None = None
        self.counters = {
            "programs_compiled": 0,
            "compile_s": 0.0,
            "stamp_hits": 0,
            "stamp_misses": 0,
            "bucket_exact": 0,
            "bucket_padded": 0,
            "bucket_fallback": 0,
        }
        self.events: list[dict] = []
        # first builds per (program, shape, dtype, rung): the retrace
        # sentinel's observation side, which predict_compile_keys
        # predicts for a warmed process
        self.compile_counts: dict[tuple, int] = {}

    # -- routing -----------------------------------------------------------

    @property
    def active(self) -> bool:
        """Whether bucket routing is configured at all."""
        return bool(self.buckets)

    @property
    def enabled(self) -> bool:
        """Whether any plan surface (routing or persistent cache) is on."""
        return self.active or self.cache.persistent

    def routable(self, shape) -> bool:
        """Whether bucket routing covers this config and frame rank: 2D
        matrix models, single scale (the pyramid's resize would blend
        pad zeros into octave pixels), dense matching (the banded
        matcher's spatial buckets are laid out over the padded extent)
        and a detection border that keeps every descriptor patch inside
        the valid extent (+1: subpixel positions shift the patch support
        by up to half a pixel each way), as the reference gates it
        (runtime.py:129-157)."""
        from kcmc_tpu_torch.ops.patterns import ROT_RADIUS

        cfg = self.config
        return (
            self.active
            and len(shape) == 2
            and cfg.model in _MATRIX_MODELS
            and cfg.n_octaves <= 1
            and cfg.match_radius is None
            and cfg.border >= ROT_RADIUS + 1
        )

    def route(self, shape) -> tuple[int, int] | None:
        """The bucket for `shape`, or None (not routable / no cover)."""
        if not self.routable(shape):
            return None
        return route_shape(shape, self.buckets)

    def note_route(self, kind: str) -> None:
        """Count one dispatched batch's routing outcome."""
        with self._lock:
            self.counters[kind] += 1

    # -- build accounting --------------------------------------------------

    def config_sha(self) -> str:
        if self._config_sha is None:
            from kcmc_tpu_torch.obs.manifest import config_digest

            self._config_sha = config_digest(self.config)[1]
        return self._config_sha

    def first_time(self, program: str, shape, dtype: str) -> bool:
        """Whether this (program, shape, dtype) has not run yet in this
        runtime: the gate of `timed()`, one set lookup in steady state."""
        key = (program, tuple(shape), str(dtype), self.rung)
        with self._lock:
            if key in self._seen:
                return False
            self._seen.add(key)
            return True

    def program_stamp_key(self, program: str, shape, dtype: str) -> str:
        """What a build of this program depends on: the package version
        and code fingerprint (the kernel sources included), torch and
        its CUDA version, the device, the backend, the config digest,
        the mesh's shape, and the program's name, shape, dtype and
        rung."""
        from kcmc_tpu_torch import __version__

        return self.cache.program_key(
            kcmc=__version__,
            code=code_fingerprint(),
            torch=torch.__version__,
            cuda=torch.version.cuda,
            device=device_name(self.device),
            backend=self.backend_name,
            config=self.config_sha(),
            program=program,
            shape=tuple(int(s) for s in shape),
            dtype=str(dtype),
            mesh=self.mesh_shape,
            rung=self.rung,
        )

    def maybe_timed(self, program: str, shape, dtype: str):
        """`timed(...)` on the first run of this program key, a no-op
        context afterwards."""
        if self.first_time(program, shape, dtype):
            return self.timed(program, shape, dtype)
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def timed(self, program: str, shape, dtype: str):
        """Time one first run of a program and account its stamp,
        counters and event. The wall time covers the kernel library
        loads, the allocator's first blocks and the run itself (synced
        on the card); a failed build is neither stamped nor counted."""
        persistent = self.cache.persistent
        if persistent:
            stamp_key = self.program_stamp_key(program, shape, dtype)
            libs = [cuda_build.target(n) for n in self.libraries(program)]
            # a library this warmup had to build was not in the cache
            hit = self.cache.check(stamp_key, libs) and not self.fresh.intersection(libs)
        else:
            hit = False
        span = "plan_build" if self.building else "jit_compile"
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"kcmc.{span}"):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        dur = time.perf_counter() - t0
        event = {
            "program": program,
            "shape": [int(s) for s in shape],
            "dtype": str(dtype),
            "rung": self.rung,
            "seconds": round(dur, 4),
            "stamp_hit": hit if persistent else None,
        }
        count_key = (program, tuple(int(s) for s in shape), str(dtype), self.rung)
        with self._lock:
            self.counters["programs_compiled"] += 1
            self.counters["compile_s"] += dur
            if persistent:
                self.counters["stamp_hits" if hit else "stamp_misses"] += 1
            if len(self.events) < _EVENT_CAP:
                self.events.append(event)
            self.compile_counts[count_key] = self.compile_counts.get(count_key, 0) + 1
        _sanitize.note_compile(
            program,
            tuple(int(s) for s in shape),
            str(dtype),
            rung=self.rung,
            during_build=self.building,
        )
        for tracer in _live_tracers():
            try:
                tracer.complete(span, t0, dur, cat="plan", args=event)
                if persistent:
                    tracer.instant(
                        "plan_cache_hit" if hit else "plan_cache_miss",
                        cat="plan",
                        args={"program": program, "key": stamp_key},
                    )
            except Exception:
                pass
        if persistent and not hit:
            self.cache.stamp(stamp_key, dict(event, key=stamp_key,
                                             config_sha256=self.config_sha(),
                                             libraries=[p.name for p in libs]))

    # -- snapshot ----------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
            events = list(self.events)
            compile_counts = {
                f"{p}|{'x'.join(str(s) for s in shape)}|{dt}|{rung}": n
                for (p, shape, dt, rung), n in sorted(self.compile_counts.items())
            }
        return {
            "enabled": self.enabled,
            "persistent": self.cache.persistent,
            "cache_dir": self.cache_dir,
            "buckets": [list(b) for b in self.buckets],
            "rung": self.rung,
            **{k: (round(v, 4) if isinstance(v, float) else v) for k, v in counters.items()},
            "compile_counts": compile_counts,
            "events": events,
        }


def predict_compile_keys(
    config,
    programs: tuple = ("reference", "register", "apply"),
    dtypes: tuple = ("float32",),
) -> set:
    """The build-key set the static bucket ladder predicts for a warmed
    process: one (program, bucket, dtype) per declared bucket,
    "register" per warmed dtype and "reference" / "apply" in float32 (the
    reference and the apply warp run in float32 whatever the upload
    dtype). The same key family `PlanRuntime.compile_counts` records and
    `ExecutionPlan.build` drives, so the static prediction and the
    retrace sentinel cross-check each other."""
    buckets = normalize_buckets(getattr(config, "plan_buckets", config))
    out: set = set()
    for b in buckets:
        for p in programs:
            for dt in dtypes if p == "register" else ("float32",):
                out.add((p, tuple(b), str(dt)))
    return out
