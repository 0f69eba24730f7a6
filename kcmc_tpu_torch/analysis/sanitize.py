"""Runtime concurrency sanitizer and retrace sentinel (the port's copy
of kcmc_tpu/analysis/sanitize.py): `python -m kcmc_tpu_torch sanitize
-- CMD` or `KCMC_SANITIZE=1`.

The sanitizer watches the process. Three instruments, built to run a
real workload under them:

* **lock-order recording** — `threading.Lock`/`RLock`/`Condition`
  constructed from kcmc code are wrapped; each wrapper knows its
  creation site (`file:line`). Acquiring lock B while holding lock A
  records the runtime edge A→B; an edge that closes a cycle against
  the union of runtime edges AND the static lock-order graph is a
  violation. `Condition(existing_lock)` shares the wrapped lock's
  identity. Locks created by torch, the CUDA runtime or the standard
  library stay real.

* **deadlock watchdog** — a background thread (daemon: it touches no
  card) scans held wrappers; a lock held past the threshold WITH
  waiters dumps every thread's stack to stderr once and records a
  violation. The fast path stays lock-free: holder/waiter info lives
  in plain attributes the watchdog reads advisorily.

* **leak checking** — `leak_snapshot()` / `check_leaks(before)`
  bracket a test: threads started and not stopped (non-daemon, or any
  `kcmc-*`-named thread; the upload worker and the writers must be
  joined by the end of a run), sockets opened and not closed
  (`socket.socket` is subclass-patched while enabled), and telemetry
  artifact-path claims never released (`obs.run._ACTIVE_PATHS`).
  Process-lifetime-by-design resources are exempt: the shared decode
  pools of `io/feeder.py` (`kcmc-decode*`, and by ownership the
  process-pool manager threads they own).

The hot-path cost model: an uncontended acquire with no other lock
held is a thread-local list append/pop on top of the real acquire; the
sanitizer's own mutex is taken only to record a NEW edge (bounded by
the number of distinct lock pairs, not acquisitions).

The retrace sentinel is the runtime half of the bucket-escape rule:
plans/runtime.py notes every first build of a program key here; armed
after warm-up (`plans.runtime.predict_compile_keys` predicts the whole
key set of a warmed process), any further first build of a covered
program is a violation — the dispatched shape escaped the
`plan_buckets` ladder. Both drain through `take_violations()`.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time
import traceback
import weakref

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition
_REAL_SOCKET = None  # set at enable (socket imported lazily)

# Threads that are process-lifetime by design: shared decode-pool
# workers and the process-pool plumbing they own.
LEAK_EXEMPT_THREADS = (
    "kcmc-decode",
    "ExecutorManagerThread",
    "QueueFeederThread",
    "QueueManagerThread",
)

_STATE: _State | None = None


def _norm_path(filename: str) -> str:
    """Repo-relative identity for a frame filename: the tail from the
    last `kcmc_tpu_torch/` (or `tests/`) component."""
    norm = filename.replace(os.sep, "/")
    for anchor in ("kcmc_tpu_torch/", "tests/"):
        i = norm.rfind(anchor)
        if i >= 0:
            return norm[i:]
    return norm.rsplit("/", 1)[-1]


_THIS_FILE = os.path.abspath(__file__)


def _creation_site() -> tuple[str, int] | None:
    """(relpath, line) of the first frame outside this module and
    threading.py — None when the creator is not kcmc code (such locks
    stay uninstrumented)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if os.path.abspath(fn) != _THIS_FILE and not fn.endswith(
            ("threading.py",)
        ):
            norm = _norm_path(fn)
            if norm.startswith(("kcmc_tpu_torch/", "tests/")) or (
                "kcmc" in norm or norm.startswith("test_")
            ):
                return (norm, f.f_lineno)
            return None
        f = f.f_back
    return None


class _State:
    def __init__(self, static_edges, watchdog_s: float, strict: bool):
        self.mutex = _REAL_LOCK()
        self.static_edges: set = set(static_edges or ())
        self.edges: dict = {}  # (a, b) -> description
        self.violations: list[str] = []
        self.strict = bool(strict)
        self.watchdog_s = float(watchdog_s)
        self.locks_instrumented = 0
        self.acquisitions = 0  # advisory (unlocked increments)
        self._tl = threading.local()
        self.wrappers: weakref.WeakSet = weakref.WeakSet()
        self.sockets: weakref.WeakSet = weakref.WeakSet()
        self._watchdog: threading.Thread | None = None
        self._watchdog_stop = threading.Event()
        self._dumped: set = set()

    # -- per-thread held stack --------------------------------------------

    def held(self) -> list:
        h = getattr(self._tl, "held", None)
        if h is None:
            h = self._tl.held = []
        return h

    # -- order graph -------------------------------------------------------

    def note_acquired(self, wrapper) -> None:
        held = self.held()
        self.acquisitions += 1
        if wrapper in held:  # RLock reentrancy: no new edges
            held.append(wrapper)
            return
        new = []
        for h in held:
            if h.site != wrapper.site:
                new.append((h.site, wrapper.site))
        held.append(wrapper)
        if not new:
            return
        with self.mutex:
            for edge in new:
                if edge in self.edges:
                    continue
                self.edges[edge] = threading.current_thread().name
                cycle = self._find_cycle(edge)
                if cycle is not None:
                    msg = (
                        "lock-order violation: acquiring "
                        f"{_site_label(edge[1])} while holding "
                        f"{_site_label(edge[0])} closes the cycle "
                        + " -> ".join(_site_label(s) for s in cycle)
                    )
                    self.violations.append(msg)
                    print(f"[kcmc sanitize] {msg}", file=sys.stderr)
                    if self.strict:
                        raise RuntimeError(msg)

    def note_released(self, wrapper) -> None:
        held = self.held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is wrapper:
                del held[i]
                break

    def _find_cycle(self, new_edge):
        """A path new_edge[1] ->* new_edge[0] through runtime+static
        edges (the new edge then closes the cycle)."""
        graph: dict = {}
        for a, b in list(self.edges) + list(self.static_edges):
            graph.setdefault(a, set()).add(b)
        start, goal = new_edge[1], new_edge[0]
        stack, seen = [(start, (start,))], set()
        while stack:
            node, path = stack.pop()
            if node == goal:
                return path + (start,)
            if node in seen:
                continue
            seen.add(node)
            for nxt in graph.get(node, ()):
                stack.append((nxt, path + (nxt,)))
        return None

    # -- watchdog ----------------------------------------------------------

    def start_watchdog(self) -> None:
        if self.watchdog_s <= 0 or self._watchdog is not None:
            return
        self._watchdog_stop.clear()
        self._watchdog = threading.Thread(
            target=self._watch, name="kcmc-sanitize-watchdog", daemon=True
        )
        self._watchdog.start()

    def stop_watchdog(self) -> None:
        self._watchdog_stop.set()
        t, self._watchdog = self._watchdog, None
        if t is not None:
            t.join(timeout=2.0)

    def _watch(self) -> None:
        while not self._watchdog_stop.wait(
            max(0.05, min(self.watchdog_s / 4.0, 1.0))
        ):
            now = time.monotonic()
            for w in list(self.wrappers):
                holder = w._holder
                if holder is None or w._waiters <= 0:
                    continue
                hname, t_acq = holder
                if now - t_acq < self.watchdog_s:
                    continue
                key = (w.site, t_acq)
                if key in self._dumped:
                    continue
                self._dumped.add(key)
                msg = (
                    "deadlock suspect: lock "
                    f"{_site_label(w.site)} held {now - t_acq:.1f}s by "
                    f"{hname} with {w._waiters} waiter(s)"
                )
                with self.mutex:
                    self.violations.append(msg)
                print(f"[kcmc sanitize] {msg}", file=sys.stderr)
                self.dump_stacks()

    @staticmethod
    def dump_stacks() -> None:
        """Every thread's current stack, attributed by thread name."""
        names = {t.ident: t.name for t in threading.enumerate()}
        out = ["[kcmc sanitize] all-thread stack dump:"]
        for tid, frame in sorted(sys._current_frames().items()):
            out.append(f"--- thread {names.get(tid, '?')} ({tid}) ---")
            out.extend(
                line.rstrip()
                for line in traceback.format_stack(frame)
            )
        print("\n".join(out), file=sys.stderr, flush=True)


def _site_label(site) -> str:
    return f"{site[0]}:{site[1]}"


# -- instrumented primitives ------------------------------------------------


class _InstrumentedLock:
    """Wraps one real Lock/RLock; shares its creation-site identity
    with any Condition built on it."""

    def __init__(self, real, site, state):
        self._real = real
        self.site = site
        self._state = state
        self._holder = None  # (thread name, t_acquired) — advisory
        self._hold_depth = 0
        self._waiters = 0  # advisory
        state.wrappers.add(self)
        state.locks_instrumented += 1

    def acquire(self, blocking=True, timeout=-1):
        st = self._state
        if blocking:
            self._waiters += 1
        try:
            ok = self._real.acquire(blocking, timeout)
        finally:
            if blocking:
                self._waiters -= 1
        if ok:
            try:
                st.note_acquired(self)
            except BaseException:
                # strict mode raises on a cycle-closing acquisition:
                # the REAL lock was already taken — undo both sides or
                # the raise leaves it held forever
                st.note_released(self)
                self._real.release()
                raise
            self._hold_depth += 1
            if self._hold_depth == 1:
                self._holder = (
                    threading.current_thread().name,
                    time.monotonic(),
                )
        return ok

    def release(self):
        self._hold_depth -= 1
        if self._hold_depth <= 0:
            self._holder = None
            self._hold_depth = 0
        self._state.note_released(self)
        self._real.release()

    def locked(self):
        f = getattr(self._real, "locked", None)
        if f is not None:
            return f()
        # RLock has no locked() before 3.14: probe non-blockingly
        if self._real.acquire(False):
            self._real.release()
            return False
        return True

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # RLock protocol bits Condition uses
    def _is_owned(self):
        f = getattr(self._real, "_is_owned", None)
        if f is not None:
            return f()
        return self._real.locked()

    def _acquire_restore(self, state):
        self._real._acquire_restore(state)
        self._state.note_acquired(self)
        self._hold_depth += 1

    def _release_save(self):
        self._hold_depth = 0
        self._holder = None
        self._state.note_released(self)
        return self._real._release_save()

    def __repr__(self):
        return f"<kcmc-sanitized lock {_site_label(self.site)}>"


class _InstrumentedCondition:
    """A Condition sharing its (wrapped) lock's identity: waiting IS
    holding."""

    def __init__(self, lock_wrapper, state):
        self._lock = lock_wrapper
        self._real = _REAL_CONDITION(
            lock_wrapper._real
            if isinstance(lock_wrapper, _InstrumentedLock)
            else lock_wrapper
        )
        self._state = state
        self.site = getattr(lock_wrapper, "site", None)

    # lock protocol delegates to the instrumented lock
    def acquire(self, *a, **k):
        return self._lock.acquire(*a, **k)

    def release(self):
        self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False

    def wait(self, timeout=None):
        # the real wait releases the underlying lock: suspend the
        # wrapper's held/holder accounting for the duration
        lw = self._lock
        depth = lw._hold_depth
        lw._hold_depth = 0
        lw._holder = None
        for _ in range(depth):
            self._state.note_released(lw)
        try:
            return self._real.wait(timeout)
        finally:
            for _ in range(depth):
                self._state.note_acquired(lw)
            lw._hold_depth = depth
            lw._holder = (
                threading.current_thread().name, time.monotonic()
            )

    def wait_for(self, predicate, timeout=None):
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                waittime = endtime - time.monotonic()
                if waittime <= 0:
                    break
            else:
                waittime = None
            self.wait(waittime)
            result = predicate()
        return result

    def notify(self, n=1):
        self._real.notify(n)

    def notify_all(self):
        self._real.notify_all()


# -- factories (the monkeypatch surface) ------------------------------------


def _lock_factory():
    st = _STATE
    if st is None:
        return _REAL_LOCK()
    site = _creation_site()
    if site is None:
        return _REAL_LOCK()
    return _InstrumentedLock(_REAL_LOCK(), site, st)


def _rlock_factory():
    st = _STATE
    if st is None:
        return _REAL_RLOCK()
    site = _creation_site()
    if site is None:
        return _REAL_RLOCK()
    return _InstrumentedLock(_REAL_RLOCK(), site, st)


def _condition_factory(lock=None):
    st = _STATE
    if st is None:
        return _REAL_CONDITION(lock)
    if isinstance(lock, _InstrumentedLock):
        return _InstrumentedCondition(lock, st)
    if lock is not None:
        return _REAL_CONDITION(lock)
    site = _creation_site()
    if site is None:
        return _REAL_CONDITION()
    return _InstrumentedCondition(
        _InstrumentedLock(_REAL_RLOCK(), site, st), st
    )


# -- static graph bridge -----------------------------------------------------


def static_order_edges(root: str | None = None) -> set:
    """The static lock-order graph keyed by lock DEFINITION sites — the
    same (path, line) identity runtime wrappers carry, so the sanitizer
    convicts on one executed order plus one written reverse order."""
    from kcmc_tpu_torch.analysis.cli import find_repo_root
    from kcmc_tpu_torch.analysis.core import FunctionTable, ModuleIndex
    from kcmc_tpu_torch.analysis.lock_discipline import _ClassModel

    index = ModuleIndex.from_package(root or find_repo_root())
    edges: set = set()
    for mod in index:
        table = FunctionTable(mod.tree)
        for cls in table.classes.values():
            model = _ClassModel(mod, cls, table)
            for (outer, inner), (_line, _via) in model.order_edges().items():
                lo = model.locks.get(outer)
                li = model.locks.get(inner)
                if lo is not None and li is not None:
                    edges.add(((mod.path, lo), (mod.path, li)))
    return edges


# -- public surface ----------------------------------------------------------


def active() -> bool:
    return _STATE is not None


def enable(
    root: str | None = None,
    static: bool = True,
    watchdog_s: float = 10.0,
    strict: bool = False,
) -> None:
    """Install the sanitizer (idempotent): patch the lock factories,
    track sockets, merge the static lock-order graph, start the
    watchdog."""
    global _STATE, _REAL_SOCKET
    if _STATE is not None:
        return
    edges = set()
    if static:
        try:
            edges = static_order_edges(root)
        except Exception as e:  # static graph is an enhancement only
            print(
                f"[kcmc sanitize] static lock-order graph unavailable "
                f"({e}); runtime-only order checking",
                file=sys.stderr,
            )
    st = _State(edges, watchdog_s, strict)
    _STATE = st
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory
    import socket as _socket_mod

    _REAL_SOCKET = _socket_mod.socket

    class _TrackedSocket(_REAL_SOCKET):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if _STATE is not None:
                _STATE.sockets.add(self)

    _socket_mod.socket = _TrackedSocket
    st.start_watchdog()
    atexit.register(_report_at_exit)


def disable() -> None:
    """Remove the patches (wrappers already handed out keep working —
    they delegate to real primitives)."""
    global _STATE, _REAL_SOCKET
    st = _STATE
    if st is None:
        return
    st.stop_watchdog()
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION
    if _REAL_SOCKET is not None:
        import socket as _socket_mod

        _socket_mod.socket = _REAL_SOCKET
        _REAL_SOCKET = None
    _STATE = None


def take_violations() -> list[str]:
    """Drain the accumulated violations (lock-order cycles, deadlock
    suspects, retrace-sentinel convictions) — the per-test gate."""
    out = _drain_sentinel()
    st = _STATE
    if st is None:
        return out
    with st.mutex:
        out, st.violations = out + st.violations, []
    return out


def stats() -> dict:
    st = _STATE
    if st is None:
        return {"active": False}
    with st.mutex:
        return {
            "active": True,
            "locks_instrumented": st.locks_instrumented,
            "acquisitions": st.acquisitions,
            "order_edges": len(st.edges),
            "static_edges": len(st.static_edges),
            "violations": len(st.violations),
        }


# -- leak checking -----------------------------------------------------------


def _thread_key(t: threading.Thread) -> tuple:
    return (t.ident, t.name)


def _shared_pool_threads() -> set[int]:
    """Thread idents owned by the process-lifetime shared decode pools
    (the `kcmc_tpu_torch.io.feeder` registry): their executor
    manager/worker threads are unnamed stdlib threads, so exempt them by
    ownership, not name."""
    out: set[int] = set()
    feeder = sys.modules.get("kcmc_tpu_torch.io.feeder")
    if feeder is None:
        return out
    try:
        with feeder._SHARED_LOCK:
            pools = list(feeder._SHARED.values())
    except Exception:
        return out
    for pool in pools:
        ex = getattr(pool, "_ex", None)
        mgr = getattr(ex, "_executor_manager_thread", None)
        if mgr is not None and mgr.ident is not None:
            out.add(mgr.ident)
        for t in list(getattr(ex, "_threads", ()) or ()):
            if t.ident is not None:
                out.add(t.ident)
    return out


def _active_paths() -> set:
    """The live telemetry path claims of `kcmc_tpu_torch.obs.run`."""
    from kcmc_tpu_torch.obs import run as obs_run

    with obs_run._PATHS_LOCK:
        return set(obs_run._ACTIVE_PATHS)


def leak_snapshot() -> dict:
    """What is alive NOW: bracket a test with this + check_leaks."""
    snap = {
        "threads": {_thread_key(t) for t in threading.enumerate()},
        "paths": _active_paths(),
        "sockets": set(),
    }
    st = _STATE
    if st is not None:
        snap["sockets"] = {
            id(s) for s in list(st.sockets) if s.fileno() != -1
        }
    return snap


def check_leaks(before: dict, grace_s: float = 2.0) -> list[str]:
    """Leaks relative to `before`: threads still running that a test
    started (after a grace join — finishing threads are not leaks),
    sockets still open, telemetry path claims never released."""
    leaks: list[str] = []
    known = before.get("threads", set())
    deadline = time.monotonic() + grace_s

    def candidates():
        out = []
        shared = _shared_pool_threads()
        for t in threading.enumerate():
            if _thread_key(t) in known or t is threading.current_thread():
                continue
            if any(t.name.startswith(p) for p in LEAK_EXEMPT_THREADS):
                continue
            if t.name == "kcmc-sanitize-watchdog" or t.ident in shared:
                continue
            if not t.daemon or t.name.startswith("kcmc-"):
                out.append(t)
        return out

    cands = candidates()
    for t in cands:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    for t in candidates():
        leaks.append(
            f"leaked thread '{t.name}' "
            f"({'non-daemon' if not t.daemon else 'daemon'}) still "
            "alive after the test (join it on the owner's stop path)"
        )
    for p in sorted(_active_paths() - before.get("paths", set())):
        leaks.append(
            f"leaked telemetry path claim {p!r} (RunTelemetry "
            "finish/close never ran)"
        )
    st = _STATE
    if st is not None:
        before_socks = before.get("sockets", set())
        for s in list(st.sockets):
            try:
                open_now = s.fileno() != -1
            except Exception:
                open_now = False
            if open_now and id(s) not in before_socks:
                leaks.append(
                    f"leaked socket {s!r} opened during the test and "
                    "never closed"
                )
    return leaks


# -- retrace sentinel --------------------------------------------------------


class _RetraceSentinel:
    def __init__(self, covered, predicted, label):
        self.covered = frozenset(covered)
        self.predicted = frozenset(predicted or ())
        self.label = label
        self.counts: dict[tuple, int] = {}
        self.violations: list[str] = []
        self.lock = _REAL_LOCK()


_SENTINEL: _RetraceSentinel | None = None

DEFAULT_COVERED_PROGRAMS = ("reference", "register", "apply")

# violations that outlive a disarmed sentinel, drained with its own
_pending_sentinel_violations: list[str] = []


def note_compile(
    program: str,
    shape: tuple,
    dtype: str,
    rung: str = "full",
    during_build: bool = False,
) -> None:
    """The observation hook (PlanRuntime.timed, on every first build of
    a program key). A no-op unless a sentinel is armed; builds driven by
    ExecutionPlan (`during_build`) are the warm-up itself and never
    convict."""
    st = _SENTINEL
    if st is None:
        return
    key = (program, tuple(shape), str(dtype))
    with st.lock:
        st.counts[key] = st.counts.get(key, 0) + 1
    if during_build or program not in st.covered:
        return
    shape_s = "x".join(str(s) for s in shape)
    hint = ""
    if st.predicted:
        hint = (
            " - the static bucket ladder predicted "
            f"{len(st.predicted)} compile keys, all already warmed"
            if key not in st.predicted
            else " - a predicted key compiled AGAIN after warm-up"
        )
    msg = (
        f"retrace sentinel{f' [{st.label}]' if st.label else ''}: "
        f"program '{program}' compiled at {shape_s}/{dtype} (rung "
        f"{rung}) after warm-up{hint}; the dispatched shape escaped "
        "the plan_buckets ladder"
    )
    with st.lock:
        st.violations.append(msg)
    print(f"[kcmc sanitize] {msg}", file=sys.stderr)


def arm_retrace_sentinel(
    covered=DEFAULT_COVERED_PROGRAMS, predicted=None, label: str = ""
) -> None:
    """Arm after warm-up: from now on any first build of a covered
    program is a violation. `predicted` (a predict_compile_keys set)
    only sharpens the message."""
    global _SENTINEL
    _SENTINEL = _RetraceSentinel(covered, predicted, label)


def disarm_retrace_sentinel() -> None:
    global _SENTINEL
    _SENTINEL = None


class retrace_sentinel:
    """Context manager: `with sanitize.retrace_sentinel(...):` around
    warmed traffic. Violations recorded inside the block stay pending
    for take_violations(), so the block arms and disarms without
    swallowing the report."""

    def __init__(self, covered=DEFAULT_COVERED_PROGRAMS, predicted=None,
                 label: str = ""):
        self._args = (covered, predicted, label)

    def __enter__(self):
        arm_retrace_sentinel(*self._args)
        return _SENTINEL

    def __exit__(self, *exc):
        st = _SENTINEL
        if st is not None and st.violations:
            with st.lock:
                pending, st.violations = list(st.violations), []
            _pending_sentinel_violations.extend(pending)
        disarm_retrace_sentinel()
        return False


def sentinel_stats() -> dict:
    st = _SENTINEL
    if st is None:
        return {"armed": False}
    with st.lock:
        return {
            "armed": True,
            "covered": sorted(st.covered),
            "compiles": {
                f"{p}|{'x'.join(str(s) for s in shape)}|{dt}": n
                for (p, shape, dt), n in sorted(st.counts.items())
            },
            "violations": len(st.violations),
        }


def _drain_sentinel() -> list[str]:
    out = list(_pending_sentinel_violations)
    _pending_sentinel_violations.clear()
    st = _SENTINEL
    if st is not None:
        with st.lock:
            out += st.violations
            st.violations = []
    return out


# -- env / CLI entry ---------------------------------------------------------


def maybe_enable_from_env() -> bool:
    """Honor KCMC_SANITIZE=1 (options via KCMC_SANITIZE_WATCHDOG /
    KCMC_SANITIZE_STATIC / KCMC_SANITIZE_STRICT). Called from the CLI
    entry (`python -m kcmc_tpu_torch ...`)."""
    if os.environ.get("KCMC_SANITIZE", "") not in ("1", "true", "yes"):
        return False
    enable(
        static=os.environ.get("KCMC_SANITIZE_STATIC", "1") != "0",
        watchdog_s=float(os.environ.get("KCMC_SANITIZE_WATCHDOG", "10")),
        strict=os.environ.get("KCMC_SANITIZE_STRICT", "") == "1",
    )
    return True


def _report_at_exit() -> None:
    st = _STATE
    if st is None:
        return
    s = stats()
    line = (
        f"[kcmc sanitize] {s['locks_instrumented']} locks instrumented, "
        f"{s['acquisitions']} acquisitions, {s['order_edges']} order "
        f"edges ({s['static_edges']} static), "
        f"{s['violations']} violation(s)"
    )
    print(line, file=sys.stderr)
    for v in st.violations:
        print(f"[kcmc sanitize] UNRESOLVED: {v}", file=sys.stderr)


def main(argv=None) -> int:
    """`kcmc sanitize [opts] -- cmd args…`: re-exec a command with the
    sanitizer armed through the environment; `python -m kcmc_tpu_torch
    …` runs pick it up in the CLI entry (`maybe_enable_from_env`)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="kcmc sanitize",
        description=(
            "run a command under the runtime concurrency sanitizer "
            "(instrumented locks + lock-order validation against the "
            "static graph, deadlock watchdog, leak checking; "
            "docs/ANALYSIS.md)"
        ),
    )
    ap.add_argument(
        "--watchdog", type=float, default=10.0, metavar="SECS",
        help="dump all thread stacks when a lock is held this long "
        "with waiters (default 10)",
    )
    ap.add_argument(
        "--no-static", action="store_true",
        help="skip merging the static lock-order graph",
    )
    ap.add_argument(
        "--strict", action="store_true",
        help="raise at the acquisition that closes a lock-order cycle "
        "instead of recording it",
    )
    ap.add_argument(
        "cmd", nargs=argparse.REMAINDER,
        help="command to run (e.g. pytest tests/test_serve.py -q)",
    )
    args = ap.parse_args(argv)
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":  # only the leading separator is ours
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (e.g. kcmc sanitize pytest tests/ -q)")
    env = dict(os.environ)
    env["KCMC_SANITIZE"] = "1"
    env["KCMC_SANITIZE_WATCHDOG"] = str(args.watchdog)
    env["KCMC_SANITIZE_STATIC"] = "0" if args.no_static else "1"
    if args.strict:
        env["KCMC_SANITIZE_STRICT"] = "1"
    if cmd[0] == "pytest":
        cmd = [sys.executable, "-m", "pytest"] + cmd[1:]
    import subprocess

    return subprocess.call(cmd, env=env)


if __name__ == "__main__":
    sys.exit(main())
