"""The retrace sentinel (the port's copy of the sentinel of
kcmc_tpu/analysis/sanitize.py; its lock-order and leak sanitizer is not
ported).

plans/runtime.py notes every first build of a program key here. The
static bucket ladder predicts the whole key set of a warmed process
(`plans.runtime.predict_compile_keys`); arming the sentinel after
warm-up turns any further first build of a covered program into a
violation: the dispatched shape escaped the `plan_buckets` ladder.
Violations drain through `take_violations()`.
"""

from __future__ import annotations

import sys
import threading


class _RetraceSentinel:
    def __init__(self, covered, predicted, label):
        self.covered = frozenset(covered)
        self.predicted = frozenset(predicted or ())
        self.label = label
        self.counts: dict[tuple, int] = {}
        self.violations: list[str] = []
        self.lock = threading.Lock()


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


def take_violations() -> list[str]:
    """Drain the sentinel's violations: those of disarmed blocks, then
    the armed sentinel's."""
    out = list(_pending_sentinel_violations)
    _pending_sentinel_violations.clear()
    st = _SENTINEL
    if st is not None:
        with st.lock:
            out += st.violations
            st.violations = []
    return out
