"""Deterministic fault injection + retry/backoff policy (the port's
copy of kcmc_tpu/utils/faults.py).

A multi-hour `correct_file` run over millions of frames must survive
transient I/O errors and corrupt checkpoints instead of dying at frame
800k. This module provides both halves of that story:

* **FaultPlan** — a seedable, deterministic fault injector. A plan is
  parsed from a compact spec string and armed around the failure
  surfaces of a run: chunk reads (``io_read``, in
  `io.reader.ChunkedStackLoader` and the decode pool), per-batch device
  execution (``device``, in `MotionCorrector`'s dispatch), the failover
  rung (``failover``) and checkpoint part load (``checkpoint``, in
  `utils.checkpoint.load_stream_checkpoint`). The serve, fleet and
  object surfaces of the reference's grammar (``transport``,
  ``scheduler``, ``journal``, ``fleet``, ``object``) parse, but nothing
  in the port arms them yet. Activated via
  `CorrectorConfig(fault_plan=...)` or the ``KCMC_FAULT_PLAN``
  environment variable — so chaos runs need no code changes.

* **RetryPolicy** — bounded retries with exponential backoff and
  seeded jitter, shared by the IO and device retry loops.

* **classify_transient** — the transient-vs-fatal error split the
  retry engine keys on. Transient errors (injected transient faults,
  OS-level IO errors) are retried and walked down the degradation
  ladder; fatal errors (shape/config bugs, a CUDA error) are raised
  immediately so real defects never get papered over.
  **classify_device_transient** narrows it for the batch program,
  which does no I/O: there an OSError is fatal too.

Spec grammar::

    plan    := clause ("," clause)*
    clause  := surface (":" token)*
    surface := io_read | device | failover | checkpoint
              | transport | scheduler | journal | fleet | object
    token   := key "=" value | action
    action  := transient (default) | fatal | raise (alias of fatal)
              | always (alias of times=inf)
              | drop (object only; alias of transient — a dropped
                connection)
              | truncate (object only: the op returns a TRUNCATED
                body instead of raising)
              | flip (object only: one bit of the returned body is
                flipped — checksum/etag-mismatch simulation)
              | throttle (object only: the op raises a 429/503-style
                ObjectStoreThrottled, retried with backoff)
    keys    := step=N          which operation of that surface fails
                               (0-based; omitted = every operation)
               times=N|inf     how many matching ATTEMPTS fail before
                               the clause is spent (default 1)
               p=F             fail each matching attempt with
                               probability F (seeded, deterministic)
               corrupt_part=N  checkpoint surface only: corrupt part
                               file N on disk before it is loaded
               stall=SECS      transport/scheduler/fleet/object
                               surfaces only: the matched operation
                               STALLS for SECS seconds instead of
                               raising (half-open socket / wedged
                               scheduler / stalled health scrape /
                               slow object GET simulation; consumed
                               via `take_stall`)

Example — the chaos trifecta::

    io_read:step=3:raise, device:step=7:transient, checkpoint:corrupt_part=1

`times=` counts *attempts*, so ``device:step=7:times=2:transient``
fails the first two attempts at batch 7 and lets the third (the second
retry) succeed — the canonical "retries absorb the fault" scenario.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import time

import numpy as np

SURFACES = (
    "io_read",
    "device",
    "failover",
    "checkpoint",
    # the reference's serve, fleet and object-store surfaces: parsed
    # (one grammar), armed by no code of the port yet
    "transport",
    "scheduler",
    "journal",
    "fleet",
    "object",
)

# Surfaces whose clauses may carry stall=SECS (wedge, don't raise).
_STALL_SURFACES = ("transport", "scheduler", "fleet", "object")

# Actions only the object-store client knows how to apply (consumed
# via `take_action`, never raised by `maybe_fail`).
_OBJECT_ACTIONS = ("truncate", "flip", "throttle")


class FaultError(RuntimeError):
    """Base class of injected faults (never raised by real failures)."""


class TransientFaultError(FaultError):
    """An injected fault the retry engine classifies as transient."""


class FatalFaultError(FaultError):
    """An injected fault the retry engine classifies as fatal."""


# Substrings marking a device-runtime error as transient. These are the
# gRPC-style status tokens the accelerator runtimes put in message text
# for link/resource conditions that a retry (or a failover) can outlive;
# compile/shape/user errors carry none of them.
_TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "CANCELLED",
    "connection reset",
    "socket closed",
    "transfer failed",
    "device or resource busy",
)


# OSError subclasses that describe a PERMANENT condition a retry cannot
# outlive — a deleted input, revoked credentials, a path that is a
# directory. Retrying these only delays the inevitable abort.
_PERMANENT_OS_ERRORS = (
    FileNotFoundError,
    PermissionError,
    IsADirectoryError,
    NotADirectoryError,
)


def classify_transient(exc: BaseException, device_error_types=()) -> bool:
    """Transient-vs-fatal error classification for the retry engine.

    Transient: injected TransientFaultError, OS-level IO errors
    (flaky storage, closed sockets — but NOT permanent conditions like
    FileNotFoundError/PermissionError), and device-runtime error types
    the executing backend declares (``backend.transient_error_types``)
    whose message carries a link/resource status marker. Everything
    else — ValueError/TypeError config bugs, injected FatalFaultError,
    KeyboardInterrupt — is fatal: retrying would only hide it.
    """
    if isinstance(exc, TransientFaultError):
        return True
    if isinstance(exc, FatalFaultError):
        return False
    if isinstance(exc, (OSError, TimeoutError)):
        # covers IOError, ConnectionError, InterruptedError, ...
        return not isinstance(exc, _PERMANENT_OS_ERRORS)
    if device_error_types and isinstance(exc, tuple(device_error_types)):
        msg = str(exc).lower()
        return any(m.lower() in msg for m in _TRANSIENT_MARKERS)
    return False


def classify_device_transient(exc: BaseException, device_error_types=()) -> bool:
    """`classify_transient` for the device surface, the batch program.

    The batch program does no I/O, so an OSError raised from it (a
    kernel's source or library that cannot be read, say) is a fault of
    the program, never an I/O hiccup: it is fatal here. What stays
    transient is an injected TransientFaultError and a declared device
    error carrying a status marker (the port's backend declares none).
    """
    if isinstance(exc, OSError):  # TimeoutError included
        return False
    return classify_transient(exc, device_error_types)


@dataclasses.dataclass
class _Clause:
    surface: str
    step: int | None = None  # operation index (None = every operation)
    times: float = 1.0  # failing attempts before the clause is spent
    action: str = "transient"  # transient | fatal
    p: float | None = None  # per-attempt probability (seeded)
    corrupt_part: int | None = None  # checkpoint surface only
    stall: float | None = None  # transport/scheduler: wedge seconds
    fired: int = 0


def _parse_clause(text: str) -> _Clause:
    tokens = [t.strip() for t in text.split(":") if t.strip()]
    if not tokens:
        raise ValueError(f"empty fault clause in {text!r}")
    surface = tokens[0]
    if surface not in SURFACES:
        raise ValueError(
            f"unknown fault surface {surface!r}; must be one of {SURFACES}"
        )
    c = _Clause(surface=surface)
    for tok in tokens[1:]:
        if "=" in tok:
            key, _, val = tok.partition("=")
            key, val = key.strip(), val.strip()
            if key == "step":
                c.step = int(val)
            elif key == "times":
                c.times = math.inf if val in ("inf", "always") else int(val)
                if c.times < 1:
                    raise ValueError(f"times must be >= 1, got {val!r}")
            elif key == "p":
                c.p = float(val)
                if not 0.0 < c.p <= 1.0:
                    raise ValueError(f"p must be in (0, 1], got {val!r}")
            elif key == "corrupt_part":
                c.corrupt_part = int(val)
            elif key == "stall":
                c.stall = float(val)
                if c.stall <= 0.0:
                    raise ValueError(
                        f"stall must be positive seconds, got {val!r}"
                    )
            else:
                raise ValueError(
                    f"unknown fault-clause key {key!r} in {text!r} "
                    "(known: step, times, p, corrupt_part, stall)"
                )
        elif tok in ("transient", "drop"):
            # "drop" reads as a dropped connection on the object
            # surface; both classify transient and retry identically
            c.action = "transient"
        elif tok in ("fatal", "raise"):
            c.action = "fatal"
        elif tok in _OBJECT_ACTIONS:
            c.action = tok
        elif tok == "always":
            c.times = math.inf
        else:
            raise ValueError(
                f"unknown fault-clause token {tok!r} in {text!r} "
                "(actions: transient/drop, fatal/raise, always, "
                "truncate, flip, throttle)"
            )
    if c.corrupt_part is not None and c.surface != "checkpoint":
        raise ValueError(
            f"corrupt_part= applies to the checkpoint surface only ({text!r})"
        )
    if c.surface == "checkpoint" and c.corrupt_part is None:
        raise ValueError(
            f"checkpoint clauses need corrupt_part=N ({text!r})"
        )
    if c.stall is not None and c.surface not in _STALL_SURFACES:
        raise ValueError(
            f"stall= applies to the {'/'.join(_STALL_SURFACES)} surfaces "
            f"only ({text!r})"
        )
    if c.action in _OBJECT_ACTIONS and c.surface != "object":
        raise ValueError(
            f"{c.action} applies to the object surface only ({text!r})"
        )
    return c


class FaultPlan:
    """A parsed, stateful fault-injection plan (one instance per run).

    Owns per-surface operation counters (`op_index`) so an operation's
    identity is stable across its retry attempts: the caller fetches
    one op index per logical operation and calls `maybe_fail` once per
    *attempt* — a clause with ``times=2`` therefore fails exactly the
    first two attempts of its step.
    """

    def __init__(self, clauses: list[_Clause], seed: int = 0):
        self.clauses = clauses
        self.injected = 0  # total faults raised/applied by this plan
        self._ops = {s: 0 for s in SURFACES}
        self._corrupted: set[int] = set()
        # One plan is shared between the main thread (device surface)
        # and the prefetch thread (io_read surface); the lock keeps the
        # fired/injected counters race-free, and each probabilistic
        # clause draws from its OWN seeded stream so which attempts
        # fail is independent of cross-thread interleaving.
        self._lock = threading.Lock()
        for i, c in enumerate(self.clauses):
            if c.p is not None:
                c._rng = np.random.default_rng([int(seed), i])

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultPlan":
        clauses = [
            _parse_clause(part)
            for part in str(spec).split(",")
            if part.strip()
        ]
        if not clauses:
            raise ValueError(f"fault plan spec has no clauses: {spec!r}")
        return cls(clauses, seed=seed)

    def op_index(self, surface: str) -> int:
        """Allocate the next operation index for a surface (NOT
        incremented by retries — call once per logical operation)."""
        with self._lock:
            i = self._ops[surface]
            self._ops[surface] = i + 1
            return i

    def _take_clause(self, surface: str, step: int | None, stall: bool):
        """Consume and return the first live clause matching this
        attempt (stall=True selects stall clauses, False raising ones);
        None when nothing matches. Lock held by the caller."""
        for c in self.clauses:
            if c.surface != surface or (c.stall is not None) != stall:
                continue
            if c.step is not None and step is not None and c.step != step:
                continue
            if c.fired >= c.times:
                continue
            if c.p is not None and c._rng.random() >= c.p:
                continue
            c.fired += 1
            self.injected += 1
            return c
        return None

    def maybe_fail(self, surface: str, step: int | None) -> None:
        """Raise the configured fault if a clause matches this attempt
        (stall clauses never raise — consume them via `take_stall`)."""
        with self._lock:
            c = self._take_clause(surface, step, stall=False)
            if c is None:
                return
            msg = (
                f"injected {c.action} fault: {surface}"
                f"[step={step}] attempt {c.fired}"
            )
            if c.action == "fatal":
                raise FatalFaultError(msg)
            raise TransientFaultError(msg)

    def take_stall(self, surface: str, step: int | None = None) -> float:
        """Seconds the matched operation should stall (0.0 = no stall
        clause fired); the CALLER sleeps, so injection never blocks
        unrelated surfaces behind the plan lock."""
        with self._lock:
            c = self._take_clause(surface, step, stall=True)
            return float(c.stall) if c is not None else 0.0

    def take_action(self, surface: str, step: int | None = None) -> str | None:
        """Consume a matching non-stall clause and return its ACTION
        string instead of raising (None = nothing fired) — how an
        object-store client consumes its clauses."""
        with self._lock:
            c = self._take_clause(surface, step, stall=False)
            return c.action if c is not None else None

    # -- checkpoint surface ------------------------------------------------

    def take_checkpoint_corruption(self, part_index: int) -> bool:
        """One-shot: should checkpoint part `part_index` be corrupted on
        disk before loading? (Consumed so a rerun within the same plan
        instance doesn't re-corrupt the recomputed part.)"""
        with self._lock:
            for c in self.clauses:
                if (
                    c.surface == "checkpoint"
                    and c.corrupt_part == part_index
                    and part_index not in self._corrupted
                ):
                    self._corrupted.add(part_index)
                    c.fired += 1
                    self.injected += 1
                    return True
            return False

    @staticmethod
    def corrupt_file(path: str) -> None:
        """Deterministically corrupt a file in place (truncate to half
        size) — the stand-in for a torn write / bad sector."""
        try:
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(size // 2, 1))
        except OSError:
            pass  # absent file: nothing to corrupt


def resolve_fault_plan(spec: str | None, seed: int = 0) -> FaultPlan | None:
    """Build the run's FaultPlan from an explicit spec or the
    ``KCMC_FAULT_PLAN`` environment variable (explicit wins)."""
    spec = spec or os.environ.get("KCMC_FAULT_PLAN") or None
    return FaultPlan.from_spec(spec, seed=seed) if spec else None


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff + seeded jitter.

    `attempts` is the TOTAL attempt budget per operation (1 = no
    retry). `delay(k)` is the sleep before retry k (0-based):
    ``backoff_s * 2**k`` clipped to `backoff_max_s`, multiplied by a
    uniform jitter in ``[1 - jitter, 1 + jitter]`` so a fleet of
    workers retrying a shared dependency doesn't thundering-herd it.
    (The reference's per-attempt `deadline_s` serves only its object
    store, ROADMAP queue 1 item 15c.)
    """

    attempts: int = 3
    backoff_s: float = 0.05
    backoff_max_s: float = 2.0
    jitter: float = 0.25
    seed: int = 0
    sleep: object = time.sleep  # injectable for tests

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def delay(self, retry_index: int) -> float:
        base = min(self.backoff_s * (2.0 ** retry_index), self.backoff_max_s)
        if self.jitter <= 0.0:
            return base
        lo, hi = 1.0 - self.jitter, 1.0 + self.jitter
        return base * float(self._rng.uniform(lo, hi))


def default_io_retry_policy(cfg=None, seed_offset: int = 1):
    """THE ingest-surface retry policy — the single construction point
    shared by `corrector._begin_robust_run` (which hands it to
    `io/reader.py` and the feeder) and standalone readers. One
    construction site means backoff/jitter semantics cannot
    drift between ingest surfaces.

    `cfg` is any object with the CorrectorConfig retry fields
    (duck-typed — no config import, so standalone io users can pass
    None for the defaults). Returns None when retries are disabled
    (``retry_attempts <= 1``), mirroring the corrector's contract.
    `seed_offset` keeps the io jitter stream distinct from the device
    policy's (separate instances per thread: numpy Generators are not
    thread-safe)."""
    if cfg is None:
        return RetryPolicy(seed=seed_offset)
    if int(cfg.retry_attempts) <= 1:
        return None
    return RetryPolicy(
        attempts=cfg.retry_attempts,
        backoff_s=cfg.retry_backoff_s,
        backoff_max_s=cfg.retry_backoff_max_s,
        jitter=cfg.retry_jitter,
        seed=int(cfg.seed) + seed_offset,
    )
