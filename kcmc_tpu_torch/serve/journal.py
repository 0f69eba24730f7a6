"""SessionJournal: durable per-session resume state for the serve
plane (the port's copy of kcmc_tpu/serve/journal.py; docs/ROBUSTNESS.md
"Serve-plane failures").

A `python -m kcmc_tpu_torch serve` process that dies — SIGKILL, a
sticky CUDA error, power loss — must not lose its in-flight streams. With
`serve_journal_dir` configured, every session periodically persists a
snapshot of exactly the state a restarted server (or a future peer
replica) needs to continue the stream from its last durable frame:

* the **cursor** (drained-frame high-water mark) and submit counters;
* the **rolling-template history** — the current template source
  frame, the next boundary, and the undrained blend tail — so resumed
  boundary updates land at the same absolute frame indices with the
  same averaging window as an uninterrupted run;
* the **transform high-water mark** and accumulated per-frame
  diagnostics (everything except corrected pixels — cheap to re-warp,
  10 GB to journal), so a resumed session's final `close_session`
  returns the full stream's outputs;
* the **config signature** (SIG_NEUTRAL fields normalized out, the
  same classification the one-shot checkpoint resume uses), so a
  journal never resumes into an incompatible serving config; and the
  backend's name, so a journal the JAX package wrote (`jax`, `numpy`)
  is refused by this package's `torch` server and vice versa.

The storage layer IS the port's streaming-checkpoint machinery
(`utils/checkpoint.py` `save_stream_checkpoint` /
`load_stream_checkpoint`): drained batches newly accumulated since the
last snapshot go into an append-only, sha256-checksummed part file, so
each save is O(new work) — a million-frame stream writes each
diagnostic row once, never O(run so far) — while the small meta record
(cursor, boundary, template source, blend tail) atomically replaces
(a mid-write SIGKILL leaves the previous snapshot, never a torn
hybrid). Corruption quarantines to `<file>.corrupt` with a warning;
a corrupt part of a non-rolling session rewinds the journal to the
last good prefix, and rolling-template journals refuse the rewind
(the stored template matches only the final cursor) exactly like the
one-shot checkpoints.

The journal write path is a fault surface (``journal`` in the
`utils/faults.py` grammar): an injected write failure degrades
durability — counted, advised — but never the stream.
"""

from __future__ import annotations

import glob
import hashlib
import os

from kcmc_tpu_torch.obs.log import advise
from kcmc_tpu_torch.utils.checkpoint import (
    load_stream_checkpoint,
    save_stream_checkpoint,
)

# Journal format version: bump when the snapshot schema changes so an
# old server never misreads a new journal (and vice versa).
JOURNAL_VERSION = 2


def _safe_sid(session_id: str) -> str:
    """Filesystem-safe journal stem for a client-chosen session id:
    benign characters pass through, everything else is replaced, and a
    short content hash keeps sanitized ids collision-free."""
    sid = str(session_id)
    clean = "".join(c if c.isalnum() or c in "._-" else "_" for c in sid)
    if clean == sid:
        return sid
    h = hashlib.sha1(sid.encode("utf-8")).hexdigest()[:8]
    return f"{clean}-{h}"


def journal_path(directory: str, session_id: str) -> str:
    return os.path.join(directory, f"{_safe_sid(session_id)}.journal.npz")


def serve_config_signature(config) -> str:
    """The journal's config-compat signature: the serving config with
    every field of the port's SIG_NEUTRAL_FIELDS pinned to its default —
    identical normalization to the one-shot checkpoint resume signature,
    so bumping a retry knob (or re-arming KCMC_FAULT_PLAN for a chaos
    rerun) between boot and resume never strands a journal."""
    from kcmc_tpu_torch.corrector import _ROBUSTNESS_SIG_NEUTRAL

    return repr(config.replace(**_ROBUSTNESS_SIG_NEUTRAL))


def load_session_journal(path: str, report=None):
    """Load one session journal; returns (meta, segments, arrays) or
    None when absent/unusable. `segments` are the per-batch output
    dicts (corrected pixels were never journaled); `arrays` the meta-
    side state (template source, blend tail). Corruption is never
    silent: the checkpoint loader warns, quarantines the bad file to
    ``<file>.corrupt`` (collected in `report.quarantined_parts`), and
    either rewinds a non-rolling journal to its last good part prefix
    or gives the stream up — the server (and the evidence) survive."""
    got = load_stream_checkpoint(path, report=report)
    if got is None:
        return None
    meta, segments = got
    if int(meta.get("version", -1)) != JOURNAL_VERSION:
        advise(
            f"kcmc serve: session journal {path} has format version "
            f"{meta.get('version')!r} (this build reads "
            f"{JOURNAL_VERSION}); the stream cannot resume",
            stacklevel=2,
        )
        return None
    arrays = meta.pop("arrays", {})
    return meta, segments, arrays


class SessionJournal:
    """One session's durable-snapshot writer (cadence + counters).

    Owned by a `Session` when the scheduler armed journaling; all calls
    happen on the scheduler thread (the drain path), so writes never
    contend with client submits. `fault_plan`/`report` are the
    session's own robustness state — injected journal faults and the
    save/failure counters are per-stream, like every other surface.
    """

    def __init__(
        self,
        directory: str,
        session_id: str,
        every: int = 64,
        fault_plan=None,
        report=None,
    ):
        os.makedirs(directory, exist_ok=True)
        self.path = journal_path(directory, session_id)
        self.every = max(int(every), 1)
        self.fault_plan = fault_plan
        self.report = report
        self.last_saved = -1  # cursor of the last durable snapshot
        self.parts = 0  # next part index (count of parts written)
        self._history: list = []  # per-part rewind snapshots (meta)
        self.saves = 0
        self.failures = 0

    def adopt(self, meta: dict) -> None:
        """Continue an existing journal after a resume: subsequent
        parts append after the loaded prefix instead of overwriting
        it."""
        self.last_saved = int(meta.get("done", 0))
        self.parts = int(meta.get("n_parts", 0))
        self._history = list(meta.get("parts", []))

    def due(self, done: int) -> bool:
        """Whether the cadence calls for a snapshot at cursor `done`."""
        return done > 0 and (
            self.last_saved < 0 or done - self.last_saved >= self.every
        )

    def save(self, meta: dict, new_segments: list, arrays: dict) -> bool:
        """Write one snapshot: `new_segments` (drained batch dicts NEW
        since the last save) append as a checksummed part file, then
        the meta record (+ `arrays`: template source, blend tail)
        atomically replaces — O(new work) per save. Returns True when
        it became durable. A failed write (full disk, injected
        ``journal`` fault) degrades durability — counted, advised once
        per failure — but must never fail the stream it protects."""
        meta = dict(meta)
        meta["version"] = JOURNAL_VERSION
        # The checkpoint loader's part-rewind anchor: any non-None
        # writer snapshot marks a part boundary a corrupt-part load may
        # rewind to (rolling-template journals refuse the rewind via
        # the "template" array gate, matching one-shot semantics).
        meta["writer"] = {"cursor": int(meta.get("done", 0))}
        meta["parts"] = list(self._history)
        meta["n_parts"] = self.parts
        try:
            if self.fault_plan is not None:
                self.fault_plan.maybe_fail(
                    "journal", self.fault_plan.op_index("journal")
                )
            written = save_stream_checkpoint(
                self.path, meta, new_segments, self.parts, arrays=arrays
            )
        except Exception as e:
            self.failures += 1
            if self.report is not None:
                self.report.journal_failures += 1
            advise(
                f"kcmc serve: journal write for session "
                f"{meta.get('sid')} failed ({type(e).__name__}: {e}); "
                f"the stream continues with its last durable frame at "
                f"{self.last_saved}",
                stacklevel=2,
            )
            return False
        self.parts = int(written.get("n_parts", self.parts))
        self._history = list(written.get("parts", []))
        self.last_saved = int(meta.get("done", 0))
        self.saves += 1
        if self.report is not None:
            self.report.journal_saves += 1
        return True

    def discard(self) -> None:
        """Remove the journal (meta + every part) after a clean
        client-initiated close — a completed stream must not be
        resurrectable into a duplicate."""
        for p in (self.path, *glob.glob(f"{glob.escape(self.path)}.part*")):
            try:
                os.remove(p)
            except OSError:
                pass
