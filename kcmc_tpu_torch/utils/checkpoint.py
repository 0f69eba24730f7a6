"""Stream checkpoints of `MotionCorrector.correct_file` (the port's copy
of kcmc_tpu/utils/checkpoint.py, without its in-memory
`ResumableCorrector`: `correct_file(checkpoint=)` is the port's one
resume path).

A 10k-frame recording takes minutes even on the card; the checkpoint
holds the per-batch results (transforms/fields + diagnostics), the
frame cursor and the output writer's state, in append-only parts with
sha256 checks, so an interrupted run continues from the last saved
cursor instead of frame 0 and writes the same bytes.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np

from kcmc_tpu_torch.obs.log import advise


def file_digest(path: str) -> str:
    """sha256 of a file's bytes — the per-part content checksum guarding
    resume against torn writes and bit rot."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def quarantine_file(path: str) -> str | None:
    """Rename a corrupt checkpoint/journal file to `<path>.corrupt` so
    the evidence survives for post-mortem while the resume path stops
    tripping over it. Returns the quarantine path (None if the rename
    itself failed — e.g. the file vanished)."""
    q = f"{path}.corrupt"
    try:
        os.replace(path, q)
    except OSError:
        return None
    return q


def atomic_savez(path: str, **payload) -> None:
    """Write an .npz with all-or-nothing visibility: a mid-write kill
    (SIGKILL, power loss) leaves either the previous file or the new
    one, never a torn hybrid."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _segment_arrays(segments: list[dict]) -> dict:
    return {
        f"c{i}_{k}": np.asarray(v)
        for i, seg in enumerate(segments)
        for k, v in seg.items()
    }


def _split_segments(arrays: dict) -> list[dict]:
    n = 0
    while any(k.startswith(f"c{n}_") for k in arrays):
        n += 1
    return [
        {k[len(f"c{i}_") :]: arrays[k] for k in arrays if k.startswith(f"c{i}_")}
        for i in range(n)
    ]


def save_stream_checkpoint(
    path: str, meta: dict, new_segments: list[dict], part_index: int,
    arrays: dict | None = None,
) -> dict:
    """Persist one streaming-resume checkpoint increment.

    The segments NEW since the last save go into an append-only part
    file (`<path>.partNNNNN.npz`); then the small meta record (run
    signature, done-cursor, output-TIFF writer state, part count) is
    atomically replaced at `path`. Each save is O(new work), not O(run
    so far) — a million-frame run writes each diagnostic array once.
    A crash between the two writes leaves the old meta pointing at the
    old part count; the orphan part is simply overwritten next time.
    Used by MotionCorrector.correct_file.

    Each written part is recorded in ``meta["parts"]`` — a history of
    ``{"done", "writer", "checksum"}`` snapshots, one per part, taken
    at that part's save. The checksum guards the part's content on
    load; the done/writer snapshots are the rewind points that let a
    resume quarantine a corrupt part and restart from the last good
    prefix instead of from zero (see `load_stream_checkpoint`).

    `arrays`: extra ndarrays stored alongside the meta record (e.g. the
    evolving rolling template); returned under meta["arrays"] on load.

    Returns the meta dict as written (with the updated part history).
    """
    meta = dict(meta)
    if new_segments:
        pp = _part_path(path, part_index)
        atomic_savez(pp, **_segment_arrays(new_segments))
        meta["n_parts"] = part_index + 1
        # part_index re-saves overwrite orphans; truncate history to match
        history = list(meta.get("parts", []))[:part_index]
        history.append({
            "done": meta.get("done"),
            "writer": meta.get("writer"),
            "checksum": file_digest(pp),
        })
        meta["parts"] = history
    atomic_savez(path, meta=json.dumps(meta), **(arrays or {}))
    return meta


def _part_path(path: str, i: int) -> str:
    return f"{path}.part{i:05d}.npz"


def load_stream_checkpoint(path: str, fault_plan=None, report=None):
    """Load a streaming-resume checkpoint; returns (meta, segments) or
    None when absent or unusable.

    "No checkpoint" (the path doesn't exist — a fresh run) returns None
    silently. "Corrupt checkpoint" is different and is never silent:

    * an unreadable META record warns with the path and reason, is
      quarantined to ``<path>.corrupt``, and the run restarts;
    * a corrupt/truncated/missing PART file (detected by its recorded
      sha256 content checksum, or by the load itself failing) warns, is
      quarantined to ``<part>.corrupt``, and — when the meta's part
      history has a rewind point — the load returns the last good
      PREFIX: meta rewound to the done-cursor/writer-state snapshotted
      at the preceding part's save, so the rerun recomputes only the
      lost chunk instead of restarting from zero.

    Rewind is skipped (full restart, with a warning) when the bad part
    is the first one, the checkpoint predates part histories, or a
    rolling template is in play (the stored template matches only the
    final cursor — resuming an earlier cursor with a later template
    would diverge from an uninterrupted run).

    `fault_plan` (utils/faults.FaultPlan) lets chaos runs corrupt a
    part on disk just before it is read (``checkpoint:corrupt_part=N``);
    `report` (utils/metrics.RobustnessReport) collects quarantine paths.
    """
    if not os.path.exists(path):
        return None  # no checkpoint: a fresh run, nothing to report
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            extra = {k: z[k] for k in z.files if k != "meta"}
    except Exception as e:
        q = quarantine_file(path)
        advise(
            f"kcmc: resume checkpoint {path} is corrupt "
            f"({type(e).__name__}: {e}); quarantined it"
            f"{f' to {q}' if q else ''} and restarting from scratch",
            stacklevel=2,
        )
        if report is not None and q:
            report.quarantined_parts.append(q)
        return None
    if extra:
        meta["arrays"] = extra
    history = meta.get("parts", [])
    segments: list[dict] = []
    for p in range(int(meta.get("n_parts", 0))):
        pp = _part_path(path, p)
        if fault_plan is not None and fault_plan.take_checkpoint_corruption(p):
            fault_plan.corrupt_file(pp)
        try:
            if p < len(history) and history[p].get("checksum"):
                digest = file_digest(pp)
                want = history[p]["checksum"]
                if digest != want:
                    raise ValueError(
                        f"content checksum mismatch (recorded "
                        f"{want[:12]}…, found {digest[:12]}…)"
                    )
            with np.load(pp, allow_pickle=False) as z:
                part = _split_segments({k: z[k] for k in z.files})
        except Exception as e:
            q = quarantine_file(pp)
            if report is not None and q:
                report.quarantined_parts.append(q)
            rewind = (
                p > 0
                and p - 1 < len(history)
                and history[p - 1].get("writer") is not None
            )
            if rewind and "template" in meta.get("arrays", {}):
                advise(
                    f"kcmc: checkpoint part {pp} is corrupt "
                    f"({type(e).__name__}: {e}); quarantined it, but a "
                    "rolling-template run cannot rewind past it (the "
                    "stored template matches only the final cursor) — "
                    "restarting from scratch",
                    stacklevel=2,
                )
                return None
            if not rewind:
                advise(
                    f"kcmc: checkpoint part {pp} is corrupt "
                    f"({type(e).__name__}: {e}); quarantined it and "
                    "restarting from scratch (no good prefix to resume "
                    "from)",
                    stacklevel=2,
                )
                return None
            prev = history[p - 1]
            advise(
                f"kcmc: checkpoint part {pp} is corrupt "
                f"({type(e).__name__}: {e}); quarantined it and "
                f"resuming from the last good chunk (frame "
                f"{int(prev['done'])})",
                stacklevel=2,
            )
            meta = dict(
                meta,
                done=int(prev["done"]),
                writer=prev["writer"],
                n_parts=p,
                parts=history[:p],
            )
            return meta, segments
        segments.extend(part)
    return meta, segments
