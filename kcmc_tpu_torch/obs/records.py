"""Per-frame quality records: a JSONL sidecar stream of registration
diagnostics (the port's copy of kcmc_tpu/obs/records.py; same file
layout, so either package's report reads either package's records).

NoRMCorre-style motion-correction practice audits corrections through
per-frame diagnostics — keypoint counts, inlier ratios, residuals —
not just a run-level mean. The pipeline already computes all of them
per batch; `FrameRecordStream` serializes one JSON object per frame to
a sidecar file (`--frame-records PATH`) through the same bounded
background-writer machinery as TIFF writeback (`io/async_writer.py`'s
`AsyncBatchWriter` wrapping a line sink), so record IO overlaps device
compute and a full queue applies backpressure instead of unbounded
memory.

File layout (one JSON object per line):

* line 1 — header: ``{"kind": "kcmc_frame_records", "version": 1,
  "manifest": {...}}`` (the run manifest, obs/manifest.py);
* one record per frame, in frame order:
  ``frame``, ``model``, ``n_keypoints``, ``n_matches``, ``n_inliers``,
  ``inlier_ratio``, ``rms_residual_px``, ``warp_ok``, plus
  ``template_corr``/``coverage`` when quality metrics ran and the
  ``warp_rescued``/``failed``/``failover``/``escalated`` robustness
  flags;
* optional final summary line — ``{"kind": "kcmc_run_summary",
  "timing": {...}, "robustness": {...}}`` (absent if the run died
  before close; `python -m kcmc_tpu_torch.obs.report` degrades
  gracefully).

A checkpoint-resumed run (the obs knobs are resume-signature neutral)
APPENDS to an existing records file instead of truncating the killed
run's post-mortem: a ``{"kind": "kcmc_run_resume", ...}`` marker line
separates the segments. Records at or past the resume cursor are
pruned first — drains outrun checkpoint saves, so the killed run's
tail covers frames the resumed run re-registers — keeping the
one-record-per-frame invariant. Readers skip marker lines.

Non-finite floats are written as JSON ``null`` (bare ``NaN`` tokens are
non-standard JSON and break strict parsers).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

RECORD_KIND = "kcmc_frame_records"
SUMMARY_KIND = "kcmc_run_summary"
RESUME_KIND = "kcmc_run_resume"

# Keys every record carries (the golden-schema contract).
REQUIRED_RECORD_KEYS = (
    "frame",
    "model",
    "n_keypoints",
    "n_matches",
    "n_inliers",
    "inlier_ratio",
    "rms_residual_px",
    "warp_ok",
    "failed",
    "failover",
    "escalated",
)


def _num(v, ndigits: int = 4):
    """float -> JSON-safe rounded value (non-finite -> None)."""
    f = float(v)
    if not math.isfinite(f):
        return None
    return round(f, ndigits)


def records_from_batch(
    first_frame: int,
    host: dict,
    model: str,
    n: int | None = None,
    failed: frozenset | set = frozenset(),
    failover: frozenset | set = frozenset(),
    escalated: bool = False,
) -> list[dict]:
    """Build per-frame record dicts from one drained batch's host
    output dict (keys as produced by the backend: n_keypoints,
    n_matches, n_inliers, rms_residual, optional template_corr /
    coverage / warp_ok / warp_rescued; numpy arrays or tensors)."""

    def col(key):
        # A device-resident run (`device_outputs`) drains tensors on the
        # card: only these small per-frame columns come to the host,
        # never the frames.
        v = host.get(key)
        if v is None:
            return None
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        return np.asarray(v)

    n_kp = col("n_keypoints")
    n_match = col("n_matches")
    n_in = col("n_inliers")
    resid = col("rms_residual")
    corr = col("template_corr")
    cover = col("coverage")
    ok = col("warp_ok")
    rescued = col("warp_rescued")
    if n is None:
        for c in (n_in, n_match, n_kp, resid, ok):
            if c is not None:
                n = len(c)
                break
        else:
            return []
    recs = []
    for i in range(n):
        frame = int(first_frame + i)
        nm = int(n_match[i]) if n_match is not None else 0
        ni = int(n_in[i]) if n_in is not None else 0
        rec = {
            "frame": frame,
            "model": model,
            "n_keypoints": int(n_kp[i]) if n_kp is not None else 0,
            "n_matches": nm,
            "n_inliers": ni,
            "inlier_ratio": _num(ni / max(nm, 1)),
            "rms_residual_px": _num(resid[i]) if resid is not None else None,
            "warp_ok": bool(ok[i]) if ok is not None else True,
            "failed": frame in failed,
            "failover": frame in failover,
            "escalated": bool(escalated),
        }
        if rescued is not None:
            rec["warp_rescued"] = bool(rescued[i])
        if corr is not None:
            rec["template_corr"] = _num(corr[i])
        if cover is not None:
            rec["coverage"] = _num(cover[i])
        recs.append(rec)
    return recs


def _prune_for_resume(path: str, resume_done: int) -> bool:
    """Rewrite an existing records file for a resume at frame
    `resume_done`: keep the header, structural (`kind`) lines, and
    records for frames BELOW the cursor; drop records the resumed run
    will re-emit (drains outrun checkpoint saves, so the killed run's
    tail overlaps the replay) and any torn partial line. Returns False
    when the file is not a recognizable records file (caller starts
    fresh)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.readlines()
        first = json.loads(lines[0])
        if not (
            isinstance(first, dict) and first.get("kind") == RECORD_KIND
        ):
            return False
    except (json.JSONDecodeError, UnicodeDecodeError, OSError, IndexError):
        return False
    kept = [lines[0]]
    for line in lines[1:]:
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn tail from the kill
        if "kind" in obj or int(obj.get("frame", -1)) < resume_done:
            kept.append(line if line.endswith("\n") else line + "\n")
    tmp = path + ".resume-tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.writelines(kept)
    os.replace(tmp, path)
    return True


class _JsonlSink:
    """The inner writer AsyncBatchWriter drives: serializes record
    dicts to JSONL on the WORKER thread (json.dumps stays off the
    consumer/dispatch thread) and appends them to the file.

    With `resume_done` set and an existing file whose first line is a
    valid records header, the sink prunes records >= the resume cursor
    (see _prune_for_resume) and appends — the killed run's records ARE
    the post-mortem artifact — starting with a resume-marker line.
    """

    def __init__(
        self, path: str, header: dict, resume_done: int | None = None
    ):
        self.n_pages = 0  # records written (AsyncBatchWriter protocol)
        mode = "w"
        if (
            resume_done is not None
            and os.path.exists(path)
            and os.path.getsize(path) > 0
            and _prune_for_resume(path, resume_done)
        ):
            mode = "a"
        self._f = open(path, mode, encoding="utf-8")
        if mode == "a":
            self._write_obj(dict(header, kind=RESUME_KIND))
        else:
            self._write_obj(header)

    def _write_obj(self, obj: dict) -> None:
        self._f.write(json.dumps(obj, allow_nan=False))
        self._f.write("\n")

    def append_batch(self, records, n_threads: int = 0) -> None:
        for rec in records:
            self._write_obj(rec)
        self.n_pages += len(records)

    def checkpoint_state(self) -> dict:
        self._f.flush()
        return {"n_records": self.n_pages}

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class FrameRecordStream:
    """Bounded background JSONL writer for per-frame quality records.

    `append(records)` enqueues a drained batch's records and returns
    immediately; one worker thread serializes and writes them in order
    (the `AsyncBatchWriter` pattern — bounded queue, backpressure on
    full, worker errors surface on the consumer thread at the next
    call). `close(summary=)` flushes, appends the run-summary line,
    and closes the file.
    """

    def __init__(
        self,
        path: str,
        manifest: dict | None = None,
        depth: int = 4,
        tracer=None,
    ):
        self.path = str(path)
        self._manifest = manifest
        self._depth = depth
        self._tracer = tracer
        # Lazy open: the file is created at the first append (or at
        # close, so even a run that died pre-drain leaves an artifact).
        # The delay is what lets a checkpoint resume — detected AFTER
        # telemetry is armed but before any batch drains — switch the
        # sink to prune+append mode instead of truncating the killed
        # run's records (mark_resume).
        self._sink = None
        self._writer = None
        self._resume_done: int | None = None
        self._closed = False

    def mark_resume(self, done: int) -> None:
        """Called when the run resumed a checkpoint at frame `done`:
        prune records the replay re-emits and append to the existing
        file rather than truncating it. No-op once the file is open."""
        if self._sink is None:
            self._resume_done = int(done)

    def _ensure_open(self) -> None:
        if self._sink is not None:
            return
        from kcmc_tpu_torch.io.async_writer import AsyncBatchWriter

        header = {"kind": RECORD_KIND, "version": 1}
        if self._manifest is not None:
            header["manifest"] = self._manifest
        self._sink = _JsonlSink(
            self.path, header, resume_done=self._resume_done
        )
        self._writer = AsyncBatchWriter(
            self._sink, depth=self._depth, tracer=self._tracer
        )

    def append(self, records: list[dict]) -> None:
        if records:
            self._ensure_open()
            self._writer.append_batch(records)

    @property
    def n_records(self) -> int:
        """Records DURABLE in the file (lags appends by the queue)."""
        return self._sink.n_pages if self._sink is not None else 0

    def close(self, summary: dict | None = None) -> None:
        """Flush the queue, append the summary line (if any), close.
        Idempotent; a second close's summary is dropped."""
        if self._closed:
            return
        self._closed = True
        self._ensure_open()
        try:
            self._writer.flush()
            if summary is not None:
                self._sink.append_batch(
                    [dict(summary, kind=SUMMARY_KIND)]
                )
        finally:
            self._writer.close()


def read_jsonl(path: str) -> tuple[dict | None, list[dict], dict | None]:
    """Parse a frame-records file -> (header, records, summary).
    Tolerates a torn final line (killed runs)."""
    header, records, summary = None, [], None
    with open(path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                if i == 0:
                    raise
                continue  # torn tail line from a killed run
            kind = obj.get("kind")
            if i == 0 and kind == RECORD_KIND:
                header = obj
            elif kind == SUMMARY_KIND:
                summary = obj
            elif kind is not None:
                continue  # resume markers / future structural lines
            else:
                records.append(obj)
    return header, records, summary
