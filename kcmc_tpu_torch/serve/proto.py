"""Wire protocol of the serve plane (`python -m kcmc_tpu_torch serve`):
line-delimited JSON over TCP, the reference's (kcmc_tpu/serve/proto.py)
byte for byte, so either package's client talks to the other's server.

One JSON object per line in each direction (stdlib-only, debuggable
with `nc`). Requests carry ``{"op": ..., ...}``; responses carry
``{"ok": true, ...}`` or ``{"ok": false, "error": str, "code": int}``.
Arrays travel as ``{"__nd__": <base64 raw little-endian bytes>,
"dtype": str, "shape": [...]}`` — base64 of the raw buffer, not JSON
numbers, so a frame batch costs ~1.33x its byte size instead of ~5x.

Ops (docs/SERVING.md has the full field tables):

* ``open_session`` — tenant/weight/reference/template_update/emit/
  output(+expected_frames)/output_dtype [+ session (a client-chosen
  id — the idempotency key for reconnect-retried opens)]
  [+ qos_class ("latency" | "batch", default "batch" — the session's
  scheduling class; docs/SERVING.md "Latency QoS")]
  [+ deadline_ms (session-default per-frame deadline, milliseconds
  from submit)] -> ``{"session": id}``
* ``submit_frames`` — session + frames [+ first (the session-global
  index of this call's first frame — the idempotency key: a retried
  submit's overlap with already-admitted frames is deduplicated, and
  a `first` past the cursor is a gap error)] [+ deadline_ms
  (per-frame deadline for THIS call's frames, milliseconds from now;
  overrides the session default)] [+ replay (marks a migration
  re-delivery, which predictive admission never re-judges)]
  -> admission decision
  ``{"accepted", "queued", "degraded", "deduped", "next"}`` (or a
  429-coded error when rejected — with ``predicted_wait_s`` when the
  predictive-admission horizon model rejected a deadline it already
  predicts will be missed)
* ``results`` — session [+ timeout] -> next undelivered span of
  per-frame outputs (blocks until available)
* ``close_session`` — session [+ timeout] -> final merged outputs
* ``resume_session`` — session -> ``{"session", "cursor", "resumed"}``:
  re-attach to a live session (resumed=false) or rehydrate a journaled
  one on a restarted server (resumed=true); the client re-submits
  frames from ``cursor`` (docs/ROBUSTNESS.md "Serve-plane failures")
* ``stats`` — scheduler gauges (sessions, queues, occupancy, admission,
  supervisor/resilience counters)
* ``metrics`` — the request-latency telemetry plane
  (docs/OBSERVABILITY.md "Request latency"): per-(segment, QoS rung)
  latency summaries, full mergeable histogram state, and the serve
  counters/gauges — the machine-readable health surface scrapers poll
  (`python -m kcmc_tpu_torch metrics HOST:PORT --text` renders it as
  Prometheus text exposition)
* ``ping`` / ``shutdown``
* ``trace`` — recent finished spans from the server's bounded
  in-memory span ring — the live source for `python -m kcmc_tpu_torch
  trace HOST:PORT` (docs/OBSERVABILITY.md "Distributed tracing")

Distributed-trace context (docs/OBSERVABILITY.md "Distributed
tracing"): any request may carry a ``trace`` field —
``{"trace_id": <32-hex>, "span_id": <16-hex>}`` — where `span_id` is
the SENDER's span, i.e. the parent of every span the receiver records
for this request. Responses echo ``{"trace_id"}`` back. The field is
optional and opaque to the transport, and untraced clients simply
omit it.
"""

from __future__ import annotations

import base64
import json

import numpy as np

ARRAY_KEY = "__nd__"


def encode_array(arr) -> dict:
    arr = np.ascontiguousarray(arr)
    return {
        ARRAY_KEY: base64.b64encode(arr.tobytes()).decode("ascii"),
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
    }


def decode_array(obj: dict) -> np.ndarray:
    raw = base64.b64decode(obj[ARRAY_KEY])
    return np.frombuffer(raw, dtype=np.dtype(obj["dtype"])).reshape(
        obj["shape"]
    ).copy()


def is_array(obj) -> bool:
    return isinstance(obj, dict) and ARRAY_KEY in obj


def encode_arrays(d: dict) -> dict:
    """Encode every ndarray value of a flat dict (non-arrays pass
    through; numpy scalars become Python numbers)."""
    out = {}
    for k, v in d.items():
        if isinstance(v, np.ndarray):
            out[k] = encode_array(v)
        elif isinstance(v, np.generic):
            out[k] = v.item()
        else:
            out[k] = v
    return out


def decode_arrays(d: dict) -> dict:
    return {k: decode_array(v) if is_array(v) else v for k, v in d.items()}


def send_msg(wfile, obj: dict) -> None:
    wfile.write((json.dumps(obj) + "\n").encode("utf-8"))
    wfile.flush()


# Hard cap on one message line. A newline-free byte stream must not
# buffer unboundedly in a handler thread (one rogue connection taking
# down every tenant of a server whose headline feature is admission
# control); 512 MiB comfortably fits the largest legitimate submit
# (a full default-queue-depth batch of large frames, base64-encoded).
MAX_LINE = 512 * 1024 * 1024


def recv_msg(rfile, max_line: int | None = MAX_LINE) -> dict | None:
    """Read one message; None on a cleanly closed connection. Raises
    ValueError on an over-long or newline-less (truncated) line.
    `max_line=None` lifts the cap (the CLIENT reads responses it asked
    for — a merged emit=True close_session can legitimately be huge;
    the server NEVER lifts it for untrusted request bytes)."""
    if max_line is None:
        line = rfile.readline()
        if not line:
            return None
    else:
        line = rfile.readline(max_line + 1)
        if not line:
            return None
        if len(line) > max_line or not line.endswith(b"\n"):
            raise ValueError(
                f"message line exceeds {max_line} bytes or was "
                "truncated mid-line"
            )
    return json.loads(line.decode("utf-8"))
