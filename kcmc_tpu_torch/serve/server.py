"""ServeServer: the resident `python -m kcmc_tpu_torch serve` process
(the port's copy of kcmc_tpu/serve/server.py).

Wraps a `StreamScheduler` (one warm `TorchBackend` on the card, many
sessions) in a threading TCP server speaking the line-delimited JSON
protocol (serve/proto.py). Each client connection gets a handler thread
that translates ops into scheduler calls; all device work stays on the
scheduler thread (and its warm-up threads).

The `serve` subcommand of `__main__.py` calls `serve_main` here; the
first stdout line is a machine-readable ready record (`{"serving": ...,
"port": N, "backend": "torch", ...}`) so supervisors can wait for it,
then the process serves until SIGINT/SIGTERM or a client `shutdown` op,
and its last line is the `{"served": true, "stats": ...}` record.
Without a CUDA card the server raises unless the corrector runs on
`device="cpu"` (`--device cpu`), where every kernel runs its plain
PyTorch version.
"""

from __future__ import annotations

import json
import socketserver
import threading
import time

import numpy as np

from kcmc_tpu_torch.serve import proto
from kcmc_tpu_torch.serve.scheduler import (
    DeviceLostError,
    OverloadedError,
    StreamScheduler,
)
from kcmc_tpu_torch.utils.faults import FaultError


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        server: "ServeServer" = self.server.kcmc_server  # type: ignore[attr-defined]
        while True:
            try:
                msg = proto.recv_msg(self.rfile)
            except (ValueError, OSError) as e:
                try:
                    proto.send_msg(
                        self.wfile,
                        {"ok": False, "error": f"bad message: {e}", "code": 400},
                    )
                except OSError:
                    pass
                return
            if msg is None:
                return  # client closed the connection
            # `transport` chaos surface (the serve plane's shared fault
            # plan): a stall clause half-opens the connection — the
            # reply is delayed past the client's read deadline — and a
            # raising clause drops it mid-request. Both exercise the
            # client's reconnect + idempotent-replay contract.
            plan = server.scheduler.fault_plan
            if plan is not None:
                t_step = plan.op_index("transport")
                stall = plan.take_stall("transport", t_step)
                if stall > 0:
                    time.sleep(stall)
                try:
                    plan.maybe_fail("transport", t_step)
                except FaultError:
                    return  # drop the connection, no reply
            try:
                resp = server.handle_op(msg)
            except OverloadedError as e:
                resp = {
                    "ok": False, "error": str(e), "code": e.code,
                    "queued": e.queued, "limit": e.limit,
                }
                if e.predicted_wait_s is not None:
                    resp["predicted_wait_s"] = e.predicted_wait_s
            except DeviceLostError as e:
                # a lost CUDA context: the stream resumes elsewhere
                resp = {"ok": False, "error": str(e), "code": e.code}
            except (KeyError, ValueError, TypeError, TimeoutError) as e:
                resp = {"ok": False, "error": str(e), "code": 400}
            except Exception as e:  # a stream failure must not kill the server
                resp = {
                    "ok": False,
                    "error": f"{type(e).__name__}: {e}",
                    "code": 500,
                }
            try:
                proto.send_msg(self.wfile, resp)
            except OSError:
                return
            if msg.get("op") == "shutdown":
                server.request_shutdown()
                return


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class ServeServer:
    """Resident serving process: scheduler + TCP transport."""

    def __init__(
        self,
        corrector,
        host: str = "127.0.0.1",
        port: int = 7733,
        heartbeat_s: float = 0.0,
    ):
        self.scheduler = StreamScheduler(corrector, heartbeat_s=heartbeat_s)
        self._tcp = _TCPServer((host, port), _Handler)
        self._tcp.kcmc_server = self  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None
        self._shutdown = threading.Event()

    @property
    def host(self) -> str:
        return self._tcp.server_address[0]

    @property
    def port(self) -> int:
        """The BOUND port (pass port=0 for an ephemeral one — tests)."""
        return self._tcp.server_address[1]

    # -- op dispatch (handler threads) ------------------------------------

    def handle_op(self, msg: dict) -> dict:
        """Dispatch one op. When the message carries a `trace` field
        and the scheduler's span shard is armed, the whole handling
        becomes an `rpc.server` span (child of the sender's span) and
        the response echoes the trace id back."""
        from kcmc_tpu_torch.obs.tracing import child_context, valid_context

        op = msg.get("op")
        ctx = valid_context(msg.get("trace"))
        shard = self.scheduler.trace_shard
        if ctx is None or shard is None:
            return self._dispatch_op(op, msg, child_context(ctx))
        server_ctx = child_context(ctx)
        t_wall, t0 = time.time(), time.perf_counter()
        resp = self._dispatch_op(op, msg, server_ctx)
        shard.complete(
            "rpc.server",
            t_wall,
            time.perf_counter() - t0,
            trace_id=server_ctx["trace_id"],
            span_id=server_ctx["span_id"],
            parent_id=server_ctx.get("parent_id"),
            args={"op": str(op)},
        )
        if isinstance(resp, dict) and resp.get("ok"):
            resp.setdefault("trace", {"trace_id": ctx["trace_id"]})
        return resp

    def _dispatch_op(self, op, msg: dict, ctx: dict | None) -> dict:
        if op == "ping":
            return {"ok": True}
        if op == "trace":
            return {"ok": True, "spans": self.scheduler.trace_dump()}
        if op == "stats":
            return {"ok": True, "stats": self.scheduler.stats()}
        if op == "metrics":
            # machine-readable health/latency surface (line-JSON like
            # stats): per-segment latency summaries + mergeable
            # histograms + counters/gauges — what `python -m
            # kcmc_tpu_torch metrics HOST:PORT` scrapes
            return {"ok": True, "metrics": self.scheduler.metrics()}
        if op == "open_session":
            ref = msg.get("reference")
            sess = self.scheduler.open_session(
                tenant=msg.get("tenant", "default"),
                weight=int(msg.get("weight", 1)),
                reference=(
                    proto.decode_array(ref) if proto.is_array(ref) else None
                ),
                template_update_every=msg.get("template_update"),
                emit_frames=bool(msg.get("emit", False)),
                output=msg.get("output"),
                expected_frames=msg.get("expected_frames"),
                output_dtype=msg.get("output_dtype", "float32"),
                compression=msg.get("compression", "none"),
                # client-chosen id: the reconnect-retry idempotency key
                session_id=msg.get("session"),
                qos_class=msg.get("qos_class", "batch"),
                deadline_ms=msg.get("deadline_ms"),
            )
            return {"ok": True, "session": sess.sid}
        if op == "submit_frames":
            frames = proto.decode_array(msg["frames"])
            first = msg.get("first")
            deadline_ms = msg.get("deadline_ms")
            decision = self.scheduler.submit(
                msg["session"], frames,
                first=int(first) if first is not None else None,
                deadline_ms=(
                    float(deadline_ms) if deadline_ms is not None else None
                ),
                replay=bool(msg.get("replay", False)),
                trace=ctx,
            )
            return {"ok": True, **decision}
        if op == "resume_session":
            sess, cursor, resumed = self.scheduler.resume_session(
                msg["session"]
            )
            resp = {
                "ok": True,
                "session": sess.sid,
                "cursor": int(cursor),
                "resumed": bool(resumed),
            }
            # Resume-cost observability: the rehydrating server's
            # plan-cache hit/miss counts, narrowed to the session's live
            # frame shape when known, so a client can tell a warm
            # landing (stamp hits, zero new builds) from a cold one.
            stats_fn = getattr(
                self.scheduler.mc.backend, "plan_cache_stats", None
            )
            if resumed and stats_fn is not None:
                try:
                    ps = stats_fn()
                    shape = sess.frame_shape
                    key = (
                        "x".join(str(s) for s in shape) if shape else None
                    )
                    resp["plan_cache"] = {
                        "stamp_hits": int(ps.get("stamp_hits", 0)),
                        "stamp_misses": int(ps.get("stamp_misses", 0)),
                        "programs_compiled": int(
                            ps.get("programs_compiled", 0)
                        ),
                        "session_shape_compiles": {
                            k: int(v)
                            for k, v in (
                                ps.get("compile_counts") or {}
                            ).items()
                            if key is not None and f"|{key}|" in k
                        },
                    }
                except Exception:
                    pass  # observability must never fail a resume
            return resp
        if op == "results":
            try:
                # lookup_session also finds recently reaped sessions, so
                # a poll racing a concurrent close still delivers any
                # undelivered spans before reporting exhausted.
                sess = self.scheduler.lookup_session(msg["session"])
            except KeyError:
                # Reaped long enough ago that only the id is remembered:
                # everything was deliverable once — report exhausted,
                # not an unknown session.
                if self.scheduler.session_closed(msg["session"]):
                    return {"ok": True, "exhausted": True}
                raise
            got = sess.fetch(timeout=float(msg.get("timeout", 60.0)))
            if got is None:
                return {"ok": True, "exhausted": True}
            return {"ok": True, **proto.encode_arrays(got)}
        if op == "close_session":
            res = self.scheduler.close_session(
                msg["session"], timeout=float(msg.get("timeout", 300.0))
            )
            payload: dict = {
                "ok": True,
                "frames": int(res.timing.get("n_frames", 0)),
                "timing": _json_safe(res.timing),
                "diagnostics": proto.encode_arrays(res.diagnostics),
            }
            if res.transforms is not None:
                payload["transforms"] = proto.encode_array(res.transforms)
            if res.fields is not None:
                payload["fields"] = proto.encode_array(res.fields)
            if res.corrected is not None and len(res.corrected):
                payload["corrected"] = proto.encode_array(res.corrected)
            return payload
        if op == "shutdown":
            return {"ok": True, "stats": self.scheduler.stats()}
        raise ValueError(f"unknown op {op!r}")

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServeServer":
        self.scheduler.start()
        self._thread = threading.Thread(
            target=self._tcp.serve_forever,
            name="kcmc-serve-tcp",
            daemon=True,
        )
        self._thread.start()
        return self

    def request_shutdown(self) -> None:
        self._shutdown.set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until a client `shutdown` op (or timeout)."""
        return self._shutdown.wait(timeout)

    def stop(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.scheduler.stop()

    def __enter__(self) -> "ServeServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def _json_safe(obj):
    """Timing dicts may carry numpy scalars; make them JSON-clean."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def serve_main(args) -> int:
    """`python -m kcmc_tpu_torch serve` body (argparse args from
    __main__; `args.device` is the corrector's device: None is the card,
    and raises without one)."""
    from kcmc_tpu_torch import MotionCorrector
    from kcmc_tpu_torch.obs.log import advise

    t_boot = time.perf_counter()
    overrides = dict(args.overrides)
    mc = MotionCorrector(
        model=args.model,
        backend=getattr(args, "backend", "torch"),
        device=args.device,
        reference=args.reference,
        template_update_every=args.template_update,
        **overrides,
    )
    # Execution-plan warm-up BEFORE the ready line: with plan_buckets
    # declared, every hot program runs once now (its kernel libraries
    # built or loaded from the persistent cache), so sessions open
    # against warm plans. The ready record reports the cost so
    # operators can verify a resident server actually started warm
    # (stamp_misses == 0 on a re-boot).
    warm = None
    if mc.config.plan_buckets:
        try:
            warm = mc.warmup()
        except Exception as e:
            advise(
                f"kcmc serve: execution-plan warm-up failed "
                f"({type(e).__name__}: {e}); programs compile lazily",
                stacklevel=2,
            )
    server = ServeServer(
        mc, host=args.host, port=args.port, heartbeat_s=args.heartbeat
    )
    server.start()
    try:
        # The standard production stop (docker stop / systemd / k8s) is
        # SIGTERM; without this, Python's default handler kills the
        # process mid-work — no clean-shutdown record, session writers
        # never flushed. Main thread only; harmless to skip elsewhere.
        import signal

        signal.signal(
            signal.SIGTERM, lambda *_: server.request_shutdown()
        )
    except ValueError:
        pass
    ready = {
        "serving": True,
        "host": server.host,
        "port": server.port,
        "model": mc.config.model,
        "backend": mc.backend_name,
        "batch_size": mc.config.batch_size,
        "queue_depth": mc.config.serve_queue_depth,
        "inflight": mc.config.serve_inflight,
        # transport-deadline baseline: operator tooling passes this to
        # its ServeClient(io_timeout=) so client read deadlines follow
        # the server's configured serve_io_timeout_s
        "io_timeout_s": mc.config.serve_io_timeout_s,
        "journal_dir": mc.config.serve_journal_dir,
        # process start -> ready wall time (includes backend + mesh
        # construction and the plan warm-up when configured)
        "warmup_s": round(time.perf_counter() - t_boot, 3),
    }
    if warm is not None:
        ready["plan_cache"] = {
            "programs_built": warm.get("programs_built", 0),
            "stamp_hits": warm.get("stamp_hits", 0),
            "stamp_misses": warm.get("stamp_misses", 0),
            "build_s": warm.get("build_s", 0.0),
            "persistent": warm.get("persistent", False),
        }
    print(json.dumps(ready), flush=True)
    try:
        while not server.wait(timeout=0.5):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        stats = server.scheduler.stats()
        server.stop()
        # every session shared the process-wide decode/encode pools
        # (io/feeder.py shared_pool registry); tear them down with the
        # serve plane so no spawn worker outlives the server
        from kcmc_tpu_torch.io import feeder

        feeder.shutdown_shared_pools()
        print(json.dumps({"served": True, "stats": stats}), flush=True)
    return 0
