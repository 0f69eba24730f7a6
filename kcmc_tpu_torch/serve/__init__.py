"""kcmc_tpu_torch.serve — the resident serving plane (the port's copy of
kcmc_tpu/serve: a server, and the fleet in front of several).

One-shot runs pay the kernel builds and first-batch setup, own the
card, and die with their input file. This package keeps ONE warm
`TorchBackend` resident on the card and multiplexes many concurrent
client streams through the registration pipeline (docs/SERVING.md):

* `session.Session` — stream-scoped state (reference, rolling-template
  history, cursor, writer, per-session telemetry) decoupled from process
  lifetime; built on `MotionCorrector.stream_view`, so every session
  shares the resident backend;
* `scheduler.StreamScheduler` — batches ready frames per session into
  one bounded in-flight dispatch window (per-entry reference), weighted
  round-robin fairness, admission control that DEGRADES consensus
  budgets under load before it ever rejects;
* `server.ServeServer` / `client.ServeClient` — a line-delimited
  JSON-over-TCP transport (`open_session` / `submit_frames` /
  `results` / `close_session` / `resume_session` / `stats` /
  `metrics` / `trace`) behind `python -m kcmc_tpu_torch serve`; the
  wire format is the reference's byte for byte, so either package's
  client talks to the other's server;
* `journal.SessionJournal` — durable per-session resume snapshots
  (cursor, rolling-template history, transform high-water mark) so a
  killed server restarted over the same `--journal-dir` resumes every
  journaled stream;
* `router.FleetRouter` / `fleet` / `autoscale.Autoscaler` — the fleet
  front door over N serve replicas (`python -m kcmc_tpu_torch router`):
  rendezvous placement, health probing, live migration of streams off
  dead or draining replicas through the shared journal directory,
  admission and autoscaling.
"""

from __future__ import annotations

__all__ = [
    "Session",
    "SessionClosed",
    "StreamScheduler",
    "OverloadedError",
    "ServeServer",
    "ServeClient",
    "ServeError",
    "SessionJournal",
    "FleetRouter",
    "Replica",
    "ReplicaHealth",
    "Autoscaler",
]


def __getattr__(name):  # lazy: importing kcmc_tpu_torch.serve must stay cheap
    if name in ("Session", "SessionClosed"):
        from kcmc_tpu_torch.serve import session

        return getattr(session, name)
    if name == "SessionJournal":
        from kcmc_tpu_torch.serve.journal import SessionJournal

        return SessionJournal
    if name in ("StreamScheduler", "OverloadedError"):
        from kcmc_tpu_torch.serve import scheduler

        return getattr(scheduler, name)
    if name == "ServeServer":
        from kcmc_tpu_torch.serve.server import ServeServer

        return ServeServer
    if name in ("ServeClient", "ServeError"):
        from kcmc_tpu_torch.serve import client

        return getattr(client, name)
    if name == "FleetRouter":
        from kcmc_tpu_torch.serve.router import FleetRouter

        return FleetRouter
    if name in ("Replica", "ReplicaHealth"):
        from kcmc_tpu_torch.serve import fleet

        return getattr(fleet, name)
    if name == "Autoscaler":
        from kcmc_tpu_torch.serve.autoscale import Autoscaler

        return Autoscaler
    raise AttributeError(f"module 'kcmc_tpu_torch.serve' has no attribute {name!r}")
