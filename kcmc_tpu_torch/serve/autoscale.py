"""Fleet autoscaler: a control loop over the router's merged load (the
port's copy of kcmc_tpu/serve/autoscale.py).

Watches the fleet-wide backlog (`FleetRouter.fleet_load`: queued
frames vs aggregate queue capacity, plus the merged end-to-end p99
from the telemetry plane) and reshapes the fleet through the router's
two verbs:

* **scale up** — backlog above `scale_up_at` of capacity (or e2e p99
  above `p99_high_s`, when set) spawns a warm replica (`spawn_fn`,
  typically `fleet.spawn_replica` with the fleet's shared serve args)
  and `add_replica`s it into the placement ring;
* **scale down** — backlog below `scale_down_at` drains the spawned
  replica with the fewest bound sessions: `drain_replica` SIGTERMs it
  (journaling every open session), migrates the stragglers to
  survivors, and removes it from the ring.

Every action arms a shared `fleet_scale_cooldown_s` cooldown so a
bursty load can't flap the fleet: a spawn's warm boot and a drain's
migrations both take seconds, and reacting again before the last
action has settled just oscillates. The cooldown runs from the last
ACTION: before the first one there is nothing to settle, so the first
decision is free whatever the host's uptime (the reference stamps a
`time.monotonic()` of 0.0 as its last action, which holds every
decision on a host booted less than a cooldown ago).

The loop runs on one named daemon thread (`kcmc-fleet-autoscale`,
joined by `stop()` — the leak checker sees it exit) and never lets an
exception kill itself: a failed spawn or drain is advisory-logged and
retried at the next tick.
"""

from __future__ import annotations

import threading
import time

from kcmc_tpu_torch.obs.log import advise
from kcmc_tpu_torch.serve.fleet import DEAD


class Autoscaler:
    def __init__(
        self,
        router,
        spawn_fn,
        min_replicas: int = 1,
        max_replicas: int = 4,
        interval_s: float = 2.0,
        cooldown_s: float | None = None,
        scale_up_at: float = 0.5,
        scale_down_at: float = 0.05,
        p99_high_s: float | None = None,
    ):
        """`router` is a started FleetRouter; `spawn_fn()` returns a
        ready `Replica` (warm-booted serve process). `scale_up_at` /
        `scale_down_at` are fractions of aggregate queue capacity;
        `cooldown_s` defaults to the router config's
        `fleet_scale_cooldown_s`; `p99_high_s`, when set, is an
        additional scale-up trigger on the fleet-merged end-to-end
        p99."""
        if cooldown_s is None:
            cooldown_s = float(router.config.fleet_scale_cooldown_s)
        if not 0 < min_replicas <= max_replicas:
            raise ValueError(
                "autoscaler bounds need 0 < min_replicas <= "
                f"max_replicas, got {min_replicas}..{max_replicas}"
            )
        if not 0.0 <= scale_down_at < scale_up_at:
            raise ValueError(
                "autoscaler needs 0 <= scale_down_at < scale_up_at, "
                f"got down={scale_down_at} up={scale_up_at}"
            )
        self.router = router
        self.spawn_fn = spawn_fn
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self.scale_up_at = float(scale_up_at)
        self.scale_down_at = float(scale_down_at)
        self.p99_high_s = p99_high_s
        self.decisions: list[dict] = []  # recent actions, for stats
        # monotonic stamp of the last reshape; None until the first
        self._last_action: float | None = None
        # serializes the loop thread with synchronous tick() callers
        # (tests) — one control decision at a time
        self._tick_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- control loop ------------------------------------------------------

    def tick(self) -> dict | None:
        """One control decision. Public so tests can drive the loop
        synchronously; returns the action record or None for a hold."""
        with self._tick_lock:
            return self._tick_locked()

    def _tick_locked(self) -> dict | None:
        load = self.router.fleet_load()
        queued, capacity = load["queued_frames"], load["capacity"]
        n_live, n_owned = load["n_live"], load["n_owned"]
        frac = (queued / capacity) if capacity > 0 else 0.0
        p99 = load.get("e2e_p99_s")
        hot = frac >= self.scale_up_at or (
            self.p99_high_s is not None
            and p99 is not None
            and p99 >= self.p99_high_s
        )
        now = time.monotonic()
        if (
            self._last_action is not None
            and now - self._last_action < self.cooldown_s
        ):
            return None
        action: dict | None = None
        if hot and n_live < self.max_replicas:
            replica = self.spawn_fn()
            self.router.add_replica(replica)
            action = {
                "action": "spawn",
                "replica": replica.rid,
                "load": round(frac, 3),
                "e2e_p99_s": p99,
            }
        elif (
            not hot
            and frac <= self.scale_down_at
            and n_live > self.min_replicas
            and n_owned > 0
        ):
            rid = self._pick_drain_victim()
            if rid is not None:
                drained = self.router.drain_replica(rid)
                action = {
                    "action": "drain",
                    "replica": rid,
                    "migrated": len(drained["migrated"]),
                    "load": round(frac, 3),
                }
        if action is not None:
            self._last_action = now
            self.decisions.append(action)
            del self.decisions[:-32]
            advise(
                f"kcmc autoscale: {action['action']} "
                f"{action['replica']} (load {frac:.2f}, "
                f"fleet {n_live} live)",
                stacklevel=2,
            )
        return action

    def _pick_drain_victim(self) -> str | None:
        """The SPAWNED replica with the fewest bound sessions —
        adopted (externally managed) replicas are never drained, and
        the emptiest victim minimizes migration work."""
        stats = self.router.stats()
        owned = [
            (info["sessions"], rid)
            for rid, info in stats["replicas"].items()
            if info["spawned"] and info["state"] != DEAD
        ]
        return min(owned)[1] if owned else None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:  # the loop must outlive bad ticks
                advise(
                    f"kcmc autoscale: tick failed "
                    f"({type(e).__name__}: {e})",
                    stacklevel=2,
                )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(
            target=self._loop, name="kcmc-fleet-autoscale", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
