"""Elastic fleet control: demand-driven replica scaling over the
request router (the port's copy of ``repro.serve.elastic``).

RISC-NN's scaling argument — a fleet of simple units beats one
monolithic engine because units can be added and removed to track the
workload — lands here as the serving control loop: production load is
bursty, and a fleet provisioned for peak idles through every trough.  ``ElasticController`` wraps a
``RequestRouter`` and resizes its replica set live:

* **Demand signal.**  Every ``scale_interval`` steps the controller
  reads the router's queue depth (arrived requests only) plus the
  fleet's in-flight count — the requests that *want* a slot right now.
  The target replica count is the smallest fleet whose batch slots
  cover that demand (``target_load`` scales how hot a replica should
  run), clamped to ``[min_replicas, max_replicas]``.
* **Scale up fast.**  A burst raises the *instant* signal and replicas
  join the same control round — a joining replica is just a fresh
  engine on the shared ``ServePrograms`` bundle, so the join costs
  allocator state (a KV pool) and the engine's cast of the projection
  weights, and it takes dispatches on the next router step.
* **Scale down with patience.**  Retirement uses the smoothed signal
  (EMA, never below the instant value) and waits
  ``scale_down_patience`` consecutive low rounds before draining ONE
  replica — hysteresis so a sawtooth trough must persist before the
  fleet shrinks, and shrinkage is gradual.  The victim is the live
  replica with the least outstanding work (ties: the coldest prefix
  trie — ``PrefixCache.resident_tokens`` — so the fleet keeps its
  warmest caches).
* **Graceful drain, live migration.**  ``RequestRouter.drain`` marks
  the victim; from that instant it takes no new admissions, and the
  next router step *migrates* every request it still holds — extracted
  at the confirmed-token frontier (``ServeEngine.extract_all``) and
  re-queued at the router head, oldest first.  Re-admission on the
  surviving replicas goes through the normal trie lookup, so a
  migrated request whose shared prefix is resident on the target
  rebuilds its prompt pages by **donation** (a refcount attach), and
  its confirmed tokens replay through the target's decode program —
  the resumed stream is bitwise the stream a static fleet would have
  produced.  No request is ever dropped or reordered by scaling.

The controller implements the same ``ServeBackend`` protocol as the
engine and the router — a front-end (serve/frontend.py) cannot tell a
fixed fleet from an elastic one.  Its ``capacity`` deliberately
reports the fleet's *potential* (``max_replicas`` × per-replica
slots), not its current size: a front-end that throttles at current
capacity would hide the very demand the controller scales on.

This is the serving half of ``repro.serve.elastic``.  Its training
half (``plan_elastic_mesh``, ``StragglerMonitor``) belongs to the
training driver, which the port does not have yet.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

from .backend import StreamEvent
from .router import RequestRouter
from .scheduler import Request, ServeEngine
from .telemetry import expose_counters, next_uid

__all__ = ["ElasticController", "ElasticPolicy"]


@dataclasses.dataclass
class ElasticPolicy:
    """Knobs of the demand-driven scaling loop (see module docstring
    for the loop itself)."""
    min_replicas: int = 1
    max_replicas: int = 4
    scale_interval: int = 8      # steps between control rounds
    target_load: float = 1.0     # demand per slot a replica should carry
    scale_down_patience: int = 2  # low rounds before draining one
    alpha: float = 0.5           # demand-EMA smoothing (scale-down only)
    # crash repair: while the fleet sits below
    # min_replicas the controller tries to replace lost replicas via
    # replica_factory — a failed build waits out an exponentially
    # growing backoff (repair_backoff, 2x per consecutive failure, in
    # steps) and spends one unit of the bounded retry budget; a
    # successful join resets both.  Budget exhausted = stay degraded.
    repair_backoff: int = 2
    repair_budget: int = 8

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}")
        if self.scale_interval < 1:
            raise ValueError("scale_interval must be >= 1")
        if self.target_load <= 0:
            raise ValueError("target_load must be > 0")
        if self.repair_backoff < 1:
            raise ValueError("repair_backoff must be >= 1")
        if self.repair_budget < 0:
            raise ValueError("repair_budget must be >= 0")


@expose_counters("n_scale_ups", "n_scale_downs", "n_repairs",
                 "n_repair_failures")
class ElasticController:
    """A ``ServeBackend`` that owns a router and resizes its fleet.

    ``replica_factory`` builds one fresh ``ServeEngine`` per call;
    build it over the fleet's shared ``ServePrograms`` bundle
    (``ServeOptions.build`` does).
    """

    def __init__(self, router: RequestRouter,
                 replica_factory: Callable[[], ServeEngine], *,
                 policy: Optional[ElasticPolicy] = None):
        self.router = router
        self.factory = replica_factory
        self.policy = policy or ElasticPolicy()
        if len(router.replicas) > self.policy.max_replicas:
            raise ValueError(
                f"router starts with {len(router.replicas)} replicas; "
                f"policy caps the fleet at {self.policy.max_replicas}")
        # fleets are homogeneous (one factory): per-replica slots are a
        # constant of the fleet, read off the first member
        self._slots = router.replicas[0].max_batch
        self._tick = 0
        self._ema: Optional[float] = None
        self._low_rounds = 0
        # repair loop state: next tick allowed to attempt a rebuild,
        # current backoff delay, remaining retry budget
        self._repair_at = 0
        self._repair_delay = self.policy.repair_backoff
        self._repair_budget = self.policy.repair_budget
        # counters in the fleet's shared registry (legacy names via
        # @expose_counters); the controller shares the router's
        # Telemetry — one registry per serving stack
        self.tel = router.tel
        self.uid = next_uid("c")
        self._c = {n: self.tel.registry.counter(
            n, component="elastic", replica=self.uid)
            for n in ("n_scale_ups", "n_scale_downs", "n_repairs",
                      "n_repair_failures")}

    # -------------------------------------------------------- delegation
    @property
    def replicas(self) -> List[ServeEngine]:
        return self.router.replicas

    @property
    def finished(self) -> List[Request]:
        return self.router.finished

    @property
    def n_inflight(self) -> int:
        return self.router.n_inflight

    @property
    def capacity(self) -> int:
        """The fleet's POTENTIAL concurrency (``max_replicas`` × batch
        slots), not its current size: front-ends throttle submission at
        ``capacity``, and demand they withhold is demand the control
        loop cannot see — the elastic fleet must be offered the load it
        is supposed to scale into."""
        return self.policy.max_replicas * self._slots

    def check_admissible(self, req: Request) -> None:
        self.router.check_admissible(req)

    def submit(self, req: Request) -> None:
        self.router.submit(req)

    def drain_events(self) -> List[StreamEvent]:
        return self.router.drain_events()

    def extract(self, rid: int) -> Optional[Request]:
        return self.router.extract(rid)

    def cancel(self, rid: int) -> bool:
        return self.router.cancel(rid)

    # ----------------------------------------------------------- control
    def demand(self, now: float = float("inf")) -> int:
        """Requests that want a slot right now: arrived-but-queued plus
        everything already on a replica."""
        queued = sum(1 for r in self.router.queue if r.arrival <= now)
        return queued + sum(e.n_inflight for e in self.router.replicas)

    def _target(self, demand: float) -> int:
        per = self._slots * self.policy.target_load
        want = math.ceil(demand / per)
        return max(self.policy.min_replicas,
                   min(self.policy.max_replicas, want))

    def _victim(self) -> Optional[int]:
        """Index of the live replica to retire: least outstanding
        tokens, then the coldest prefix trie — keep the warm caches."""
        live = [i for i in range(len(self.router.replicas))
                if not self.router.is_draining(i)]
        if len(live) <= 1:
            return None

        def score(i: int) -> Tuple[int, int, int]:
            eng = self.router.replicas[i]
            warmth = (eng.cache.prefix.resident_tokens()
                      if eng.cache.prefix is not None else 0)
            return (self.router._outstanding_tokens(i), warmth, i)
        return min(live, key=score)

    def _control(self, now: float) -> None:
        demand = self.demand(now)
        self._ema = (demand if self._ema is None else
                     self.policy.alpha * demand
                     + (1 - self.policy.alpha) * self._ema)
        live = self.router.n_live
        # scale up on the INSTANT signal: bursts must not wait out the
        # EMA.  All missing replicas join this round.
        up = self._target(demand)
        for _ in range(max(0, up - live)):
            try:
                eng = self.factory()
            except Exception as e:
                # a broken factory must not kill the serve loop; the
                # next control round (or the backoff-gated repair
                # loop, if the fleet is degraded) retries
                self._c["n_repair_failures"].inc()
                if self.tel:
                    self.tel.record("elastic", t=self.router._last_now,
                                    kind="scale_up_failed",
                                    error=type(e).__name__)
                break
            self.router.add_replica(eng)
            self._c["n_scale_ups"].inc()
        live = self.router.n_live
        # scale down on the smoothed signal (never below instant: a
        # trough that already ended is not a trough), with patience —
        # and at most one drain per control round, so shrinkage is
        # gradual and each drain's migration settles before the next.
        down = self._target(max(self._ema, demand))
        if down < live:
            self._low_rounds += 1
            if self._low_rounds >= self.policy.scale_down_patience:
                victim = self._victim()
                if victim is not None:
                    self.router.drain(victim)
                    self._c["n_scale_downs"].inc()
                self._low_rounds = 0
        else:
            self._low_rounds = 0
        if self.tel:
            self.tel.record(
                "elastic", t=self.router._last_now, kind="control",
                demand=demand, ema=round(self._ema, 3),
                target_up=up, live=self.router.n_live,
                draining=len(self.router._draining))

    # ------------------------------------------------------------ repair
    @property
    def degraded(self) -> bool:
        """True while the fleet sits below ``min_replicas`` — lost
        capacity the repair loop has not yet rebuilt.  Front-ends use
        this to shed batch-class admissions."""
        return self.router.n_live < self.policy.min_replicas

    def _maybe_repair(self, now: float) -> None:
        """Replace crash-lost replicas.  Runs every step (a control
        round only every ``scale_interval`` — too slow for a dead
        fleet), gated by exponential backoff and the bounded retry
        budget so a persistently failing factory cannot hot-loop."""
        if not self.degraded:
            return
        if self._repair_budget <= 0 or self._tick < self._repair_at:
            return
        try:
            eng = self.factory()
        except Exception as e:
            self._c["n_repair_failures"].inc()
            self._repair_budget -= 1
            self._repair_at = self._tick + self._repair_delay
            self._repair_delay *= 2
            if self.tel:
                self.tel.record(
                    "elastic", t=self.router._last_now,
                    kind="repair_failed", error=type(e).__name__,
                    budget=self._repair_budget,
                    next_in=self._repair_at - self._tick)
            return
        self.router.add_replica(eng)
        self._c["n_repairs"].inc()
        self._repair_delay = self.policy.repair_backoff
        self._repair_budget = self.policy.repair_budget
        if self.tel:
            self.tel.record("elastic", t=self.router._last_now,
                            kind="repair", live=self.router.n_live)

    # -------------------------------------------------------------- step
    def step(self, now: float = float("inf")) -> bool:
        """One fleet iteration: run the control loop every
        ``scale_interval``-th call, repair crash losses, then one
        router step (which executes any drain the control round just
        marked, and detects/recovers any replica failure).  Returns
        True while anything is queued or in flight."""
        if self._tick % self.policy.scale_interval == 0:
            self._control(now)
        self._maybe_repair(now)
        self._tick += 1
        return self.router.step(now)

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, float]:
        """The router's fleet-wide counters (departed replicas
        included) plus the controller's scaling history."""
        agg = self.router.stats()
        agg["n_scale_ups"] = self.n_scale_ups
        agg["n_scale_downs"] = self.n_scale_downs
        agg["n_repairs"] = self.n_repairs
        agg["n_repair_failures"] = self.n_repair_failures
        agg["n_control_rounds"] = (self._tick
                                   + self.policy.scale_interval - 1) \
            // self.policy.scale_interval
        return agg

    # -------------------------------------------------------------- run
    def run(self, requests: List[Request], *,
            realtime: bool = False) -> List[Request]:
        """Drive to completion; returns the requests completed by THIS
        call in completion order (mirrors ``RequestRouter.run``, with
        the control loop in the driving seat)."""
        first = len(self.finished)
        for r in requests:
            self.submit(r)
        t0 = time.perf_counter()
        while True:
            now = (time.perf_counter() - t0) if realtime else float("inf")
            if not self.step(now=now):
                break
            if realtime and self.router.queue \
                    and not any(e.n_inflight for e in self.replicas):
                time.sleep(max(0.0, self.router.queue[0].arrival
                               - (time.perf_counter() - t0)))
        done = list(self.finished[first:])
        done.sort(key=lambda r: (r.finish_time, r.rid))
        return done
