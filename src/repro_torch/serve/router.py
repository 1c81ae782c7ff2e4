"""Multi-replica request router: one front-end queue over N
independent serve-engine replicas — N *elastic* (the port's copy of
``repro.serve.router``).

This is the scale-*out* half of distributed serving: replicas are
whole engines — each with its own batch slots, page pool, and prefix
trie — and the router decides *which* replica serves each request.
(The scale-*up* half, tensor-parallel engines, is
``serve/parallel.py``.)  On one GPU the replicas share the card and one
``ServePrograms`` (or ``TPServePrograms``); the router steps them in
turn, so their programs never overlap on the device.

Routing policies (``policy=``):

* ``"prefix"`` (default) — **prefix affinity**: land a request on the
  replica whose trie already holds its prompt prefix, so the KV
  compute (and pages) for a shared system prompt are paid once *per
  replica that ever sees the workload* instead of once per request.
  Affinity is scored from two sources: a read-only trie probe
  (``PrefixCache.probe`` — ground truth for what is resident *now*)
  and the router's own recent-dispatch record (what will *become*
  resident once in-flight requests donate their prompts — a burst of
  same-prefix requests must not scatter just because the first one
  hasn't finished prefilling).  Ties, and prefixes nobody holds, fall
  back to least-outstanding-tokens.
* ``"least-loaded"`` — least outstanding tokens: queued + in-flight
  work (remaining prompt ingestion plus remaining generation budget),
  the standard N-queues load balancer.
* ``"round-robin"`` — dispatch order, ignoring both load and
  affinity; the baseline the policy tests compare against.

**Backpressure.**  Each replica accepts at most ``max_inflight``
requests (default ``2 * max_batch``: a full batch plus one queued
wave).  When every replica is at its cap the router simply *holds* the
queue — requests are never dropped and never reordered (FIFO; a
held head blocks later requests, which keeps arrival order fair and
routing deterministic).

**Elastic membership.**  The fleet is no longer fixed at construction:
``add_replica`` joins a fresh engine mid-trace, and ``drain`` retires
one *gracefully* — the draining replica takes no new admissions, and
on the next ``step`` every request it still holds (queued, prefilling,
or decoding) is **migrated**: extracted at its confirmed-token
frontier (``ServeEngine.extract_all`` — the same preempt-to-host
machinery ``extract`` uses) and re-queued at the *head* of the router
queue, oldest first, ahead of never-admitted arrivals.  Re-admission
on the target replica goes through the normal path: the prompt is
looked up in the target's prefix trie, so a migrated request whose
shared prefix is already resident there rebuilds its prompt pages via
**trie donation** — a refcount attach — rather than any cross-replica
byte copy, and its confirmed tokens replay through the target's decode
program (exact recompute-replay), so the resumed stream is bitwise the
stream it would have produced had it never moved.  Once empty, the
replica leaves the fleet; its engine counters are folded into
``stats()`` forever (departure never un-counts work — the
``n_total_dispatches = prefill + decode + replay − fused`` identity
holds fleet-wide across any churn), its finished requests stay in the
router's completion log, and its undrained stream events are held for
the next ``drain_events``.  The demand-driven control loop that
decides *when* to scale lives one layer up (serve/elastic.py).

**Failure.**  DRAINING is cooperative; FAILED is not.  A replica
whose ``step`` raises :class:`~repro_torch.serve.faults.ReplicaFailure`, or
that misses the stall watchdog's progress deadline
(``stall_patience`` stepped rounds holding work without a single
dispatch), is declared FAILED: nothing can be extracted from it.  Its
requests are rebuilt from the router-side ``RequestJournal``
(serve/recovery.py) at their journal-confirmed token frontier and
re-admitted at the queue head on survivors — the same recompute-replay
path migration uses, so recovered streams stay bitwise-exact — and its
counters fold through the departed-stats accumulator exactly like a
graceful retirement, so the fleet dispatch identities survive the
crash.  See the reference's docs/robustness.md.

**Why the aggregate scales.**  The router's throughput story is the
paper's memory argument one level up: a single replica's page pool
bounds how many distinct hot prefixes stay resident — a workload
cycling through more prompt groups than the trie can hold LRU-thrashes
and re-prefills every admission.  N replicas hold N pools, and prefix
affinity *partitions* the groups across them, so each replica's
working set fits again (the reference's benchmarks/serve_router.py
measures exactly this regime).  Token streams are unchanged by construction: every
replica is a token-exact engine and routing only chooses *where* a
stream is produced.

The router implements the same ``ServeBackend`` protocol as a single
engine (serve/backend.py): submit/step/run/stats plus the streaming
face (``drain_events``) and mid-stream removal (``extract``/
``cancel``) — a front-end cannot tell one replica from a fleet, or a
fixed fleet from an elastic one.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .backend import StreamEvent
from .faults import ReplicaFailure
from .recovery import RequestJournal
from .scheduler import Request, ServeEngine
from .telemetry import (Telemetry, expose_counters, merge_stats,
                        next_uid)

__all__ = ["RequestRouter", "ROUTER_POLICIES"]

ROUTER_POLICIES = ("prefix", "least-loaded", "round-robin")

_ROUTER_COUNTERS = ("n_joined", "n_departed", "n_migrations",
                    "n_migrated_tokens", "n_affinity_hits",
                    "n_failures", "n_recovered_requests",
                    "n_recovery_replayed_tokens")


@expose_counters(*_ROUTER_COUNTERS)
class RequestRouter:
    def __init__(self, replicas: Sequence[ServeEngine], *,
                 policy: str = "prefix",
                 max_inflight: Optional[int] = None,
                 affinity_record: int = 1024,
                 stall_patience: int = 8,
                 telemetry: Optional[Telemetry] = None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"choose from {ROUTER_POLICIES}")
        self.policy = policy
        self.max_inflight = (max_inflight if max_inflight is not None
                             else 2 * max(e.max_batch for e in replicas))
        if self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.queue: deque[Request] = deque()
        self._rr = 0                     # round-robin cursor
        self._recent_cap = affinity_record
        # elastic membership: every replica gets a stable id at join
        # (list indices shift as replicas leave; ids never do)
        self.replicas: List[ServeEngine] = []
        self._ids: List[int] = []
        self._next_id = 0
        self._draining: set = set()            # replica ids mid-drain
        # replica id -> LRU-ordered page-run keys of recently dispatched
        # prompts (before their pages can appear in the trie)
        self._recent: Dict[int, Dict[Tuple[int, ...], None]] = {}
        self._harvested: Dict[int, int] = {}   # id -> finished harvested
        self.n_dispatched: List[int] = []      # parallel to replicas
        # completion log: finished requests in completion order,
        # harvested every step so they survive replica departure
        self.completed: List[Request] = []
        self._pending_events: List[StreamEvent] = []
        # counters of work done by replicas that have LEFT the fleet —
        # stats() folds these in so dispatch-count identities hold
        # across arbitrary membership churn
        self._departed_stats: Dict[str, float] = {}
        self._departed_routed = 0
        # counters live in the shared MetricsRegistry — legacy names
        # (n_joined, n_migrations = requests moved by a drain,
        # n_migrated_tokens = confirmed tokens they carried,
        # n_affinity_hits = dispatches with affinity > 0, ...) are
        # read-only properties via @expose_counters.  The router
        # inherits the first replica's Telemetry by default, so a
        # hand-built fleet shares one registry without extra wiring.
        self.tel = (telemetry if telemetry is not None
                    else replicas[0].tel)
        self.uid = next_uid("r")
        self._c = {n: self.tel.registry.counter(
            n, component="router", replica=self.uid)
            for n in _ROUTER_COUNTERS}
        self._peak = self.tel.registry.gauge(
            "n_replicas_peak", component="router", replica=self.uid)
        self.migrated_rids: set = set()
        self._migrating: Dict[int, str] = {}   # rid -> src engine uid
        self._last_now = 0.0
        # crash recovery (serve/recovery.py): the
        # journal mirrors every dispatched request's confirmed-token
        # frontier from the events the router drains each step, so a
        # replica that dies without answering extract() can have its
        # requests rebuilt router-side.  The watchdog declares a
        # replica FAILED after stall_patience consecutive steps
        # holding work without dispatching any.
        if stall_patience < 1:
            raise ValueError("stall_patience must be >= 1")
        self.stall_patience = stall_patience
        self._journal = RequestJournal()
        self.failed_rids: set = set()          # rids ever recovered
        # replica id -> (last n_total_dispatches seen, stuck rounds)
        self._progress: Dict[int, Tuple[float, int]] = {}
        for eng in replicas:
            self.add_replica(eng)

    # ------------------------------------------------------- membership
    def add_replica(self, engine: ServeEngine) -> int:
        """Join ``engine`` to the fleet (it starts taking dispatches on
        the next ``step``).  Returns the replica's stable id.  All
        replicas built from one ``ServePrograms`` bundle share its
        programs, so a join costs allocator state (a KV pool) and the
        engine's cast of the projection weights, nothing more."""
        rid = self._next_id
        self._next_id += 1
        self.replicas.append(engine)
        self._ids.append(rid)
        self._recent[rid] = {}
        self._harvested[rid] = len(engine.finished)
        self.n_dispatched.append(0)
        self._c["n_joined"].inc()
        self._peak.set(max(self.n_replicas_peak, self.n_live))
        if self.tel:
            self.tel.record("router", t=self._last_now, kind="join",
                            replica=engine.uid,
                            fleet=len(self.replicas))
        return rid

    @property
    def n_replicas_peak(self) -> int:
        return int(self._peak.value)

    def _index_of(self, replica: Union[int, ServeEngine]) -> int:
        # identity first: replicas may be wrapped backends (e.g. a
        # FaultInjector), not literal ServeEngine instances
        if not isinstance(replica, int):
            for i, e in enumerate(self.replicas):
                if e is replica:
                    return i
            raise ValueError("engine is not in this fleet")
        if not 0 <= replica < len(self.replicas):
            raise ValueError(f"no replica at index {replica}")
        return replica

    @property
    def n_live(self) -> int:
        """Replicas accepting new admissions (not draining)."""
        return len(self.replicas) - len(self._draining)

    def is_draining(self, replica: Union[int, ServeEngine]) -> bool:
        return self._ids[self._index_of(replica)] in self._draining

    def drain(self, replica: Union[int, ServeEngine]) -> None:
        """Begin graceful scale-down of one replica: it takes no new
        admissions from this call on, and the next ``step`` migrates
        every request it still holds (extract at the confirmed-token
        frontier, re-queue at the router head) before removing it from
        the fleet.  Confirmed tokens survive; re-admission elsewhere
        resumes each stream token-exactly.  Idempotent per replica;
        refuses to drain the last live replica (the fleet must always
        be able to admit)."""
        i = self._index_of(replica)
        rid = self._ids[i]
        if rid in self._draining:
            return
        if self.n_live <= 1:
            raise ValueError("cannot drain the last live replica")
        self._draining.add(rid)

    def _remove_replica(self, i: int) -> None:
        """Drop an (empty) replica from the fleet, preserving its
        history: finished requests were harvested, engine counters fold
        into the departed-stats accumulator, undrained stream events
        queue for the next ``drain_events``."""
        eng = self.replicas[i]
        assert eng.n_inflight == 0, "removing a replica with live work"
        self._harvest(i)
        self._absorb(eng)
        self._drop_replica(i, eng.stats(), kind="retire")

    def _drop_replica(self, i: int, st: Dict[str, float], *,
                      kind: str, **fields) -> None:
        """Shared fleet-exit bookkeeping (graceful retire AND crash):
        fold the replica's counters into the departed-stats
        accumulator — departure never un-counts work, so the dispatch
        identity holds fleet-wide across any churn — and excise it
        from every membership structure."""
        eng = self.replicas[i]
        self._departed_stats = merge_stats([self._departed_stats, st])
        self._departed_routed += self.n_dispatched[i]
        rid = self._ids[i]
        self._draining.discard(rid)
        self._recent.pop(rid)
        self._harvested.pop(rid)
        self._progress.pop(rid, None)
        del self.replicas[i]
        del self._ids[i]
        del self.n_dispatched[i]
        self._c["n_departed"].inc()
        if self.tel:
            self.tel.record("router", t=self._last_now, kind=kind,
                            replica=eng.uid,
                            fleet=len(self.replicas), **fields)
        if self._rr > i:
            self._rr -= 1
        self._rr = self._rr % max(len(self.replicas), 1)

    # -------------------------------------------------------- failure
    def fail(self, replica: Union[int, ServeEngine],
             reason: str = "killed") -> int:
        """Declare a replica FAILED — the kill switch (chaos tests,
        an external health checker).  Unlike ``drain`` nothing is
        asked of the replica: its requests are rebuilt from the
        recovery journal and re-admitted on survivors.  Returns the
        number of requests recovered."""
        return self._fail_replica(self._index_of(replica),
                                  reason=reason)

    def _fail_replica(self, i: int, *, reason: str) -> int:
        """Handle a dead replica: mark its wrapper dead (a late
        revival must not double-serve), fold whatever counters are
        still scrapeable, drop it from the fleet, then reconstruct
        its lost requests from the journal — truncated to the
        confirmed-token frontier the router has already streamed —
        and re-admit them at the head of the queue (oldest first,
        like a drain's migration).  Re-admission rides the normal
        recompute-replay path, so every recovered stream is bitwise
        the stream an unfailed replica would have produced."""
        eng = self.replicas[i]
        sid = self._ids[i]
        if hasattr(eng, "mark_dead"):
            eng.mark_dead()
        try:
            self._harvest(i)         # finished work is already safe
        except ReplicaFailure:
            pass
        try:
            st = eng.stats()         # counters survive the process
        except ReplicaFailure:
            st = {}
        lost = self._journal.lost(sid)
        self._c["n_failures"].inc()
        recovered: List[Request] = []
        for entry in lost:
            req, burden = RequestJournal.reconstruct(entry)
            self._c["n_recovered_requests"].inc()
            self._c["n_recovery_replayed_tokens"].inc(burden)
            self.failed_rids.add(req.rid)
            if self.tel:
                self.tel.event(req, "failed", t=self._last_now,
                               replica=eng.uid, reason=reason)
                self.tel.event(req, "recovered", t=self._last_now,
                               n_confirmed=entry.confirmed)
            recovered.append(req)
        self._drop_replica(i, st, kind="fail", reason=reason,
                           lost=len(recovered))
        # journal.lost returned oldest-first; head-insert preserves it
        self.queue.extendleft(reversed(recovered))
        return len(recovered)

    def _pump_drains(self) -> None:
        """Execute pending drains: migrate every request a draining
        replica still holds to the head of the router queue (oldest
        first, ahead of never-admitted arrivals — they have already
        waited once), then retire the empty replica."""
        if not self._draining:
            return
        migrated: List[Request] = []
        for i in [j for j in range(len(self.replicas) - 1, -1, -1)
                  if self._ids[j] in self._draining]:
            eng = self.replicas[i]
            reqs = eng.extract_all()
            self._c["n_migrations"].inc(len(reqs))
            for r in reqs:
                self._c["n_migrated_tokens"].inc(len(r.generated))
                self.migrated_rids.add(r.rid)
                self._journal.unassign(r.rid)
                if self.tel:
                    # the "migrated" span event lands at re-dispatch,
                    # when the destination is known (see step)
                    self._migrating[r.rid] = eng.uid
            migrated.extend(reqs)
            self._remove_replica(i)
        migrated.sort(key=lambda r: (r.arrival, r.rid))
        self.queue.extendleft(reversed(migrated))

    # ---------------------------------------------------------- frontend
    def check_admissible(self, req: Request) -> None:
        """Raise ValueError if NO live replica could ever admit ``req``.
        Heterogeneous fleets are fine — dispatch only considers
        replicas that can take the request."""
        err = None
        for i, eng in enumerate(self.replicas):
            if self._ids[i] in self._draining:
                continue
            try:
                eng.check_admissible(req)
                return
            except ValueError as e:
                err = e
            except ReplicaFailure:
                continue      # dead replica, removed on the next step
        raise err or ValueError("no live replica to admit the request")

    def submit(self, req: Request) -> None:
        """Queue a request (see ``check_admissible`` for rejection)."""
        self.check_admissible(req)
        self.queue.append(req)
        if self.tel:
            self.tel.request_submitted(req, t=req.arrival)

    @property
    def n_inflight(self) -> int:
        return len(self.queue) + sum(e.n_inflight for e in self.replicas)

    @property
    def capacity(self) -> int:
        """Aggregate concurrently-servable requests: the sum of the
        *live* replicas' batch slots (draining replicas are on their
        way out; per-replica ``max_inflight`` only pads each replica's
        internal queue beyond this)."""
        return sum(e.max_batch for i, e in enumerate(self.replicas)
                   if self._ids[i] not in self._draining)

    @property
    def finished(self) -> List[Request]:
        """Completion log across the whole fleet's history — finished
        requests of departed replicas included (same reading as
        ``ServeEngine.finished``)."""
        self._harvest_all()
        return self.completed

    def _absorb(self, eng) -> None:
        """Pull ``eng``'s undrained stream events into the router's
        buffer, advancing the recovery journal's confirmed-token
        frontiers on the way past.  Called for every replica every
        step, so an event the engine emitted is in router memory — and
        journal-counted — before the next step can kill the replica."""
        evs = eng.drain_events()
        if evs:
            self._journal.observe(evs)
            self._pending_events.extend(evs)

    def drain_events(self) -> List[StreamEvent]:
        """Confirmed-token events since the last drain.  The router
        absorbs each replica's events every step (the journal must see
        them — see ``_absorb``), so this mostly serves the buffer; a
        final sweep catches events emitted outside ``step``.
        Per-stream order is exact (a request lives on one replica at a
        time); cross-stream interleaving is already only step-granular
        on a single engine, so buffer order changes nothing a
        streaming consumer can observe."""
        for eng in self.replicas:
            try:
                self._absorb(eng)
            except ReplicaFailure:
                pass          # detected and recovered on the next step
        ev: List[StreamEvent] = self._pending_events
        self._pending_events = []
        return ev

    def extract(self, rid: int) -> Optional[Request]:
        """Remove the request wherever it lives — router queue or any
        replica — freeing backend resources; confirmed tokens survive
        and re-submission resumes the stream exactly (the replay
        machinery makes resumption replica-portable)."""
        for i, r in enumerate(self.queue):
            if r.rid == rid:
                del self.queue[i]
                self._journal.discard(rid)
                return r
        for eng in self.replicas:
            try:
                req = eng.extract(rid)
            except ReplicaFailure:
                continue     # dead replica: its rids live in the queue
                             # (recovered) or are gone — keep scanning
            if req is not None:
                self._journal.discard(rid)
                return req
        return None

    def cancel(self, rid: int) -> bool:
        """Drop a request mid-stream (extract-and-discard); True if the
        rid was live anywhere in the fleet.  Idempotent — a second
        cancel (including one racing a drain's migration) finds
        nothing and returns False."""
        req = self.extract(rid)
        if req is not None:
            self._migrating.pop(rid, None)
            if self.tel:
                self.tel.event(req, "cancelled", t=self._last_now)
        return req is not None

    # --------------------------------------------------------- affinity
    def _page_keys(self, prompt) -> List[Tuple[int, ...]]:
        ps = self.replicas[0].cache.page_size
        toks = [int(t) for t in prompt]
        return [tuple(toks[:(j + 1) * ps])
                for j in range(len(toks) // ps)]

    def _record_dispatch(self, i: int, prompt) -> None:
        rec = self._recent[self._ids[i]]
        for key in self._page_keys(prompt):
            rec.pop(key, None)               # re-dispatch refreshes LRU
            rec[key] = None
        while len(rec) > self._recent_cap:   # evict least recently sent
            rec.pop(next(iter(rec)))

    def _affinity(self, i: int, prompt) -> int:
        """Tokens of ``prompt`` replica ``i`` (probably) holds: the max
        of trie ground truth and the recent-dispatch record."""
        eng = self.replicas[i]
        resident = (eng.cache.prefix.probe(prompt)
                    if eng.cache.prefix is not None else 0)
        ps = eng.cache.page_size
        rec, planned = self._recent[self._ids[i]], 0
        for n, key in enumerate(self._page_keys(prompt)):
            if key not in rec:
                break
            planned = (n + 1) * ps
        return max(resident, planned)

    # -------------------------------------------------------- dispatch
    def _outstanding_tokens(self, i: int) -> int:
        eng = self.replicas[i]
        reqs = list(eng.waiting) + list(eng.prefilling.values()) \
            + list(eng.active.values())
        return sum(len(r.prompt) - r.prefill_pos + r.max_new_tokens
                   - len(r.generated) for r in reqs)

    def _can_admit(self, i: int, req: Request) -> bool:
        try:
            self.replicas[i].check_admissible(req)
            return True
        except (ValueError, ReplicaFailure):
            return False

    def _pick(self, req: Request) -> Optional[int]:
        n = len(self.replicas)
        eligible = [i for i in range(n)
                    if self._ids[i] not in self._draining
                    and self.replicas[i].n_inflight < self.max_inflight
                    and self._can_admit(i, req)]
        if not eligible:
            return None                  # backpressure: hold the queue
        if self.policy == "round-robin":
            for off in range(n):
                i = (self._rr + off) % n
                if i in eligible:
                    self._rr = (i + 1) % n
                    return i
        load = {i: self._outstanding_tokens(i) for i in eligible}
        if self.policy == "prefix":
            aff = {i: self._affinity(i, req.prompt) for i in eligible}
            best = max(aff.values())
            if best > 0:
                self._c["n_affinity_hits"].inc()
                eligible = [i for i in eligible if aff[i] == best]
        return min(eligible, key=lambda i: (load[i], i))

    # -------------------------------------------------------- watchdog
    def _stalled(self, i: int) -> bool:
        """Progress deadline: a replica that holds work and was just
        stepped must dispatch *something* (a prefill chunk, a decode
        round, a replay step).  ``stall_patience`` consecutive stepped
        rounds with a frozen dispatch counter and live requests is a
        wedged process — declare it failed.  Healthy replicas always
        progress when stepped, so the watchdog never fires on them."""
        eng, sid = self.replicas[i], self._ids[i]
        total = eng.n_total_dispatches
        last, stuck = self._progress.get(sid, (None, 0))
        stuck = (stuck + 1 if total == last and eng.n_inflight else 0)
        self._progress[sid] = (total, stuck)
        return stuck >= self.stall_patience

    # --------------------------------------------------------- harvest
    def _harvest(self, i: int) -> None:
        eng, rid = self.replicas[i], self._ids[i]
        new = eng.finished[self._harvested[rid]:]
        if new:
            self.completed.extend(new)
            self._harvested[rid] = len(eng.finished)

    def _harvest_all(self) -> None:
        for i in range(len(self.replicas)):
            self._harvest(i)

    # ------------------------------------------------------------- step
    def step(self, now: float = float("inf")) -> bool:
        """One router iteration: execute pending drains (migrating
        their requests), place every arrived queued request a replica
        will take (FIFO), then pump one engine step on every replica
        with work.  Returns True while anything is queued or in
        flight."""
        self._last_now = (float(now) if now != float("inf")
                          else self._last_now + 1.0)
        drains = len(self._draining)
        self._pump_drains()
        n_routed = 0
        while self.queue and self.queue[0].arrival <= now:
            i = self._pick(self.queue[0])
            if i is None:
                break
            req = self.queue.popleft()
            self.replicas[i].submit(req)
            self._journal.assign(req, self._ids[i])
            if self.tel:
                src = self._migrating.pop(req.rid, None)
                if src is not None:
                    self.tel.event(req, "migrated", t=self._last_now,
                                   src=src, dst=self.replicas[i].uid,
                                   n_generated=len(req.generated))
            self._record_dispatch(i, req.prompt)
            self.n_dispatched[i] += 1
            n_routed += 1
        busy = False
        failed: List[Tuple[int, str]] = []
        for i, eng in enumerate(self.replicas):
            if eng.n_inflight:
                try:
                    eng.step(now)
                except ReplicaFailure:
                    failed.append((i, "crash"))
                    continue
                busy = True
                self._harvest(i)
                self._absorb(eng)
                if self._stalled(i):
                    failed.append((i, "stall"))
        # process failures AFTER the loop (indices shift on removal),
        # highest index first so earlier indices stay valid
        for i, why in sorted(failed, reverse=True):
            self._fail_replica(i, reason=why)
        if failed:
            busy = True              # recovered work re-queued
        if self.tel and (busy or self.queue or drains or n_routed):
            self.tel.record(
                "router", t=self._last_now, kind="route",
                fleet=len(self.replicas), live=self.n_live,
                draining=drains, routed=n_routed,
                queued=len(self.queue),
                inflight=sum(e.n_inflight for e in self.replicas))
        return busy or bool(self.queue)

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, float]:
        """Field-wise sum of every replica's engine counters — living
        AND departed (a replica leaving the fleet never un-counts its
        work, so cross-counter identities like ``n_total_dispatches =
        prefill + decode + replay − fused`` hold across churn) — plus
        the router's own: reads identically to ``ServeEngine.stats``
        (the ``ServeBackend`` contract), with fleet-level extras."""
        # ratio fields don't sum — merge_stats recomputes them from
        # the summed counters, the same derivation a lone engine uses
        agg = merge_stats([self._departed_stats]
                          + [eng.stats() for eng in self.replicas])
        agg["n_replicas"] = len(self.replicas)
        agg["n_replicas_peak"] = self.n_replicas_peak
        agg["n_joined"] = self.n_joined
        agg["n_departed"] = self.n_departed
        agg["n_migrations"] = self.n_migrations
        agg["n_migrated_tokens"] = self.n_migrated_tokens
        agg["n_routed"] = sum(self.n_dispatched) + self._departed_routed
        agg["n_affinity_hits"] = self.n_affinity_hits
        agg["n_failures"] = self.n_failures
        agg["n_recovered_requests"] = self.n_recovered_requests
        agg["n_recovery_replayed_tokens"] = \
            self.n_recovery_replayed_tokens
        return agg

    # -------------------------------------------------------------- run
    def run(self, requests: List[Request], *,
            realtime: bool = False) -> List[Request]:
        """Drive to completion; returns the requests completed by THIS
        call, in completion order (``Request.rid`` identifies streams).
        Mirrors ``ServeEngine.run``'s realtime semantics."""
        first = len(self.finished)
        for r in requests:
            self.submit(r)
        t0 = time.perf_counter()
        while True:
            now = (time.perf_counter() - t0) if realtime else float("inf")
            if not self.step(now=now):
                break
            if realtime and self.queue \
                    and not any(e.n_inflight for e in self.replicas):
                time.sleep(max(0.0, self.queue[0].arrival
                               - (time.perf_counter() - t0)))
        done = list(self.finished[first:])
        done.sort(key=lambda r: (r.finish_time, r.rid))
        return done
