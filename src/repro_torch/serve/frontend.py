"""Async streaming serve front-end: multi-tenant submit/stream with
SLO classes and weighted fair scheduling over any ``ServeBackend`` (the
port's copy of ``repro.serve.frontend``).

The engine serves offline batches: every request is known up
front and ``run`` drives them to completion.  A production deployment
is the opposite shape — callers arrive at any time, want their tokens
*as they are produced*, may hang up mid-stream, and are not all equal:
an interactive user's time-to-first-token matters more than a bulk
job's throughput (the 99th-percentile argument of datacenter serving).  This
module is that serving surface:

* **submit/stream** — ``submit()`` returns a ``TokenStream`` that
  yields tokens as they are *confirmed* by the backend: one per decode
  step, a burst per accepted speculation round (the streaming face of
  ``drain_events``).  Confirmed tokens are final — preemption/replay
  re-derives KV, never tokens — so streaming is exactly as token-exact
  as the batch path.  Streams are consumable synchronously (iteration
  pumps the backend on demand) or with ``async for`` against a
  ``serve()`` pump task.
* **weighted fair queueing** — each tenant has a ``TenantPolicy``
  (weight, optional token-rate limit).  Dispatch is stride-scheduled:
  a tenant's virtual time advances by ``cost / weight`` per dispatched
  request (cost = prompt + generation budget in tokens), and the
  lowest virtual time dispatches next — long-run token share is
  proportional to weight (the deterministic counterpart of Ray Serve's
  CentralizedQueues traffic split).  Rate limits are debt-style token
  buckets: a tenant whose bucket is negative waits, everyone else
  proceeds.
* **SLO classes** — ``interactive`` requests dispatch before ``batch``
  ones whenever a slot is free, and when none is free an interactive
  arrival *preempts* a batch-class request: the victim is extracted
  from the backend (pages freed via the preemption machinery), parked
  back at the head of its tenant queue, and later resumes token-exactly
  (recompute-replay) — its already-streamed tokens stay valid.
  Exactness makes this SLO knob free of correctness risk.
* **cancel** — ``stream.cancel()`` maps to ``backend.extract``: pages
  return to the allocator immediately, prompt pages the request
  donated to the prefix trie stay resident, so cancel-then-resubmit
  re-shares them.

The front-end owns ALL queueing policy: it dispatches to the backend
only while ``backend.n_inflight < backend.capacity``, so the backend's
internal queue stays empty apart from its own page-pressure
preemptions, and admission order is exactly dispatch order.  Because
``ServeEngine`` and ``RequestRouter`` implement the same
``ServeBackend`` protocol, the front-end serves one engine or a
routed fleet identically.

Clocking: ``pump(now=...)`` drives one scheduling iteration.  With no
argument the front-end self-clocks — wall time when
``realtime=True``, otherwise a deterministic step counter (+1 per
pump), which frames every latency (TTFT, fairness windows) in
*backend steps*: the machine-independent unit the benchmarks gate on
(see the reference's docs/serving.md).
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from .backend import ServeBackend, StreamEvent
from .scheduler import Request, SLO_CLASSES
from .telemetry import (Counter, Telemetry, expose_counters, next_uid)

__all__ = ["ServeFrontend", "TokenStream", "TenantPolicy",
           "ShedRejection"]


class ShedRejection(RuntimeError):
    """Typed admission rejection under degraded capacity: the backend
    reports ``degraded`` (fleet below its replica floor after crash
    losses) and the request is batch-class, so it is refused at submit
    instead of queueing unboundedly behind capacity that may not come
    back.  Interactive traffic keeps flowing.  The caller can retry
    later; nothing was enqueued."""

    def __init__(self, req: Request):
        self.rid = req.rid
        self.tenant = req.tenant
        self.slo_class = req.slo_class
        super().__init__(
            f"request {req.rid} (tenant {req.tenant!r}, "
            f"{req.slo_class}) shed: serving capacity degraded")


@dataclasses.dataclass
class TenantPolicy:
    """Per-tenant traffic policy.

    ``weight`` sets the tenant's long-run token share under contention
    (stride-scheduled WFQ).  ``rate`` (cost units — prompt + budget
    tokens — per clock unit) caps sustained admission via a debt-style
    token bucket of depth ``burst`` (default: one clock unit's worth):
    dispatch is allowed while the bucket is non-negative and charges
    the full request cost, so a tenant can overdraw once but then
    waits out its debt — bursty traffic admits immediately, sustained
    overload is throttled, and no request is ever too big to pass.
    """
    weight: float = 1.0
    rate: Optional[float] = None
    burst: Optional[float] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.rate is not None and self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")


class TokenStream:
    """Per-request confirmed-token stream.

    Iterate synchronously (``for tok in stream`` — pumps the front-end
    on demand until the next token lands) or asynchronously
    (``async for tok in stream`` — parks on an event the pump task
    sets; requires ``frontend.serve()`` running in the same loop).
    ``cancel()`` ends the stream mid-flight; tokens already yielded
    were confirmed and remain valid.
    """

    def __init__(self, frontend: "ServeFrontend", req: Request):
        self._frontend = frontend
        self.req = req
        self._pending: deque = deque()
        self.finished = False
        self.cancelled = False
        self._wakeup: Optional[asyncio.Event] = None

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def tenant(self) -> str:
        return self.req.tenant

    @property
    def slo_class(self) -> str:
        return self.req.slo_class

    def _push(self, tokens, finished: bool) -> None:
        self._pending.extend(tokens)
        self.finished = self.finished or finished
        self._wake()

    def _wake(self) -> None:
        if self._wakeup is not None:
            self._wakeup.set()

    def cancel(self) -> bool:
        return self._frontend.cancel(self.rid)

    # ------------------------------------------------------------- sync
    def __iter__(self) -> "TokenStream":
        return self

    def __next__(self) -> int:
        while True:
            if self._pending:
                return self._pending.popleft()
            if self.finished or self.cancelled:
                raise StopIteration
            # a pump may deliver this stream's last tokens AND leave the
            # front-end idle — re-check the buffer before calling idle
            # starvation
            if not self._frontend.pump() and not self._pending \
                    and not self.finished and not self.cancelled:
                raise RuntimeError(
                    f"stream {self.rid} starved: front-end idle but the "
                    "stream is neither finished nor cancelled")

    # ------------------------------------------------------------ async
    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        while True:
            if self._pending:
                return self._pending.popleft()
            if self.finished or self.cancelled:
                raise StopAsyncIteration
            if self._wakeup is None:
                self._wakeup = asyncio.Event()
            self._wakeup.clear()
            await self._wakeup.wait()


@expose_counters("n_slo_preemptions", "n_cancelled", "n_shed")
class ServeFrontend:
    def __init__(self, backend: ServeBackend, *,
                 tenants: Optional[Dict[str, TenantPolicy]] = None,
                 slo_aware: bool = True,
                 realtime: bool = False,
                 telemetry: Optional[Telemetry] = None):
        self.backend = backend
        self.slo_aware = slo_aware
        self.realtime = realtime
        self._t0 = time.perf_counter()
        self._now = 0.0
        self.policies: Dict[str, TenantPolicy] = {}
        for name, pol in (tenants or {}).items():
            self.set_policy(name, pol)
        # (tenant, slo_class) -> FIFO of queued (undispatched) requests
        self._queues: Dict[Tuple[str, str], deque] = {}
        self._vt: Dict[Tuple[str, str], float] = {}    # WFQ virtual time
        self._vclock: Dict[str, float] = {c: 0.0 for c in SLO_CLASSES}
        self._bucket: Dict[str, float] = {}            # rate-limit credit
        self._bucket_t: Dict[str, float] = {}
        self._streams: Dict[int, TokenStream] = {}     # live streams
        self._inflight: Dict[int, TokenStream] = {}    # dispatched subset
        self._charged: set = set()       # rids already billed (vt + rate)
        self._next_rid = 0
        self._closed = False
        self.completed: List[Request] = []
        # counters live in the backend's shared MetricsRegistry —
        # legacy names (frontend.n_cancelled, ...) are read-only
        # properties via @expose_counters; per-tenant token counts are
        # labelled counters with a dict-compatibility property below.
        # Explicit IS-NOT-None (a Telemetry with tracing off is falsy).
        if telemetry is None:
            telemetry = getattr(backend, "tel", None)
        self.tel = telemetry if telemetry is not None else Telemetry()
        self.uid = next_uid("f")
        self._c = {n: self.tel.registry.counter(
            n, component="frontend", replica=self.uid)
            for n in ("n_slo_preemptions", "n_cancelled", "n_shed")}
        self._tt: Dict[str, Counter] = {}

    @property
    def tenant_tokens(self) -> Dict[str, int]:
        """Confirmed tokens streamed per tenant (compatibility view of
        the registry's labelled ``tenant_tokens`` counters)."""
        return {t: c.value for t, c in self._tt.items()}

    # ------------------------------------------------------------ clock
    @property
    def clock(self) -> float:
        """Current front-end time: wall seconds (realtime) or pump
        steps (deterministic)."""
        return (time.perf_counter() - self._t0 if self.realtime
                else self._now)

    # ---------------------------------------------------------- tenants
    def set_policy(self, tenant: str, policy: TenantPolicy) -> None:
        self.policies[tenant] = policy

    def policy(self, tenant: str) -> TenantPolicy:
        return self.policies.setdefault(tenant, TenantPolicy())

    # ----------------------------------------------------------- submit
    def submit(self, prompt, max_new_tokens: int, *,
               tenant: str = "default", slo_class: str = "batch",
               rid: Optional[int] = None) -> TokenStream:
        """Queue a request; returns its ``TokenStream`` immediately.
        Raises ValueError for a request no backend could ever admit
        (fail fast — the caller's stream would otherwise starve)."""
        if rid is None:
            while self._next_rid in self._streams:
                self._next_rid += 1
            rid = self._next_rid
            self._next_rid += 1
        req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=int(max_new_tokens),
                      arrival=self.clock, tenant=tenant,
                      slo_class=slo_class)
        return self.submit_request(req)

    def submit_request(self, req: Request) -> TokenStream:
        """Low-level submit of a pre-built ``Request`` (rid must be
        unique among live streams)."""
        if req.slo_class not in SLO_CLASSES:
            raise ValueError(f"unknown slo_class {req.slo_class!r}; "
                             f"choose from {SLO_CLASSES}")
        if req.rid in self._streams:
            raise ValueError(f"rid {req.rid} already has a live stream")
        # graceful degradation: while the backend reports lost
        # capacity, refuse batch-class work at the door with a typed
        # rejection rather than queueing unboundedly — interactive
        # traffic keeps flowing on the survivors
        if req.slo_class == "batch" \
                and getattr(self.backend, "degraded", False):
            self._c["n_shed"].inc()
            if self.tel:
                self.tel.event(req, "shed", t=self.clock,
                               tenant=req.tenant)
            raise ShedRejection(req)
        self.backend.check_admissible(req)
        self.policy(req.tenant)              # materialize + validate
        stream = TokenStream(self, req)
        self._streams[req.rid] = stream
        self._enqueue(req, front=False)
        if self.tel:
            # the true submission instant — queue delay (admitted - t)
            # includes front-end WFQ/rate-limit/SLO queueing
            self.tel.request_submitted(req, t=self.clock)
        return stream

    def _class_of(self, req: Request) -> str:
        # slo-blind mode files everything as batch: the measured
        # baseline for the SLO benchmark (the request keeps its label)
        return req.slo_class if self.slo_aware else "batch"

    def _enqueue(self, req: Request, front: bool) -> None:
        key = (req.tenant, self._class_of(req))
        q = self._queues.setdefault(key, deque())
        if not q:
            # a tenant idle in this class re-joins at the current
            # virtual clock: idleness earns no credit against
            # continuously-backlogged tenants
            self._vt[key] = max(self._vt.get(key, 0.0),
                                self._vclock[key[1]])
        if front:
            q.appendleft(req)
        else:
            q.append(req)

    # ----------------------------------------------------------- cancel
    def cancel(self, rid: int) -> bool:
        """Drop a live stream mid-flight: remove the request from the
        front-end queue or extract it from the backend (pages freed via
        the preemption machinery; trie donations stay resident for
        future sharers).  True if the rid was live."""
        stream = self._streams.pop(rid, None)
        if stream is None:
            return False
        for q in self._queues.values():
            for i, r in enumerate(q):
                if r.rid == rid:
                    del q[i]
                    break
            else:
                continue
            break
        else:
            self.backend.extract(rid)
        self._inflight.pop(rid, None)
        self._charged.discard(rid)
        stream.cancelled = True
        stream._wake()
        self._c["n_cancelled"].inc()
        if self.tel:
            self.tel.event(stream.req, "cancelled", t=self.clock)
        return True

    # --------------------------------------------------------- dispatch
    @staticmethod
    def _cost(req: Request) -> float:
        return float(len(req.prompt) + req.max_new_tokens)

    def _refill(self, now: float) -> None:
        for tenant, pol in self.policies.items():
            if pol.rate is None:
                continue
            cap = pol.burst if pol.burst is not None else pol.rate
            last = self._bucket_t.get(tenant)
            if last is None:
                self._bucket[tenant] = cap
            else:
                self._bucket[tenant] = min(
                    cap, self._bucket[tenant] + pol.rate * (now - last))
            self._bucket_t[tenant] = now

    def _affordable(self, tenant: str) -> bool:
        pol = self.policies[tenant]
        return pol.rate is None or self._bucket.get(tenant, 0.0) >= 0.0

    def _pick(self, slo: str) -> Optional[Tuple[str, str]]:
        """Lowest-virtual-time backlogged, rate-affordable tenant in
        ``slo``; ties break on tenant name (deterministic)."""
        best = None
        for key, q in self._queues.items():
            if key[1] != slo or not q or not self._affordable(key[0]):
                continue
            if best is None or (self._vt[key], key[0]) < best[0]:
                best = ((self._vt[key], key[0]), key)
        return best[1] if best else None

    def _send(self, key: Tuple[str, str]) -> None:
        tenant, slo = key
        req = self._queues[key].popleft()
        if req.rid not in self._charged:
            # bill once: a request re-queued by SLO preemption was
            # already paid for, so resumption is charge-free
            self._charged.add(req.rid)
            pol = self.policies[tenant]
            self._vclock[slo] = max(self._vclock[slo], self._vt[key])
            self._vt[key] += self._cost(req) / pol.weight
            if pol.rate is not None:
                self._bucket[tenant] = (self._bucket.get(tenant, 0.0)
                                        - self._cost(req))
        self.backend.submit(req)
        self._inflight[req.rid] = self._streams[req.rid]

    def _preempt_victim(self) -> Optional[TokenStream]:
        """Cheapest-to-replay in-flight batch-class stream (fewest
        confirmed tokens; ties on rid for determinism)."""
        victims = [s for s in self._inflight.values()
                   if s.req.slo_class == "batch"]
        if not victims:
            return None
        return min(victims, key=lambda s: (len(s.req.generated), s.rid))

    def _dispatch(self, now: float) -> None:
        while self.backend.n_inflight < self.backend.capacity:
            key = self._pick("interactive") or self._pick("batch")
            if key is None:
                break
            self._send(key)
        if not self.slo_aware:
            return
        # slots exhausted: interactive arrivals evict batch-class work.
        # Each round preempts exactly one victim for one interactive
        # request, so the loop is bounded by the interactive backlog.
        while True:
            key = self._pick("interactive")
            if key is None:
                break
            victim = self._preempt_victim()
            if victim is None:
                break                # everything running is interactive
            extracted = self.backend.extract(victim.rid)
            assert extracted is victim.req, (victim.rid, extracted)
            self._inflight.pop(victim.rid)
            victim.req.n_preemptions += 1
            self._c["n_slo_preemptions"].inc()
            if self.tel:
                self.tel.event(victim.req, "preempted", t=self._now,
                               source="slo",
                               n_generated=len(victim.req.generated))
            self._enqueue(victim.req, front=True)
            self._send(key)

    # ------------------------------------------------------------- pump
    def pump(self, now: Optional[float] = None) -> bool:
        """One front-end iteration: advance the clock, refill rate
        buckets, dispatch (WFQ + SLO preemption), run one backend step,
        route confirmed-token events to their streams.  Returns True
        while anything is queued or in flight."""
        if now is None:
            now = (time.perf_counter() - self._t0 if self.realtime
                   else self._now + 1.0)
        self._now = max(self._now, float(now))
        self._refill(self._now)
        self._dispatch(self._now)
        if self.backend.n_inflight:
            self.backend.step(self._now)
            for ev in self.backend.drain_events():
                self._route(ev)
        return self.busy

    def _route(self, ev: StreamEvent) -> None:
        stream = self._streams.get(ev.rid)
        if stream is None:
            return                   # submitted around the front-end
        if ev.tokens:
            t = stream.req.tenant
            c = self._tt.get(t)
            if c is None:
                c = self._tt[t] = self.tel.registry.counter(
                    "tenant_tokens", component="frontend",
                    replica=self.uid, tenant=t)
            c.inc(len(ev.tokens))
        stream._push(ev.tokens, ev.finished)
        if ev.finished:
            self._streams.pop(ev.rid, None)
            self._inflight.pop(ev.rid, None)
            self._charged.discard(ev.rid)
            self.completed.append(stream.req)

    @property
    def busy(self) -> bool:
        return bool(self._inflight or self.backend.n_inflight
                    or any(self._queues.values()))

    def drain(self) -> None:
        """Pump until idle (sync convenience; streams buffer)."""
        while self.pump():
            pass

    # ------------------------------------------------------------ async
    async def serve(self, idle_wait: float = 0.001):
        """Pump task for asyncio consumers: run until ``close()``.
        Backend steps execute inline (they hold the loop while a
        program runs — per-step granularity is the design point), and
        idle polls sleep so submitters can run."""
        while not self._closed:
            if not self.pump():
                await asyncio.sleep(idle_wait)
            else:
                await asyncio.sleep(0)

    def close(self) -> None:
        self._closed = True

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, float]:
        """Front-end counters (backend counters via
        ``backend.stats()``)."""
        return {
            "n_queued": float(sum(len(q) for q in self._queues.values())),
            "n_inflight": float(len(self._inflight)),
            "n_completed": float(len(self.completed)),
            "n_cancelled": float(self.n_cancelled),
            "n_slo_preemptions": float(self.n_slo_preemptions),
            "n_shed": float(self.n_shed),
            **{f"tenant_tokens[{t}]": float(n)
               for t, n in sorted(self.tenant_tokens.items())},
        }
