"""The serving-surface contract: one ``ServeBackend`` protocol that a
single ``ServeEngine`` and a multi-replica ``RequestRouter`` both
implement, so every layer above them — the batch ``run`` loop, the
async streaming front-end (serve/frontend.py), benchmarks — drives
either one interchangeably.

The protocol is the submit/step/run/stats surface the two grew in
parallel, made identical on purpose:

* ``submit(req)`` / ``check_admissible(req)`` — queue a request; fail
  fast (ValueError) on one that could never be admitted.
* ``step(now)`` — one scheduling iteration; returns True while work
  remains.  ``now`` gates arrival replay and stamps TTFT/finish times;
  step-driven callers may feed a synthetic clock (a step counter) to
  get machine-independent latency units.
* ``drain_events()`` — the streaming face: every call returns the
  ``StreamEvent``s confirmed since the last call, in confirmation
  order.  Tokens appear exactly once, in stream order, as soon as they
  are *confirmed* — one per decode step, a burst per accepted
  speculation round, and never retracted (preemption/replay re-derives
  KV, not tokens, so a confirmed token is final).
* ``extract(rid)`` / ``cancel(rid)`` — remove a request wherever it
  lives (queued, prefilling, decoding), freeing its slot and pages via
  the same machinery preemption uses.  ``extract`` returns the live
  ``Request`` with its confirmed tokens intact — re-submitting it
  later resumes the stream token-exactly (recompute-replay), which is
  what makes front-end SLO preemption free of correctness risk.
  ``cancel`` is extract-and-discard.
* ``run(requests, realtime=)`` — the offline batch loop (drive to
  completion, return finished requests).
* ``stats()`` — flat numeric counter dict; the router returns the
  field-wise sum over its replicas plus its own routing counters, so
  the two read identically at trend granularity.
* ``capacity`` / ``n_inflight`` — concurrently-servable request slots
  and current occupancy; a front-end that keeps
  ``n_inflight < capacity`` owns all queueing policy itself (the
  backend's internal queue stays empty except for its own
  page-pressure preemptions).

The port serves with one engine; the router, front-end and fault
layers that also implement this protocol in the reference are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Tuple, runtime_checkable

__all__ = ["ServeBackend", "StreamEvent"]


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """Tokens confirmed for one request by one backend step.

    ``tokens`` is the newly confirmed suffix of the request's stream
    (possibly empty on a pure finish event); ``finished`` marks the
    stream complete — no further events will carry this ``rid``.
    Concatenating every event's tokens for a rid reproduces
    ``Request.generated`` exactly.
    """
    rid: int
    tokens: Tuple[int, ...]
    finished: bool


@runtime_checkable
class ServeBackend(Protocol):
    """Structural type of a serving backend (engine or router)."""

    @property
    def capacity(self) -> int: ...

    @property
    def n_inflight(self) -> int: ...

    def check_admissible(self, req) -> None: ...

    def submit(self, req) -> None: ...

    def step(self, now: float = float("inf")) -> bool: ...

    def drain_events(self) -> List[StreamEvent]: ...

    def extract(self, rid: int): ...

    def cancel(self, rid: int) -> bool: ...

    def run(self, requests, *, realtime: bool = False) -> List: ...

    def stats(self) -> Dict[str, float]: ...
