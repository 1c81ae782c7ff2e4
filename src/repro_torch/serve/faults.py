"""Seeded, deterministic fault injection for the serve stack (the
port's copy of ``repro.serve.faults``).

A real fleet loses replicas: a process OOMs mid-step, a host wedges
and stops making progress, a network partition makes a replica
unreachable.  The serve stack's synthetic step clock lets us model all
of that *deterministically*: a fault is a scripted event keyed to a
replica's own step count, so a crash trace replays bit-for-bit from
its seed — the chaos analog of the stack's bitwise-exactness bar.

``FaultInjector`` wraps any ``ServeBackend`` (a bare engine, or each
replica inside a ``RequestRouter``) and proxies the full protocol.
Two fault shapes, mirroring how processes actually die:

* **crash** — at the scripted step, ``step()`` raises
  :class:`ReplicaFailure` and the replica is *permanently dead*: every
  subsequent call that would need the process — ``step``, ``submit``,
  ``extract``, ``extract_all``, ``cancel``, ``drain_events`` — raises
  too.  In particular the router canNOT rescue inflight requests via
  the graceful-drain path (``extract_all``); recovery must come from
  router-side state (serve/recovery.py's ``RequestJournal``).
  ``stats()`` stays readable — counters are the analog of externally
  scraped metrics, which survive the process they describe — so the
  router can fold the dead replica's dispatch history into its
  departed-stats accumulator and keep the fleet identities exact.
* **stall** — for N scripted rounds ``step()`` does nothing and
  reports busy: the replica is alive but makes no progress (a wedged
  host).  A stall shorter than the router's watchdog patience heals
  invisibly; a longer one gets the replica declared FAILED, which
  this wrapper then makes permanent (``mark_dead`` — once the router
  gives up on a replica, a late revival must not double-serve its
  requests).

Schedules come either from an explicit script (``crash_at=`` /
``stall_at=`` + ``stall_for=``) or from a seed
(:meth:`FaultInjector.seeded`), which draws the script from
``random.Random(seed)`` — replayable chaos for the fuzzer and the
fault benchmark.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

__all__ = ["ReplicaFailure", "FaultInjector", "parse_fault_spec"]


class ReplicaFailure(RuntimeError):
    """A replica died (or was declared dead): the wrapped backend is
    unresponsive and nothing can be extracted from it."""

    def __init__(self, uid: str, kind: str, msg: str = ""):
        self.uid = uid
        self.kind = kind                    # "crash" | "stall" | "dead"
        super().__init__(msg or f"replica {uid} {kind}")


class FaultInjector:
    """A ``ServeBackend`` proxy with a scripted fault schedule.

    The schedule is keyed to THIS wrapper's step count (the number of
    times ``step()`` has been called), not the global clock — a
    replica that joins late crashes the same number of steps into its
    own life regardless of when it joined, which keeps seeded traces
    stable under elastic churn.

    Attribute reads not named here (``cache``, ``waiting``, ``active``,
    ``max_batch``, ``uid``, ``tel``, ``finished``, ...) proxy to the
    wrapped backend: the router introspects replicas for affinity and
    load scoring, and that must keep working up to the instant of
    death (after which the router drops the replica anyway).
    """

    def __init__(self, backend, *, crash_at: Optional[int] = None,
                 stall_at: Optional[int] = None, stall_for: int = 0):
        if stall_for < 0:
            raise ValueError("stall_for must be >= 0")
        if stall_for and stall_at is None:
            raise ValueError("stall_for without stall_at")
        self._backend = backend
        self.crash_at = crash_at
        self.stall_at = stall_at
        self.stall_for = int(stall_for)
        self.n_steps = 0                    # step() calls on this wrapper
        self.dead = False
        self.fault_kind: Optional[str] = None

    # ------------------------------------------------------ construction
    @classmethod
    def seeded(cls, backend, seed: int, *, horizon: int = 64,
               p_crash: float = 0.5, min_stall: int = 4,
               max_stall: int = 12) -> "FaultInjector":
        """Draw one fault from ``random.Random(seed)``: a crash or a
        stall (probability ``p_crash`` of crashing) at a uniform step
        in ``[1, horizon]``.  Same seed -> same schedule, always."""
        rng = random.Random(seed)
        at = rng.randint(1, max(1, horizon))
        if rng.random() < p_crash:
            return cls(backend, crash_at=at)
        return cls(backend, stall_at=at,
                   stall_for=rng.randint(min_stall, max_stall))

    # ------------------------------------------------------------- kill
    def mark_dead(self, kind: str = "dead") -> None:
        """Point of no return: the router (or a test) declares this
        replica failed.  Idempotent; from here every protocol call
        raises ``ReplicaFailure``."""
        if not self.dead:
            self.dead = True
            self.fault_kind = self.fault_kind or kind

    def _alive(self) -> None:
        if self.dead:
            raise ReplicaFailure(self.uid, self.fault_kind or "dead")

    @property
    def stalled(self) -> bool:
        """True while inside the scripted stall window."""
        return (not self.dead and self.stall_at is not None
                and self.stall_at <= self.n_steps
                < self.stall_at + self.stall_for)

    # ---------------------------------------------------- ServeBackend
    def step(self, now: float = float("inf")) -> bool:
        self._alive()
        self.n_steps += 1
        if self.crash_at is not None and self.n_steps >= self.crash_at:
            self.dead = True
            self.fault_kind = "crash"
            raise ReplicaFailure(self.uid, "crash")
        if self.stalled:
            # wedged: no dispatch, no events, no progress — but the
            # process answers, so report busy while holding work
            return bool(self._backend.n_inflight)
        return self._backend.step(now)

    def submit(self, req) -> None:
        self._alive()
        self._backend.submit(req)

    def check_admissible(self, req) -> None:
        self._alive()
        self._backend.check_admissible(req)

    def drain_events(self):
        self._alive()
        return self._backend.drain_events()

    def extract(self, rid: int):
        self._alive()
        return self._backend.extract(rid)

    def extract_all(self):
        self._alive()
        return self._backend.extract_all()

    def cancel(self, rid: int) -> bool:
        self._alive()
        return self._backend.cancel(rid)

    def run(self, requests, **kw):
        # run() drives step() in a loop, so scripted faults fire the
        # same way; a crash propagates to the caller as it should
        self._alive()
        for r in requests:
            self.submit(r)
        while self.step():
            pass
        return list(self._backend.finished)

    def stats(self) -> Dict[str, float]:
        # deliberately NOT gated on _alive(): counters describe work
        # already done and survive the process (externally scraped),
        # and the router's crash-fold depends on reading them
        return self._backend.stats()

    @property
    def n_inflight(self) -> int:
        # readable after death: the router's failure handler needs to
        # know the dead replica held work (the requests themselves are
        # unreachable — that is what the journal is for)
        return self._backend.n_inflight

    @property
    def capacity(self) -> int:
        return self._backend.capacity

    # ------------------------------------------------------------ proxy
    def __getattr__(self, name):
        # everything else (cache, waiting, prefilling, active,
        # max_batch, uid, tel, finished, events, ...) reads through
        return getattr(self._backend, name)


def parse_fault_spec(spec: str) -> List[Tuple[int, Dict[str, int]]]:
    """Parse a CLI fault script: ``"0:crash@12,1:stall@8x5"`` ->
    ``[(0, {"crash_at": 12}), (1, {"stall_at": 8, "stall_for": 5})]``.
    Each segment is ``<replica_index>:<kind>@<step>[x<rounds>]``;
    ``rounds`` applies to stalls only.  Empty spec -> []."""
    out: List[Tuple[int, Dict[str, int]]] = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        idx, _, rest = part.partition(":")
        kind, _, when = rest.partition("@")
        if not (idx and kind and when):
            raise ValueError(f"bad fault segment {part!r}; want "
                             "'<replica>:<crash|stall>@<step>[x<n>]'")
        if kind == "crash":
            out.append((int(idx), {"crash_at": int(when)}))
        elif kind == "stall":
            at, _, dur = when.partition("x")
            out.append((int(idx), {"stall_at": int(at),
                                   "stall_for": int(dur or 4)}))
        else:
            raise ValueError(f"unknown fault kind {kind!r} in {part!r}")
    return out
