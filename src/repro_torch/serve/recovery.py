"""Journal-based crash recovery: the router-side request mirror (the
port's copy of ``repro.serve.recovery``).

A graceful drain rescues a replica's requests by *asking* it —
``extract_all`` returns each request at its confirmed-token frontier.
A crashed replica answers nothing (``serve/faults.py`` models this:
``extract`` raises), so everything needed to rebuild its requests must
already live on the router side.  That is the ``RequestJournal``:

* **assign** — when the router dispatches a request to a replica, the
  journal records the request object and which replica holds it.  The
  ``Request`` itself carries the durable inputs (prompt, budget,
  arrival, tenant, SLO class, trace).
* **observe** — the router drains every replica's stream events each
  step; the journal counts confirmed tokens per request as they flow
  past.  A token the router has *seen* is a token the client will get
  (it sits in router memory from that instant), so the journal's
  ``confirmed`` frontier is exactly the delivered-stream length.
  Finished/cancelled requests leave the journal.
* **lost** — on failure detection the journal surrenders the dead
  replica's entries.  Reconstruction truncates each request's
  ``generated`` to the journal frontier (tokens generated but never
  drained died with the process — greedy decoding re-derives them
  identically) and resets ingestion progress; re-admission on a
  survivor then rides the normal recompute-replay path, which is
  token-exact by construction.  Because the router drains events
  every step, the frontier in practice equals the full confirmed
  stream at the instant of death — nothing the client saw is ever
  re-sent, nothing it didn't see is ever skipped.

The journal is pure router-side bookkeeping: dict operations per
dispatch/event, no model work, and no effect on any dispatch decision
— an untouched (fault-free) run is bitwise- and dispatch-identical
with or without it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["JournalEntry", "RequestJournal"]


@dataclasses.dataclass
class JournalEntry:
    """One inflight request's mirror: where it is and how much of its
    stream the router has seen."""
    req: object                       # the live Request object
    replica: Optional[int]            # stable router id; None = queued
    confirmed: int = 0                # tokens drained past the router


class RequestJournal:
    def __init__(self) -> None:
        self._entries: Dict[int, JournalEntry] = {}   # rid -> entry

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, rid: int) -> bool:
        return rid in self._entries

    def entry(self, rid: int) -> Optional[JournalEntry]:
        return self._entries.get(rid)

    # --------------------------------------------------------- tracking
    def assign(self, req, replica: int) -> None:
        """Record (or re-record) a dispatch: ``req`` now lives on
        ``replica``.  The confirmed frontier persists across
        re-assignment — a migrated or recovered request keeps the
        stream it already delivered."""
        e = self._entries.get(req.rid)
        if e is None:
            self._entries[req.rid] = JournalEntry(
                req, replica, confirmed=len(req.generated))
        else:
            e.replica = replica

    def unassign(self, rid: int) -> None:
        """The request left its replica but stays live (migration /
        recovery re-queue): keep the frontier, drop the location."""
        e = self._entries.get(rid)
        if e is not None:
            e.replica = None

    def observe(self, events: Iterable) -> None:
        """Advance frontiers from drained ``StreamEvent``s; terminal
        events retire their entries (a finished stream needs no
        recovery, and its rid may be reused by a caller)."""
        for ev in events:
            e = self._entries.get(ev.rid)
            if e is None:
                continue
            e.confirmed += len(ev.tokens)
            if ev.finished:
                del self._entries[ev.rid]

    def discard(self, rid: int) -> None:
        """Forget a request (cancel / extract-by-caller): it no longer
        needs crash protection.  Idempotent."""
        self._entries.pop(rid, None)

    # --------------------------------------------------------- recovery
    def lost(self, replica: int) -> List[JournalEntry]:
        """Surrender every entry assigned to ``replica`` (it died):
        the entries leave the journal and are returned oldest-first
        (arrival, rid) for head-of-queue re-admission.  The caller
        re-``assign``s each survivor at its next dispatch."""
        hit = [e for e in self._entries.values()
               if e.replica == replica]
        for e in hit:
            del self._entries[e.req.rid]
        hit.sort(key=lambda e: (e.req.arrival, e.req.rid))
        return hit

    @staticmethod
    def reconstruct(entry: JournalEntry) -> Tuple[object, int]:
        """Rebuild a lost request for re-admission: truncate its
        stream to the journal-confirmed frontier (tokens beyond it
        never left the dead process; deterministic decode re-derives
        them bit-for-bit) and reset ingestion progress so prefill
        restarts from the prompt.  Returns ``(request,
        replay_burden)`` where the burden is the decode steps a
        survivor will spend replaying the confirmed stream."""
        req = entry.req
        del req.generated[entry.confirmed:]
        req.prefill_pos = 0
        return req, max(0, entry.confirmed - 1)
