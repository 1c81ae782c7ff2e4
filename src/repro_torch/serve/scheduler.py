"""Continuous-batching request scheduler over the paged KV cache.

The port's copy of ``repro.serve.scheduler``: the same host-side
scheduler, driving the port's paged programs (fixed batch/page shapes)
over an ever-changing population of requests.  The request lifecycle is

    submit -> WAITING -> [admit] -> PREFILLING -> DECODING -> finished
                  ^                                ^  |
                  |                     (verify    |  |
                  |                      round) VERIFYING
                  +--------- preempt (replay) --------+

* **Admission** claims a batch slot and pages; a prompt prefix already
  resident in the cache's prefix trie is attached read-only
  (copy-on-write protects it) and skipped by prefill.
* **Batched chunked prefill**: prompts ingest through a fixed-shape
  ``(prefill_batch, chunk_size)`` masked-prefill program — up to
  ``prefill_batch`` PREFILLING requests advance one chunk each *per
  dispatch* (per-row page tables / starts / valid counts; inactive
  rows routed to the null page), so a burst of short prompts pays one
  program launch instead of one per prompt.  PREFILLING is a set
  drained together, not a serialized queue; prompts longer than one
  chunk advance one chunk per engine step, interleaved with the
  batched decode step — in-flight decode never stalls for more than
  one chunk of prefill work — while short prompts admit, ingest, and
  promote eagerly so the batch ramps at full speed.  One admission
  ordering rule survives from the serialized path: a prompt that could
  share prefix pages with a prompt still mid-ingest waits for that
  prompt's trie registration (``_defers_for_sharing``) — co-ingesting
  it would silently forfeit the donation, and with it the in-burst
  sharing the serialized path guaranteed.  The program's gathered
  context length is bucketed (``bucket_edges``, in pages), as in the
  reference, where each bucket is one compile.
* **Preemption**: when the allocator runs dry the engine first evicts
  LRU prefix-trie pages, then the youngest request — its pages are
  dropped and it re-queues for recompute-readmission (its own prompt
  usually re-shares from the trie), and its already-generated tokens
  are replayed through the same decode program, reproducing the
  original stream exactly.  The engine never deadlocks and older
  requests always finish.
* **Speculative decode** (``spec_k`` > 0): instead of one token per
  batched decode step, every DECODING slot enters a VERIFYING round —
  a drafter (serve/spec.py) guesses up to ``spec_k`` tokens, the
  target model scores all ``k+1`` positions in one batched
  ``verify_step_paged`` program, and the longest matching draft prefix
  plus the verifier's bonus token are banked.  Rows with no draft
  degrade to exactly a decode step, so the verify program *replaces*
  the decode program rather than running beside it.  Headroom for the
  whole write window is privatized before the program runs and pages
  past the confirmed frontier are rolled back after it
  (kv_cache.ensure_headroom / rollback_spec), so speculation composes
  with chunked prefill, prefix sharing/COW, and preemption without new
  aliasing states.
* **Fused steady-state step** (``fused=True``, the default): a step
  with both PREFILLING and DECODING work launches ONE uber-program
  (``models/lm.fused_step_paged``) covering the chunk ingestion *and*
  the decode/verify round, instead of two back-to-back dispatches.
  Page write/read disjointness (prefill rows touch only their own
  private pages, decode rows only headroom-privatized ones) makes the
  merge bitwise; rows promoted out of a fused dispatch join the decode
  batch on the *next* step, which shifts step boundaries but never
  token values.  Degenerate mixes — prefill-only ramp, decode-only
  tail — take the standalone programs either way, so ``fused=False``
  reproduces the two-dispatch engine dispatch-for-dispatch.

Every step keeps the token-parity guarantee: generated streams are
bit-identical to the sequential ``greedy_generate`` oracle, with or
without speculation (the reference's docs/serving.md and
docs/speculative.md say what would break it).

The engine is one implementation of the ``ServeBackend`` protocol
(serve/backend.py).  Streaming
callers consume per-step confirmed-token events (``drain_events``) and
may ``extract``/``cancel`` a request mid-stream — both ride the
preempt/free machinery above, so they compose with everything else.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .backend import StreamEvent
from .kv_cache import PagedKVCache
from .parallel import TPServePrograms
from .spec import PromptLookupDrafter
from .step import ServePrograms
from .telemetry import (SpanEvent, Telemetry, expose_counters,
                        merge_stats, next_uid)

__all__ = ["Request", "ServeEngine", "SLO_CLASSES", "default_bucket_edges"]

SLO_CLASSES = ("interactive", "batch")


def default_bucket_edges(max_pages_per_seq: int) -> List[int]:
    """Doubling context buckets (in pages): 1, 2, 4, ... capped at the
    per-request page budget."""
    edges, e = [], 1
    while e < max_pages_per_seq:
        edges.append(e)
        e *= 2
    edges.append(max_pages_per_seq)
    return edges


def _host(t) -> np.ndarray:
    """A program's token output as a host array (waits for the device).
    Read at once: a CUDA graph's output holds until the next replay of
    its key (serve/compiled.py)."""
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                    # (S,) int32
    max_new_tokens: int
    arrival: float = 0.0
    # multi-tenant front-end metadata (the reference's
    # serve/frontend.py); the engine itself is policy-free and never
    # reads these
    tenant: str = "default"
    slo_class: str = "batch"              # "interactive" | "batch"
    # engine-filled
    generated: List[int] = dataclasses.field(default_factory=list)
    ttft: Optional[float] = None          # first token latency (s)
    finish_time: Optional[float] = None
    n_preemptions: int = 0
    prefill_pos: int = 0                  # prompt tokens ingested
    shared_tokens: int = 0                # prefix-cache hit size
    # lifecycle span (serve/telemetry.py) — empty unless the serving
    # stack was built with tracing on; survives migration because the
    # events ride the Request object itself
    trace: List[SpanEvent] = dataclasses.field(default_factory=list)

    @property
    def finished(self) -> bool:
        return self.finish_time is not None


_ENGINE_COUNTERS = (
    "n_engine_steps", "n_decode_steps", "n_prefill_chunks",
    "n_prefill_dispatches", "n_replay_steps", "n_fused_dispatches",
    "n_total_dispatches", "n_spec_rounds", "n_drafted",
    "n_draft_accepted")


@expose_counters(*_ENGINE_COUNTERS)
class ServeEngine:
    def __init__(self, model, params, *, max_batch: int = 8,
                 n_pages: int = 128, page_size: int = 16,
                 max_pages_per_seq: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 chunk_size: int = 32,
                 prefill_batch: int = 1,
                 prefix_sharing: bool = True,
                 bucket_edges: Optional[Sequence[int]] = None,
                 spec_k: int = 0,
                 drafter=None,
                 fused: bool = True,
                 programs: Optional[ServePrograms] = None,
                 tp: int = 1,
                 mesh=None,
                 telemetry: Optional[Telemetry] = None):
        if not model.supports_paged_decode():
            raise ValueError(f"{model.cfg.name}: paged decode unsupported "
                             "(needs a scanned all-attention stack)")
        if max_pages_per_seq is None:
            # correct for any admissible request; size it from the
            # trace (kv_cache.pages_needed) when the wider page tables
            # cost too much gather bandwidth
            max_pages_per_seq = n_pages - 1
        # the serving programs are engine-independent (one bundle
        # shared by every engine built on the same model); tp > 1 or
        # ``mesh`` (the shard devices, by name) swaps in the
        # tensor-parallel bundle — the scheduler below cannot tell the
        # difference
        if programs is None:
            if tp > 1 or mesh is not None:
                programs = TPServePrograms(
                    model, tp=tp if tp > 1 else None, devices=mesh)
            else:
                programs = ServePrograms(model)
        elif programs.model is not model:
            raise ValueError("programs were built for a different model")
        self.programs = programs
        self.tp = programs.tp
        self.model = model
        self.params = programs.prepare_params(params)
        self.eos_id = eos_id
        self.cache = PagedKVCache(model, max_batch=max_batch,
                                  n_pages=n_pages, page_size=page_size,
                                  max_pages_per_seq=max_pages_per_seq,
                                  prefix_sharing=prefix_sharing)
        self.cache.k_pages = programs.prepare_pages(self.cache.k_pages)
        self.cache.v_pages = programs.prepare_pages(self.cache.v_pages)
        self.max_batch = max_batch
        self.chunk_size = chunk_size
        # rows per chunked-prefill dispatch (the program's batch dim).
        # 1 is the serialized path, dispatch for dispatch;
        # > 1 co-ingests a burst.  Token streams are bitwise identical
        # either way (see _dispatch_prefill).
        self.prefill_batch = max(1, min(int(prefill_batch), max_batch))
        if bucket_edges is None:
            bucket_edges = default_bucket_edges(max_pages_per_seq)
        self.bucket_edges = sorted(set(int(b) for b in bucket_edges))
        if self.bucket_edges[-1] < max_pages_per_seq:
            self.bucket_edges.append(max_pages_per_seq)
        # this engine's programs: on the card its own CUDA graphs,
        # captured at a key's first call (serve/compiled.py); eager
        # where the bundle runs eagerly (the CPU, graphs=False, tp)
        self.compiled = programs.for_engine()
        self._decode = self.compiled.decode
        self._chunk = self.compiled.chunk
        # speculative decode: drafts are advisory, the verify program
        # replaces the decode program for DECODING slots (spec_k == 0
        # keeps the plain one-token decode path)
        self.spec_k = int(spec_k)
        if self.spec_k > 0:
            self.drafter = drafter or PromptLookupDrafter()
            self._verify = self.compiled.verify
        else:
            self.drafter = None
            self._verify = None
        # fused uber-program: steady-state steps with both PREFILLING
        # and DECODING work launch ONE program instead of two (a
        # --no-fused engine never calls, so never captures, it).
        # Degenerate mixes — prefill-only ramp, decode-only tail — take
        # the standalone programs either way, so fusion off reproduces
        # the unfused engine dispatch-for-dispatch.
        self.fused = bool(fused)
        self._fused = self.compiled.fused
        self.waiting: deque[Request] = deque()
        self.prefilling: "OrderedDict[int, Request]" = OrderedDict()
        self.active: Dict[int, Request] = {}      # slot -> DECODING req
        # confirmed-token events since the last drain (streaming face;
        # see backend.StreamEvent).  run() clears them — the batch
        # loop's callers read finished Requests instead.
        self.events: deque[StreamEvent] = deque()
        self._admit_seq: Dict[int, int] = {}      # slot -> admission order
        self._admit_counter = 0
        self.finished: List[Request] = []
        # counters live in the shared MetricsRegistry (telemetry.py);
        # the legacy attribute names (engine.n_decode_steps, ...) are
        # read-only properties over them via @expose_counters, so every
        # existing consumer keeps working.  Of note:
        # * n_engine_steps — step() calls that found work;
        # * n_prefill_chunks / n_prefill_dispatches — per-row chunks
        #   ingested vs prefill program launches;
        # * dispatch accounting — n_total_dispatches counts EVERY
        #   program launch (prefill, decode/verify, replay, fused); a
        #   fused launch also increments the prefill + decode counters
        #   it subsumes, so fused-off arithmetic (total = prefill +
        #   decode + replay) loses exactly n_fused_dispatches when
        #   fusion is on — the identity MetricsRegistry.audit rechecks;
        # * speculation — accept rate = n_draft_accepted / n_drafted.
        self.tel = telemetry if telemetry is not None else Telemetry()
        self.uid = next_uid("e")
        self._c = {n: self.tel.registry.counter(
            n, component="engine", replica=self.uid)
            for n in _ENGINE_COUNTERS}
        self._now = 0.0              # last sanitized step clock
        self._last_decode_rows = 0   # rows in the last decode round

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host-built program input on the model's device."""
        return torch.as_tensor(a, device=self.model.device)

    # --------------------------------------------------------- frontend
    def check_admissible(self, req: Request) -> None:
        """Raise ValueError for a request this engine could never admit
        — otherwise it would spin on it forever.  The budget reserves
        alloc_slot's +1 decode-headroom page (a preempted request must
        be re-admittable at its longest).  Exposed separately from
        ``submit`` so a front-end can fail fast
        before choosing a replica."""
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt (there is "
                             "no last-token logit to seed generation)")
        need = self.cache.pages_for(len(req.prompt) + req.max_new_tokens)
        budget = min(self.cache.max_pages_per_seq, self.cache.n_pages - 2)
        if need > budget:
            raise ValueError(
                f"request {req.rid}: {len(req.prompt)}+{req.max_new_tokens}"
                f" tokens need {need} pages of {self.cache.page_size};"
                f" per-request page budget is {budget}")

    def submit(self, req: Request) -> None:
        """Queue a request (see ``check_admissible`` for rejection)."""
        self.check_admissible(req)
        self.waiting.append(req)
        if self.tel:
            self.tel.request_submitted(req, t=req.arrival)

    @property
    def n_inflight(self) -> int:
        return len(self.waiting) + len(self.prefilling) + len(self.active)

    @property
    def capacity(self) -> int:
        """Requests this backend can serve concurrently (batch slots).
        A front-end that keeps ``n_inflight < capacity`` retains all
        queueing policy itself."""
        return self.max_batch

    def drain_events(self) -> List[StreamEvent]:
        """Return (and clear) the confirmed-token events accumulated
        since the last drain, in confirmation order."""
        ev = list(self.events)
        self.events.clear()
        return ev

    def _emit(self, req: Request, tokens) -> None:
        if tokens or req.finished:
            self.events.append(StreamEvent(req.rid, tuple(tokens),
                                           req.finished))

    def extract(self, rid: int) -> Optional[Request]:
        """Remove the request wherever it lives — queued, prefilling or
        decoding — freeing its slot and pages through the same path
        preemption uses, and return it with confirmed tokens intact.
        Re-submitting the returned request later resumes its stream
        token-exactly (recompute-replay), so a front-end can preempt a
        batch-class request for an interactive one without correctness
        risk.  Returns None if the rid is not here (finished requests
        are not extractable — their stream is complete)."""
        for i, r in enumerate(self.waiting):
            if r.rid == rid:
                del self.waiting[i]
                return r
        for slot, r in list(self.prefilling.items()) \
                + list(self.active.items()):
            if r.rid == rid:
                return self._evict_slot(slot)
        return None

    def extract_all(self) -> List[Request]:
        """Remove EVERY live request — admitted slots in admission
        order, then the waiting queue — freeing all slots and pages;
        the bulk form of ``extract``, used by a draining replica to
        hand its whole population to another backend.  Each returned
        request carries its confirmed tokens; re-submission elsewhere
        resumes each stream token-exactly, and pages the prompts
        donated to this engine's trie stay resident until the engine
        itself is retired."""
        out: List[Request] = []
        for slot in sorted(self._admit_seq, key=self._admit_seq.get):
            out.append(self._evict_slot(slot))
        out.extend(self.waiting)
        self.waiting.clear()
        return out

    def cancel(self, rid: int) -> bool:
        """Drop a request mid-stream: extract-and-discard.  Pages the
        request privately held return to the free list; pages its
        prompt donated to the prefix trie stay resident (a
        cancel-then-resubmit re-shares them).  Tokens already streamed
        were confirmed and stay valid.  True if the rid was live."""
        req = self.extract(rid)
        if req is not None and self.tel:
            self.tel.event(req, "cancelled", t=self._now)
        return req is not None

    # --------------------------------------------------------- internals
    def _free_slot_id(self) -> Optional[int]:
        for s in range(self.max_batch):
            if s not in self.active and s not in self.prefilling:
                return s
        return None

    def _finish(self, slot: int, now: float) -> None:
        req = self.active.pop(slot)
        self._admit_seq.pop(slot)
        self.cache.free_slot(slot)
        if self.drafter is not None:
            self.drafter.detach(slot)
        req.finish_time = now
        self.finished.append(req)
        if self.tel:
            self.tel.event(req, "finished", t=self._now,
                           n_generated=len(req.generated))

    def _evict_slot(self, slot: int) -> Request:
        """Release ``slot`` (prefilling or decoding): drop its page
        references, detach drafter state, reset ingestion progress.
        The request's confirmed tokens survive — re-admission replays
        them, reproducing the stream exactly.  Shared by preemption,
        ``extract`` and ``cancel``."""
        req = (self.prefilling.pop(slot, None)
               or self.active.pop(slot, None))
        self._admit_seq.pop(slot)
        self.cache.free_slot(slot)
        if self.drafter is not None:
            self.drafter.detach(slot)       # draft state is disposable
        req.prefill_pos = 0
        return req

    def _preempt_youngest(self, now: float,
                          exclude: Optional[int] = None) -> Optional[int]:
        """Evict the most recently admitted request (prefilling or
        decoding): drop its page references and push it to the front of
        the queue for recompute-readmission.  ``exclude`` protects one
        slot (the one being replayed) from evicting itself."""
        candidates = [s for s in self._admit_seq if s != exclude]
        if not candidates:
            return None
        slot = max(candidates, key=self._admit_seq.get)
        req = self._evict_slot(slot)
        req.n_preemptions += 1
        self.waiting.appendleft(req)
        if self.tel:
            self.tel.event(req, "preempted", t=self._now,
                           replica=self.uid, source="pages",
                           n_generated=len(req.generated))
        return slot

    def _defers_for_sharing(self, req: Request) -> bool:
        """True when ``req`` should wait for an in-flight prefill's trie
        registration instead of co-ingesting beside it — the
        admission-order prefix-registration invariant of the serialized
        path: each prompt donates its pages before the next admission's
        trie lookup, so a burst of same-system-prompt requests shares
        all but the first.  Co-ingesting a would-be sharer forfeits
        that donation.  Deferral holds only while the donor is
        PREFILLING (promotion registers, preemption re-queues), so it
        can never deadlock; and only when registration would serve
        strictly more than the trie already can (a read-only probe —
        observation must not protect pages from eviction)."""
        trie = self.cache.prefix
        if trie is None:
            return False
        prompt = req.prompt
        cap = len(prompt) - 1
        resident = min(trie.probe(prompt), cap)
        for other in self.prefilling.values():
            o = other.prompt
            m = min(len(prompt), len(o))
            neq = np.nonzero(prompt[:m] != o[:m])[0]
            lcp = int(neq[0]) if len(neq) else m
            if min(trie.servable_after_insert(lcp), cap) > resident:
                return True
        return False

    def _admit_burst(self, now: float) -> bool:
        """Admit arrived requests (FIFO) until the PREFILLING set holds
        ``prefill_batch`` rows, slots/pages run out, or the head of the
        queue must wait for an in-flight prompt's prefix registration.
        With ``prefill_batch == 1`` this degenerates to the serialized
        path's gate: admit only when no prefill is in flight."""
        admitted = False
        while (len(self.prefilling) < self.prefill_batch
               and self.waiting and self.waiting[0].arrival <= now):
            if self.prefilling and self._defers_for_sharing(self.waiting[0]):
                break
            if not self._admit_one():
                break
            admitted = True
        return admitted

    def _admit_one(self) -> bool:
        """Admit ``waiting[0]`` (caller checked arrival) into a free
        slot; all-or-nothing on pages."""
        slot = self._free_slot_id()
        if slot is None:
            return False
        req = self.waiting[0]
        shared = self.cache.alloc_slot(
            slot, len(req.prompt), prompt=req.prompt,
            reserve_tokens=len(req.generated))
        if shared is None:
            # make room from the prefix cache before giving up: release
            # up to the request's worst-case bill at once (a page per
            # node dribble would stall admission for many steps)
            need = self.cache.pages_for(
                len(req.prompt) + len(req.generated)) + 2
            if not self.cache.release_prefix_pages(need):
                return False
            shared = self.cache.alloc_slot(
                slot, len(req.prompt), prompt=req.prompt,
                reserve_tokens=len(req.generated))
            if shared is None:
                return False
        self.waiting.popleft()
        req.prefill_pos = shared
        req.shared_tokens = shared
        self.prefilling[slot] = req
        self._admit_seq[slot] = self._admit_counter
        self._admit_counter += 1
        if self.tel:
            self.tel.event(req, "admitted", t=self._now,
                           replica=self.uid, slot=slot,
                           shared_tokens=shared)
        return True

    def _bucket_pages(self, n_needed: int) -> int:
        for e in self.bucket_edges:
            if e >= n_needed:
                return e
        return self.bucket_edges[-1]

    def _run_prefill(self, now: float) -> None:
        """Advance every PREFILLING request one chunk in ONE program
        dispatch — the drained-set replacement for the serialized
        one-request chunk loop.  ``_admit_burst`` (the set's only
        producer) caps it at ``prefill_batch`` rows, so the whole set
        always fits one dispatch; dict insertion order is admission
        order (re-admissions insert fresh)."""
        self._dispatch_prefill(list(self.prefilling.items()), now)

    def _prefill_inputs(self, group):
        """Build one batched chunked-prefill dispatch's input arrays for
        ``group`` = [(slot, req), ...]: fixed-shape (Bp, C) tokens plus
        per-row starts / valid counts / bucketed page-table rows.
        Exactness: every row is exactly what the serialized path would
        have dispatched alone — same tokens, start, valid count, and
        page-table prefix (the shared context bucket only pads the
        gathered buffer with fully-masked lanes, exact no-ops) — and
        the program is row-independent, so each request's stream is
        bitwise identical to serialized ingestion regardless of
        co-tenants.  Returns (tokens, tables, starts, valids, metas)
        with metas = [(row, slot, req, valid), ...]."""
        Bp, Csz = self.prefill_batch, self.chunk_size
        assert len(group) <= Bp, (len(group), Bp)
        tokens = np.zeros((Bp, Csz), np.int32)
        starts = np.zeros((Bp,), np.int32)
        valids = np.zeros((Bp,), np.int32)
        metas, buckets, nb = [], [], 1
        for r, (slot, req) in enumerate(group):
            start = req.prefill_pos
            valid = min(Csz, len(req.prompt) - start)
            tokens[r, :valid] = req.prompt[start:start + valid]
            starts[r] = start
            valids[r] = valid
            own = self._bucket_pages(self.cache.pages_for(start + valid))
            nb = max(nb, own)
            buckets.append(own)
            metas.append((r, slot, req, valid))
        # inactive rows (group smaller than Bp) keep all-zero tables:
        # their writes land on the null page
        tables = np.zeros((Bp, nb), np.int32)
        for (r, slot, req, valid), own in zip(metas, buckets):
            tables[r, :own] = self.cache.page_tables[slot, :own]
        return tokens, tables, starts, valids, metas

    def _dispatch_prefill(self, group, now: float) -> None:
        """Ingest one chunk for each (slot, req) in ``group`` in ONE
        batched program dispatch; promote rows whose chunk completes
        their prompt (_prefill_inputs / _finish_prefill carry the
        exactness argument)."""
        tokens, tables, starts, valids, metas = \
            self._prefill_inputs(group)
        state = {"k_pages": self.cache.k_pages,
                 "v_pages": self.cache.v_pages}
        tok, state = self._chunk(self.params, state, self._dev(tokens),
                                 self._dev(tables), self._dev(starts),
                                 self._dev(valids))
        self.cache.k_pages = state["k_pages"]
        self.cache.v_pages = state["v_pages"]
        self._c["n_prefill_dispatches"].inc()
        self._c["n_prefill_chunks"].inc(len(metas))
        self._c["n_total_dispatches"].inc()
        self._finish_prefill(metas, _host(tok), now)

    def _finish_prefill(self, metas, tok, now: float) -> None:
        """Advance and promote the rows of a completed prefill dispatch
        (``tok``: the dispatch's (Bp, 1) next-token output, host-side).
        """
        # advance every row before any promotion: promotion may replay,
        # replay may preempt — and preemption resets the victim's
        # prefill_pos, which must already reflect this dispatch
        for _, slot, req, valid in metas:
            req.prefill_pos += valid
            self.cache.lengths[slot] = req.prefill_pos
            if self.tel:
                self.tel.event(req, "chunk_prefilled", t=self._now,
                               replica=self.uid, n_tokens=int(valid),
                               pos=req.prefill_pos)
        for r, slot, req, valid in metas:
            if slot not in self.prefilling \
                    or self.prefilling[slot] is not req:
                continue                 # preempted by an earlier
            if req.prefill_pos < len(req.prompt):
                continue                 # row's replay making room
            # prompt fully resident: donate it to the prefix trie, then
            # promote (replaying any pre-preemption generation).
            # Registration runs in admission order, and co-ingested
            # rows were admitted precisely because none could use
            # another's donation (_defers_for_sharing), so the
            # serialized path's registration-before-next-admission
            # sharing guarantee carries over.
            self.prefilling.pop(slot)
            self.cache.register_prefix(slot, req.prompt)
            self.active[slot] = req
            first_token = not req.generated
            if req.generated:
                # recompute-readmission after preemption: replay the
                # already-generated tokens through the *same* decode
                # program, reproducing the original token stream
                # exactly (re-prefilling prompt+generated instead would
                # cross the prompt/generation numerics boundary of the
                # oracle)
                self._replay(slot, req.generated[:-1], now)
                if self.tel:
                    self.tel.event(req, "replayed", t=self._now,
                                   replica=self.uid,
                                   n=len(req.generated) - 1)
            else:
                req.generated.append(int(tok[r, 0]))
            if self.tel:
                # a fresh first token is a new confirmation (n=1);
                # re-promotion after preemption confirms nothing new
                self.tel.event(req, "promoted", t=self._now,
                               replica=self.uid,
                               n=int(first_token))
            if req.ttft is None:
                req.ttft = now - req.arrival
                if req.ttft != float("inf"):
                    self.tel.registry.histogram(
                        "ttft", tenant=req.tenant,
                        slo=req.slo_class).observe(req.ttft)
            if self._done(req):
                self._finish(slot, now)
            # replay re-derives KV for tokens streamed before a
            # preemption; only a fresh first token is a new confirmation
            self._emit(req, req.generated[-1:] if first_token else [])

    def _replay(self, slot: int, tokens, now: float) -> None:
        """Write ``tokens`` into ``slot``'s pages via single-slot decode
        steps (all other rows masked to the null page).  The admission
        reserve is not pinned across the chunked-prefill window (other
        slots' decode growth can consume it), so replay makes room the
        same way the decode loop does — never by evicting itself."""
        for t in tokens:
            while not self.cache.ensure_headroom(slot):
                if not self._make_room(now, exclude=slot):
                    raise RuntimeError(
                        "single request exceeds total page budget")
            toks = np.zeros((self.max_batch, 1), np.int32)
            toks[slot, 0] = t
            tables = np.zeros_like(self.cache.page_tables)
            tables[slot] = self.cache.page_tables[slot]
            lengths = np.zeros_like(self.cache.lengths)
            lengths[slot] = self.cache.lengths[slot]
            state = {"k_pages": self.cache.k_pages,
                     "v_pages": self.cache.v_pages,
                     "page_tables": self._dev(tables),
                     "lengths": self._dev(lengths)}
            _, state = self._decode(self.params, state, self._dev(toks))
            self.cache.k_pages = state["k_pages"]
            self.cache.v_pages = state["v_pages"]
            self.cache.lengths[slot] += 1
            self._c["n_replay_steps"].inc()
            self._c["n_total_dispatches"].inc()

    def _done(self, req: Request) -> bool:
        return (len(req.generated) >= req.max_new_tokens
                or (self.eos_id is not None
                    and req.generated[-1] == self.eos_id))

    def _make_room(self, now: float,
                   exclude: Optional[int] = None) -> bool:
        """Free one page's worth of space: prefer dropping cached
        prefixes over evicting live requests."""
        if self.cache.release_prefix_pages(1):
            return True
        return self._preempt_youngest(now, exclude=exclude) is not None

    def _ensure_headroom_all(self, now: float, window) -> None:
        """Privatize/allocate every DECODING slot's write window before
        a batched program runs, making room (trie eviction, then
        youngest-preemption) on pressure; slots evicted mid-loop simply
        drop out of ``self.active``.  ``window`` maps slot -> tokens
        about to be written (missing slots default to 1)."""
        for slot in sorted(self.active):
            need = window.get(slot, 1)
            while slot in self.active and \
                    not self.cache.ensure_headroom(slot, need):
                if not self._make_room(now):
                    raise RuntimeError(
                        "single request exceeds total page budget")

    def _masked_state(self) -> dict:
        """Device state for a batched program with non-DECODING rows
        masked out: their rows carry the null page table and zero
        length, so lockstep writes land on page 0 instead of a page
        mid-ingest."""
        active_rows = np.zeros((self.max_batch,), bool)
        for slot in self.active:
            active_rows[slot] = True
        tables = np.where(active_rows[:, None], self.cache.page_tables,
                          0).astype(np.int32)
        lengths = np.where(active_rows, self.cache.lengths,
                           0).astype(np.int32)
        return {"k_pages": self.cache.k_pages,
                "v_pages": self.cache.v_pages,
                "page_tables": self._dev(tables),
                "lengths": self._dev(lengths)}

    # ----------------------------------------------------- decode round
    def _prepare_decode(self, now: float):
        """Host-side half of one decode/verify round, shared by the
        fused and unfused paths: draft (under speculation), privatize
        page headroom for every DECODING slot's write window (evicting
        on pressure), and build the round's fixed-shape (B, T) token
        array.  Returns (tokens, drafts, any_draft), or None when
        pressure evicted every DECODING slot.

        A row whose drafter returns nothing still participates — its
        round IS a decode step (one write, one bonus token) — so the
        batch never splits into spec and non-spec programs.  When *no*
        row drafted anything, the round is 1 wide (a plain decode step)
        instead of a (k+1)-wide verify of pure padding; both produce
        the identical next token, only the width differs."""
        if self.spec_k > 0:
            k = self.spec_k
            drafts: Dict[int, List[int]] = {}
            for slot, req in self.active.items():
                # cap the draft so even full acceptance cannot outrun
                # max_new_tokens — which also keeps every speculative
                # write inside the page budget submit() admitted the
                # request under
                cap = min(k, req.max_new_tokens - len(req.generated) - 1)
                d = self.drafter.propose(slot, req, cap) if cap > 0 \
                    else []
                drafts[slot] = [int(t) for t in d[:max(cap, 0)]]
            # page headroom for every position this row can confirm
            # (n_draft + 1 writes).  Padded verify positions past the
            # window land on the null page or on this slot's own
            # private pages — never on shared ones (pages past the
            # write frontier are never donated to the trie) — so they
            # need no budget.
            self._ensure_headroom_all(
                now, {s: len(d) + 1 for s, d in drafts.items()})
            if not self.active:          # pressure evicted everyone
                return None
            any_draft = any(drafts[slot] for slot in self.active)
            T = k + 1 if any_draft else 1
        else:
            # page headroom for this step's token writes (growth or COW
            # of a trie-donated page); evict on pressure
            drafts, any_draft, T = {}, False, 1
            self._ensure_headroom_all(now, {})
            if not self.active:          # pressure evicted everyone
                return None
        tokens = np.zeros((self.max_batch, T), np.int32)
        for slot, req in self.active.items():
            tokens[slot, 0] = req.generated[-1]
            d = drafts.get(slot, [])
            tokens[slot, 1:1 + len(d)] = d
        return tokens, drafts, any_draft

    def _apply_decode(self, nxt, drafts, any_draft, now: float) -> None:
        """Bank one decode/verify round's token output ``nxt``
        ((B, 1) or (B, T), host- or device-side).  The acceptance loop
        is the unified form: with no drafts it degenerates to appending
        row token 0 (a = 0, the eos truncation is a no-op on a single
        token), which is exactly the plain decode bank."""
        self._c["n_decode_steps"].inc()
        self._c["n_spec_rounds"].inc(int(any_draft))
        self._last_decode_rows = len(self.active)
        nxt = _host(nxt)
        for slot in list(self.active):
            req = self.active[slot]
            d, row = drafts.get(slot, []), nxt[slot]
            # accept the longest draft prefix the target itself would
            # have generated; row[a] is then the free bonus token
            a = 0
            while a < len(d) and d[a] == int(row[a]):
                a += 1
            appended = d[:a] + [int(row[a])]
            if self.eos_id is not None and self.eos_id in appended:
                # the oracle stops at eos: anything banked after it
                # was never generated
                appended = appended[:appended.index(self.eos_id) + 1]
            req.generated.extend(appended)
            self.cache.lengths[slot] += len(appended)
            self._c["n_drafted"].inc(len(d))
            # drafts past an accepted eos were never banked
            self._c["n_draft_accepted"].inc(min(a, len(appended)))
            if self.tel:
                self.tel.event(req, "decode_round", t=self._now,
                               replica=self.uid, n=len(appended),
                               drafted=len(d),
                               accepted=min(a, len(appended)))
            if self.spec_k > 0:
                self.cache.rollback_spec(slot)
            if self._done(req):
                self._finish(slot, now)
            # confirmed in one burst: the streaming face of speculation
            self._emit(req, appended)

    def _decode_round(self, tokens, drafts, any_draft,
                      now: float) -> None:
        """Unfused decode/verify dispatch over the prepared round."""
        program = self._verify if tokens.shape[1] > 1 else self._decode
        nxt, state = program(self.params, self._masked_state(),
                             self._dev(tokens))
        self.cache.k_pages = state["k_pages"]
        self.cache.v_pages = state["v_pages"]
        self._c["n_total_dispatches"].inc()
        self._apply_decode(nxt, drafts, any_draft, now)

    def _fused_round(self, tokens, drafts, any_draft,
                     now: float) -> None:
        """The fused uber-program: this step's decode/verify round AND
        one chunk for every PREFILLING request in ONE dispatch
        (models/lm.fused_step_paged carries the page-disjointness
        argument that makes the merge bitwise).  The prefill inputs are
        built *after* ``_prepare_decode`` ran: its headroom pass may
        preempt a PREFILLING slot, and the dispatch must see the
        survivors.  Decode results are banked before prefill
        promotions: promotion may replay, replay may preempt — an
        unapplied decode token must never be dropped."""
        group = list(self.prefilling.items())
        p_tokens, tables, starts, valids, metas = \
            self._prefill_inputs(group)
        (d_nxt, p_nxt), state = self._fused(
            self.params, self._masked_state(),
            self._dev(tokens), self._dev(p_tokens), self._dev(tables),
            self._dev(starts), self._dev(valids))
        # both outputs to the host before anything dispatches again (a
        # graph's outputs hold only until its next replay)
        d_nxt, p_nxt = _host(d_nxt), _host(p_nxt)
        self.cache.k_pages = state["k_pages"]
        self.cache.v_pages = state["v_pages"]
        # one launch subsumes a prefill dispatch and a decode round:
        # both sub-counters advance (their per-kind semantics — chunks
        # ingested, rounds banked — are unchanged), total only once
        self._c["n_fused_dispatches"].inc()
        self._c["n_total_dispatches"].inc()
        self._c["n_prefill_dispatches"].inc()
        self._c["n_prefill_chunks"].inc(len(metas))
        self._apply_decode(d_nxt, drafts, any_draft, now)
        self._finish_prefill(metas, p_nxt, now)

    # ------------------------------------------------------------- step
    def step(self, now: float = float("inf")) -> bool:
        """One engine iteration: admit what fits (up to
        ``prefill_batch`` co-ingesting prompts), advance every
        prefilling request one chunk, and run one decode/verify round
        over every decoding slot — in the steady state (both kinds of
        work pending) a single fused dispatch covers all of it
        (``fused=True``, the default).  Returns True while any work
        remains (queued or in flight).

        With tracing on, wraps ``_step`` to emit one step-timeline
        record: dispatch kind, rows per group, page/COW/eviction
        deltas, population sizes.  The sanitized clock ``_now``
        substitutes the step index when driven offline (``now=inf``)
        so span/timeline times stay finite."""
        self._now = (float(now) if now != float("inf")
                     else float(self.n_engine_steps))
        if not self.tel:
            return self._step(now)
        pre = (self._c["n_prefill_dispatches"].value,
               self._c["n_decode_steps"].value,
               self._c["n_replay_steps"].value,
               self._c["n_fused_dispatches"].value,
               self._c["n_prefill_chunks"].value,
               self.cache.n_cow, self.cache.n_prefix_evictions,
               self.cache.n_shared_tokens)
        self._last_decode_rows = 0
        more = self._step(now)
        d_pref, d_dec, d_rep, d_fus, d_chunks, d_cow, d_evict, d_shr = (
            self._c["n_prefill_dispatches"].value - pre[0],
            self._c["n_decode_steps"].value - pre[1],
            self._c["n_replay_steps"].value - pre[2],
            self._c["n_fused_dispatches"].value - pre[3],
            self._c["n_prefill_chunks"].value - pre[4],
            self.cache.n_cow - pre[5],
            self.cache.n_prefix_evictions - pre[6],
            self.cache.n_shared_tokens - pre[7])
        kind = ("fused" if d_fus else
                "+".join([k for k, v in (("prefill", d_pref),
                                         ("decode", d_dec),
                                         ("replay", d_rep)) if v])
                or "idle")
        self.tel.record(
            "engine", t=self._now, replica=self.uid, kind=kind,
            prefill_rows=d_chunks, decode_rows=self._last_decode_rows,
            replay_steps=d_rep, pages_free=self.cache.free_pages,
            cow=d_cow, prefix_evictions=d_evict, shared_tokens=d_shr,
            waiting=len(self.waiting), prefilling=len(self.prefilling),
            active=len(self.active), finished=len(self.finished))
        return more

    def _step(self, now: float) -> bool:
        # Admission + prefill.  Chunk pacing exists to stop LONG
        # prompts from stalling in-flight decode, so only mid-prompt
        # chunks yield the step: short prompts (<= chunk_size) admit,
        # ingest, and promote eagerly — the batch ramps as fast as
        # one-shot prefill — and a prompt that could share a prefix
        # with one still ingesting waits for its registration
        # (_defers_for_sharing), so bursts still share.  With no
        # decoders to protect, long prompts ingest back-to-back too.
        # Under fusion, any pending chunk work while decoders exist is
        # carried into this step's single fused dispatch instead of a
        # standalone prefill launch; degenerate mixes — prefill-only
        # ramp, decode-only tail — take the standalone programs, so
        # they reproduce the unfused engine dispatch-for-dispatch.
        if self.n_inflight:
            self._c["n_engine_steps"].inc()
        while True:
            self._admit_burst(now)
            if not self.prefilling:
                break
            if self.fused and self.active:
                break              # chunks ride the fused dispatch
            self._run_prefill(now)
            if self.prefilling and self.active:
                break                          # mid-prompt pacing point
        if not self.active:
            return bool(self.waiting or self.prefilling)

        prep = self._prepare_decode(now)
        if prep is None:             # pressure evicted everyone
            return bool(self.waiting or self.prefilling)
        tokens, drafts, any_draft = prep
        if self.fused and self.prefilling:
            self._fused_round(tokens, drafts, any_draft, now)
        else:
            self._decode_round(tokens, drafts, any_draft, now)
        return bool(self.active or self.prefilling or self.waiting)

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, float]:
        """Cumulative engine counters: dispatch counts (the
        machine-independent face of every serving optimization —
        wall-clock on shared runners is noise, program launches are
        not), prefill co-ingestion occupancy, and cache reuse.
        ``prefill_rows_mean`` is the mean number of requests sharing a
        prefill dispatch (1.0 == the serialized path).  The dict is the
        compatibility view of the MetricsRegistry this engine's
        counters live in; ratio fields (``prefill_rows_mean``,
        ``accept_rate``) are derived by ``telemetry.merge_stats`` so a
        single replica and a fleet aggregate agree on the formula."""
        raw = {n: c.value for n, c in self._c.items()}
        raw.update(n_shared_tokens=self.cache.n_shared_tokens,
                   n_cow=self.cache.n_cow,
                   n_prefix_evictions=self.cache.n_prefix_evictions)
        return merge_stats([raw])

    # -------------------------------------------------------------- run
    def run(self, requests: List[Request], *,
            realtime: bool = False) -> List[Request]:
        """Drive to completion; returns the requests completed by THIS
        call (the engine is reusable — e.g. a warmup run then a
        measured run).  ``realtime=False`` ignores arrival times (admit
        ASAP — tests / max-throughput); ``realtime=True`` replays them
        against the wall clock (benchmarks / TTFT)."""
        first = len(self.finished)
        for r in requests:
            self.submit(r)
        t0 = time.perf_counter()
        while True:
            now = (time.perf_counter() - t0) if realtime else float("inf")
            if not self.step(now=now):
                break
            if realtime and not self.active and not self.prefilling \
                    and self.waiting:
                time.sleep(max(0.0,
                               self.waiting[0].arrival
                               - (time.perf_counter() - t0)))
        # the batch surface reports via finished Requests; stream
        # events are for step-driven front-ends (drain_events)
        self.events.clear()
        return self.finished[first:]
