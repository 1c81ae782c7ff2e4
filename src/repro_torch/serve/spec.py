"""Speculative decoding: draft proposers for the paged serve engine.

Split of responsibilities (the classic proposer/verifier decomposition,
Leviathan et al. 2023 / prompt-lookup decoding):

* A **drafter** guesses up to ``k`` continuation tokens per request per
  engine step.  Drafts are *advisory*: nothing a drafter returns can
  change the generated stream, only how fast it is produced.  A wrong
  draft costs one wasted verify position; a right one saves a whole
  decode step.
* The **verifier** is the target model itself: the scheduler packs
  ``[last_confirmed, d_1 .. d_k]`` per row into one
  ``DecoderLM.verify_step_paged`` call, which scores all ``k+1``
  positions in a single batched program and returns the target's own
  greedy prediction at each.  The engine accepts the longest draft
  prefix that matches (``d_i == argmax(logits[i-1])``) and always banks
  the verifier's next token after the accepted prefix — the "bonus"
  token — so even an all-rejected round makes the same progress a plain
  decode step would.

Invariants the engine relies on:

* **Drafters never touch the paged cache.**  All page writes, COW
  forks, and rollback happen in the verify path under
  serve/kv_cache.py's discipline; a drafter only reads host-side token
  lists.  (The reference's draft-model drafter is not ported yet.)
* **Accepted == what greedy decode would have produced.**  Acceptance
  compares the draft against the verifier's argmax at the same
  position over bit-identical context (the paged kernel computes
  every query row over its own keys only, in one fixed summation
  order, whatever T is), so spec-on and spec-off streams are
  token-identical.
* **Propose-side state is disposable.**  ``detach`` drops a slot's
  drafter state at finish/preemption; a re-admitted request simply
  re-feeds its context.  Draft state is never checkpointed, shared, or
  replayed.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

__all__ = ["PromptLookupDrafter"]


class PromptLookupDrafter:
    """N-gram prompt-lookup drafting (no model at all): find the most
    recent occurrence of the context's trailing n-gram — in this
    request's own prompt + generation, *or in any other request the
    engine has served* — and propose the tokens that followed it.

    This is the zero-cost drafter: repetitive continuations — quoted
    spans, code identifiers, the degenerate repeat plateaus of greedy
    decoding — are exactly the regime where the next tokens already
    appeared verbatim somewhere the drafter has seen.  The index is
    *cross-request within a workload*: requests sharing a system
    prompt generate overlapping continuations (the same property the
    prefix cache exploits for KV), so the first request through a
    motif becomes the draft source for every later one.  Each index is
    scoped by the request's leading prompt tokens (``scope_tokens``) —
    unrelated workloads must not share n-gram statistics, since a
    short n-gram that recurs across workloads almost never continues
    the same way, and one polluted entry shadows a good one until the
    motif recurs (measured: accept rate decays 0.49 -> 0.15 over five
    unscoped workload generations).  Longer n-grams are tried first
    (``max_ngram`` down to ``min_ngram``) so a specific match beats an
    accidental short one.

    Bookkeeping is O(max_ngram) dict writes per *confirmed* token and
    O(max_ngram) lookups per proposal — no arrays, no device work.  An
    n-gram is only indexed once its continuation token is confirmed
    (the index lags the frontier by one position), so a lookup never
    lands on the still-growing tail it is trying to extend, and a
    trailing plateau ``[x, x]`` correctly finds its own earlier
    ``(x, x) -> x`` occurrence.  Index entries hold references to the
    per-request context lists, so a continuation keeps extending as
    its source request generates.  ``max_entries`` (summed over
    scopes) bounds memory with a **per-scope LRU**: when the budget
    overflows, whole least-recently-*used* scopes are dropped —
    scope granularity because statistics within a workload age
    together, and LRU because the hot workload of the moment is
    exactly the one whose index is earning accepts (the old wholesale
    reset re-cooled every workload each time one overgrew).
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 scope_tokens: int = 16, max_entries: int = 1 << 20):
        assert 1 <= min_ngram <= max_ngram
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.scope_tokens = scope_tokens
        self.max_entries = max_entries
        self._n_entries = 0
        # scope -> ngram -> (ctx_list, pos); ordered oldest-used first
        self._scopes: "OrderedDict[tuple, Dict[tuple, tuple]]" = \
            OrderedDict()
        self._slots: Dict[int, dict] = {}
        self.n_scope_evictions = 0

    def propose(self, slot: int, req, k: int) -> List[int]:
        st = self._slots.get(slot)
        if st is None or st["req"] is not req:
            scope = tuple(int(t) for t in req.prompt[:self.scope_tokens])
            st = {"req": req, "ctx": [int(t) for t in req.prompt],
                  "ngen": 0, "cursor": 0, "scope": scope}
            self._slots[slot] = st
        ctx = st["ctx"]
        for t in req.generated[st["ngen"]:]:
            ctx.append(int(t))
        st["ngen"] = len(req.generated)
        index = self._scopes.get(st["scope"])
        if index is None:
            index = self._scopes[st["scope"]] = {}
        else:
            self._scopes.move_to_end(st["scope"])   # LRU touch
        # index every n-gram whose continuation is now confirmed
        for j in range(st["cursor"], len(ctx) - 1):
            for n in range(self.min_ngram, self.max_ngram + 1):
                if j + 1 >= n:
                    key = tuple(ctx[j + 1 - n:j + 1])
                    self._n_entries += key not in index
                    index[key] = (ctx, j + 1)
        st["cursor"] = max(st["cursor"], len(ctx) - 1)
        # over budget: drop whole least-recently-used scopes (never the
        # one in use — it was just touched to the back of the order)
        while self._n_entries > self.max_entries and len(self._scopes) > 1:
            _, evicted = self._scopes.popitem(last=False)
            self._n_entries -= len(evicted)
            self.n_scope_evictions += 1
        if self._n_entries > self.max_entries:
            # one degenerate scope alone exceeds the budget: reset it
            self._n_entries -= len(index)
            index.clear()
            self.n_scope_evictions += 1
        if k <= 0:
            return []
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if len(ctx) < n:
                continue
            hit = index.get(tuple(ctx[len(ctx) - n:]))
            if hit is not None:
                src, pos = hit
                cont = src[pos:pos + k]
                if cont:
                    return list(cont)
        return []

    def detach(self, slot: int) -> None:
        # the slot's cursor dies with it; its indexed n-grams live on
        # as draft sources for future requests
        self._slots.pop(slot, None)
