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
  lists (and, for the draft-model flavor, its own private contiguous
  cache).
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

import torch

from .compiled import tensors_of
from .step import ServePrograms

__all__ = ["PromptLookupDrafter", "DraftModelDrafter"]


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


class DraftModelDrafter:
    """Draft with a second ``DecoderLM`` (``--draft-config``): each
    DECODING slot keeps a private single-row contiguous cache for the
    draft model, fed through the lockstep decode step
    (``ServePrograms.lockstep``: ``make_decode_step``'s program, whose
    attention is the paged kernel over the cache viewed as one page; on
    the card a CUDA graph a slot's cache, as the reference jits it).
    The context is streamed token by token, so there is no prefill
    program per prompt length.

    Rollback is a position reset: after a verify round rejects the tail
    of a draft, the slot's draft cache simply rewinds ``pos`` to the
    last *confirmed* context token it had consumed — entries past
    ``pos`` are masked by decode attention and get overwritten in place
    when the true continuation is fed.  The draft cache never needs
    page bookkeeping, COW, or replay: it is advisory state, rebuilt
    from the token list after any preemption.

    A slot's cache outlives its request: the slot's next request zeroes
    it in place and rewinds ``pos`` to 0, so the slot's graph replays
    (a new cache would be a new capture a request, which costs more
    than the decode steps it replaces).  Each request keeps its own
    logical capacity (``cap``, which bounds its drafts), so the drafts
    are those of a fresh cache; the cache is remade only where a
    request needs more room than the slot has.  ``programs``: the
    draft model's ``ServePrograms`` (default ``ServePrograms(model)``;
    ``graphs=False`` decodes eagerly on the card).
    """

    def __init__(self, model, params, *, cfg_target=None,
                 headroom: int = 8, programs=None):
        if cfg_target is not None and \
                model.cfg.vocab_size != cfg_target.vocab_size:
            raise ValueError(
                f"draft vocab {model.cfg.vocab_size} != target vocab "
                f"{cfg_target.vocab_size}: draft tokens would be "
                "meaningless to the verifier")
        self.model = model
        programs = programs or ServePrograms(model)
        # the projection weights in the compute dtype once (a no-op on
        # weights that already are); exact, so the drafts are the same
        self.params = programs.prepare_params(params)
        self._decode = programs.lockstep()
        self.headroom = headroom
        self._slots: Dict[int, dict] = {}   # slot -> {cache, n_fed, cap}
        # slot -> {cache, room}: the slot's cache, kept across requests
        self._caches: Dict[int, dict] = {}

    def _state_for(self, slot: int, req) -> dict:
        st = self._slots.get(slot)
        if st is None:
            cap = len(req.prompt) + req.max_new_tokens + self.headroom
            kept = self._caches.get(slot)
            if kept is None or kept["room"] < cap:
                kept = {"cache": self.model.init_cache(1, cap), "room": cap}
                self._caches[slot] = kept
            else:
                for t in tensors_of({k: v for k, v in kept["cache"].items()
                                     if k != "pos"}):
                    t.zero_()
            st = {"cache": kept["cache"], "n_fed": 0, "cap": cap}
            self._slots[slot] = st
        return st

    def _token(self, t: int) -> torch.Tensor:
        return torch.tensor([[t]], dtype=torch.int32,
                            device=self.model.device)

    def propose(self, slot: int, req, k: int) -> List[int]:
        if k <= 0:
            return []
        st = self._state_for(slot, req)
        ctx = [int(t) for t in req.prompt] + list(req.generated)
        # rewind past any rejected draft tokens from the last round:
        # the cache's pos falls back to the confirmed-context frontier
        # and the pending true tokens overwrite the stale entries
        cache = st["cache"]
        cache["pos"] = torch.full((), st["n_fed"], dtype=torch.int32,
                                  device=self.model.device)
        tok = None
        for t in ctx[st["n_fed"]:]:
            tok, cache = self._decode(self.params, cache, self._token(t))
        st["n_fed"] = len(ctx)
        if tok is None:                      # nothing new to consume
            return []
        drafts: List[int] = []
        budget = st["cap"] - len(ctx) - 1    # cache slots left to write
        for _ in range(min(k, max(budget, 0))):
            drafts.append(int(tok[0, 0]))
            if len(drafts) < k:
                tok, cache = self._decode(self.params, cache, tok)
        return drafts

    def detach(self, slot: int) -> None:
        # the request's state goes; its cache stays for the slot's next
        self._slots.pop(slot, None)
