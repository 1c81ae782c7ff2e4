"""Paged KV cache: fixed-size pages, a free-list allocator, per-slot
page tables, and copy-on-write prefix sharing.

This is the paper's "which operand stays resident" question applied to
decode: the KV cache is the stationary operand, and paging lets its
residency be managed per page-size token block instead of per
max-length sequence.  Prefix sharing extends the same discipline across
*requests*: identical prompt prefixes map to the same physical pages,
so N requests carrying one system prompt pay its KV cost once.

Device layout (for a scanned all-attention stack of L layers):

    k_pages, v_pages : (L, n_pages, page_size, KVH, Dh)   bf16
    page_tables      : (max_batch, max_pages_per_seq)     int32
    lengths          : (max_batch,)                       int32

Invariants the engine relies on (exercised by check_invariants and
tests/test_serve_engine.py):

* **Free-list discipline** — every page id in [1, n_pages) is either on
  the free list or referenced; a page is handed out by exactly one
  ``_acquire`` per reference and returns to the free list only when its
  refcount reaches zero.  No page is ever in both states.
* **Null-page masking** — page 0 is reserved: inactive batch slots and
  padding chunk rows carry all-zero page tables, so their (masked)
  writes land on page 0 instead of corrupting a live page.  The
  allocator never hands page 0 out and the trie never stores it.
* **Refcount >= 1 while referenced** — a page's refcount equals the
  number of slot page tables containing it plus one if a prefix-trie
  node owns it.  Shared pages (refcount > 1) are read-only: any write
  target with refcount > 1 is copied first (``_cow_page``), so eviction
  of one reader can never free a page another reader still gathers.
* **Compute dtype == page dtype** — pages store bf16 and the model
  computes in bf16, so K/V read back from pages is bit-identical to the
  in-flight K/V of whole-prompt prefill; the engine's token-parity
  guarantee (docs/serving.md) depends on this.
* **Speculative writes stay behind the same discipline** — a verify
  step writes K/V for a whole draft window before acceptance is known,
  so ``ensure_headroom(n_tokens=k+1)`` privatizes/allocates every page
  in the window *first*, and ``rollback_spec`` returns pages past the
  confirmed frontier afterwards; rejected positions inside kept pages
  are plain stale-past-``lengths`` data that masking already hides
  (docs/speculative.md walks the rollback invariants).

The manager is host-side Python (allocation is control flow, not math);
the page tensors live on the model's device and are updated **in
place** by the paged programs (models/lm.py) and by the copy-on-write
page copy here.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .prefix import PrefixCache

__all__ = ["PagedKVCache", "pages_needed"]

NULL_PAGE = 0


def _copy_page(pages, src: int, dst: int) -> None:
    """pages[:, dst] <- pages[:, src], in place, for every layer."""
    pages[:, dst] = pages[:, src]


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages a sequence of ``n_tokens`` occupies — the sizing helper
    for ``max_pages_per_seq`` (a request that prefills P tokens and
    generates G needs ``pages_needed(P + G, page_size)``)."""
    return max(1, math.ceil(n_tokens / page_size))


class PagedKVCache:
    def __init__(self, model, *, max_batch: int, n_pages: int,
                 page_size: int, max_pages_per_seq: int,
                 prefix_sharing: bool = True):
        cfg = model.cfg
        if not model.supports_paged_decode():
            raise ValueError(
                "paged KV cache supports all-attention stacks; "
                f"got layer kinds {set(cfg.layer_kinds)}")
        if n_pages < 2:
            raise ValueError("need at least the null page plus one")
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_batch = max_batch
        self.max_pages_per_seq = max_pages_per_seq

        L = cfg.n_layers
        shape = (L, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
        self.k_pages = torch.zeros(shape, dtype=torch.bfloat16,
                                   device=model.device)
        self.v_pages = torch.zeros(shape, dtype=torch.bfloat16,
                                   device=model.device)

        # host-side bookkeeping
        self._free: List[int] = list(range(n_pages - 1, NULL_PAGE, -1))
        self._ref = np.zeros((n_pages,), np.int32)
        self._tables: Dict[int, List[int]] = {}      # slot -> page ids
        self.page_tables = np.zeros((max_batch, max_pages_per_seq),
                                    np.int32)
        self.lengths = np.zeros((max_batch,), np.int32)
        self.prefix = PrefixCache(page_size) if prefix_sharing else None
        # stats
        self.n_shared_tokens = 0
        self.n_cow = 0
        self.n_prefix_evictions = 0

    # ---------------------------------------------------------- refcount
    def _acquire(self, pid: int) -> None:
        self._ref[pid] += 1

    def _release(self, pid: int) -> None:
        self._ref[pid] -= 1
        assert self._ref[pid] >= 0, f"page {pid} over-released"
        if self._ref[pid] == 0:
            self._free.append(pid)

    # ------------------------------------------------------------ alloc
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return pages_needed(n_tokens, self.page_size)

    def _alloc_page(self, slot: int) -> Optional[int]:
        if not self._free:
            return None
        tbl = self._tables[slot]
        if len(tbl) >= self.max_pages_per_seq:
            return None
        pid = self._free.pop()
        self._acquire(pid)
        self.page_tables[slot, len(tbl)] = pid
        tbl.append(pid)
        return pid

    def _attach_page(self, slot: int, pid: int) -> None:
        tbl = self._tables[slot]
        self._acquire(pid)
        self.page_tables[slot, len(tbl)] = pid
        tbl.append(pid)

    def alloc_slot(self, slot: int, n_tokens: int, *,
                   prompt=None, reserve_tokens: int = 0) -> Optional[int]:
        """Claim pages for a fresh slot holding ``n_tokens`` prompt
        tokens, sharing any trie-resident prefix of ``prompt``.

        All-or-nothing; returns the number of prefix tokens whose KV is
        already resident (0 without a hit), or None if the allocator
        cannot cover the fresh pages plus one decode-headroom page plus
        ``reserve_tokens`` worth of replay growth (slot untouched).
        The first write-target page is made private (copy-on-write)
        before returning, so callers may scatter into
        ``pages[shared:]`` immediately.
        """
        assert slot not in self._tables, f"slot {slot} already allocated"
        need = self.pages_for(n_tokens)
        if need > self.max_pages_per_seq:
            return None
        matches: List = []
        shared = 0
        if prompt is not None and self.prefix is not None:
            matches, shared = self.prefix.lookup(prompt)
        fresh = need - len(matches)
        # a partial last match means position `shared` lands inside a
        # shared page -> one COW copy at admission
        cow = 1 if matches and shared < len(matches) * self.page_size \
            else 0
        reserve = 1 + (self.pages_for(n_tokens + reserve_tokens) - need)
        if fresh + cow + reserve > self.free_pages:
            return None
        self._tables[slot] = []
        for pid, _ in matches:
            self._attach_page(slot, pid)
        for _ in range(fresh):
            pid = self._alloc_page(slot)
            assert pid is not None    # free list checked above
        if cow:
            copied = self._cow_page(slot, len(matches) - 1)
            assert copied    # budgeted above
        self.lengths[slot] = shared
        self.n_shared_tokens += shared
        return shared

    def _cow_page(self, slot: int, idx: int) -> bool:
        """Give ``slot`` a private copy of its ``idx``-th page (no-op if
        already private).  Returns False if the free list is empty."""
        pid = self._tables[slot][idx]
        if self._ref[pid] == 1:
            return True
        if not self._free:
            return False
        new = self._free.pop()
        self._acquire(new)
        self._release(pid)
        self._tables[slot][idx] = new
        self.page_tables[slot, idx] = new
        _copy_page(self.k_pages, pid, new)
        _copy_page(self.v_pages, pid, new)
        self.n_cow += 1
        return True

    def ensure_headroom(self, slot: int, n_tokens: int = 1) -> bool:
        """Make sure the next ``n_tokens`` token writes (positions
        ``lengths[slot] .. lengths[slot] + n_tokens - 1``) each have a
        *private* page: grows the table at page boundaries, and copies
        a shared write target (copy-on-write — the page a finished
        request donated to the prefix trie must not be mutated by its
        own donor's decode).  ``n_tokens`` > 1 is the speculative-
        decode shape: a verify step writes K/V for the whole draft
        window before acceptance is known.

        Returns False if the allocator is exhausted (caller preempts or
        evicts).  Partial progress is kept — the call is idempotent, so
        the caller's make-room-and-retry loop converges without redoing
        COW copies: already-private pages and already-grown table
        entries satisfy their range check immediately on retry."""
        assert n_tokens >= 1
        start = int(self.lengths[slot])
        tbl = self._tables[slot]
        first = start // self.page_size
        last = (start + n_tokens - 1) // self.page_size
        for idx in range(first, last + 1):
            if idx < len(tbl):
                if not self._cow_page(slot, idx):
                    return False
            else:
                assert idx == len(tbl), (idx, len(tbl))
                if self._alloc_page(slot) is None:
                    return False
        return True

    def rollback_spec(self, slot: int) -> int:
        """Release speculative page growth past the write frontier
        (called after a verify step whose trailing draft tokens were
        rejected).  Keeps every page holding confirmed tokens *plus*
        the page the next write lands on; trailing pages — allocated by
        ``ensure_headroom(n_tokens > 1)`` for positions the request did
        not confirm — drop their slot reference and return to the free
        list (they were made private before the write, so refcount hits
        zero here unless another reader raced a share in, which the COW
        discipline forbids for write targets).  Rejected positions
        *inside* kept pages need no work at all: they sit past
        ``lengths[slot]``, where every attention mask already hides
        them, and the next confirmed write overwrites them in place.
        Returns the number of pages released."""
        tbl = self._tables[slot]
        keep = int(self.lengths[slot]) // self.page_size + 1
        freed = 0
        while len(tbl) > keep:
            pid = tbl.pop()
            self.page_tables[slot, len(tbl)] = NULL_PAGE
            self._release(pid)
            freed += 1
        return freed

    def free_slot(self, slot: int) -> None:
        """Drop every page reference of ``slot`` (eviction or
        completion); pages return to the free list only when no other
        slot and no trie node still references them."""
        for pid in self._tables.pop(slot):
            self._release(pid)
        self.page_tables[slot] = NULL_PAGE
        self.lengths[slot] = 0

    # ---------------------------------------------------------- sharing
    def register_prefix(self, slot: int, prompt) -> None:
        """Donate ``slot``'s prompt pages to the prefix trie (called
        once the prompt is fully ingested).  The trie takes its own
        reference on newly recorded pages, so they outlive the request;
        the donor's next write into a donated partial page triggers COW
        like any other shared write."""
        if self.prefix is None:
            return
        for pid in self.prefix.insert(prompt, self._tables[slot]):
            self._acquire(pid)

    def release_prefix_pages(self, n: int = 1) -> int:
        """Evict up to ``n`` LRU prefix-trie leaves, dropping their trie
        references (pages free once no slot uses them).  Returns the
        number of nodes evicted."""
        if self.prefix is None:
            return 0
        pages = self.prefix.pop_lru_leaves(n)
        for pid in pages:
            self._release(pid)
        self.n_prefix_evictions += len(pages)
        return len(pages)

    # ------------------------------------------------------- inspection
    def used_pages(self, slot: int) -> List[int]:
        return list(self._tables.get(slot, ()))

    def check_invariants(self) -> None:
        refs: Dict[int, int] = {}
        for slot, tbl in self._tables.items():
            assert len(tbl) == len(set(tbl)), \
                f"slot {slot} references a page twice"
            for p in tbl:
                refs[p] = refs.get(p, 0) + 1
        trie_pages = self.prefix.pages() if self.prefix is not None else []
        assert len(trie_pages) == len(set(trie_pages)), \
            "page owned by two trie nodes"
        for p in trie_pages:
            refs[p] = refs.get(p, 0) + 1
        assert NULL_PAGE not in refs, "null page referenced"
        assert NULL_PAGE not in self._free, "null page in free list"
        free = set(self._free)
        assert len(free) == len(self._free), "free list duplicate"
        for p in range(1, self.n_pages):
            assert self._ref[p] == refs.get(p, 0), \
                f"page {p}: refcount {self._ref[p]} != {refs.get(p, 0)}"
            assert (p in free) == (self._ref[p] == 0), \
                f"page {p}: free-list / refcount disagree"
        for slot, tbl in self._tables.items():
            assert len(tbl) >= self.pages_for(int(self.lengths[slot]))
