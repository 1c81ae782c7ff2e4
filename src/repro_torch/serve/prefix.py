"""Prefix trie mapping prompt-token runs to resident KV pages.

One trie node owns exactly one page and the run of tokens whose K/V
that page holds — ``page_size`` tokens for interior (full-page) nodes,
fewer for leaf tails.  Children are keyed by the *exact* token tuple of
the child's run, so descent is an O(pages) dict walk for the common
case; when no child matches exactly, the longest common prefix against
any child still yields a *partial* hit — the caller attaches that page
read-only and copy-on-write kicks in at the first divergent write
(see kv_cache.PagedKVCache).

The trie stores page *ids* only; page contents live in the device
arrays and refcounts live in the cache.  Each node's page carries one
trie reference for as long as the node exists, which is what keeps a
finished request's prompt KV resident for future hits.  Under page
pressure the cache evicts trie leaves in LRU order
(``pop_lru_leaves``);
interior nodes only become evictable once their subtree is gone, so a
surviving chain is always a usable prefix.

Invariants the cache and scheduler rely on (exercised by
kv_cache.check_invariants and tests/test_serve_engine.py):

* **One page, one node** — a page id appears in at most one trie node
  (``insert`` records only *newly created* nodes and first-writer
  wins), so the cache can charge exactly one trie reference per
  resident page and ``pages()`` never double-counts.
* **Never the null page** — page 0 is the masked-write sink; callers
  only ever insert allocated prompt pages, and the trie never
  fabricates ids.
* **A surviving chain is a usable prefix** — eviction removes leaves
  only; an interior node's page outlives its children, so any
  root-to-node walk that ``lookup`` returns describes contiguously
  resident KV starting at token 0.
* **Lookups always leave one token to compute** — ``total_shared`` is
  capped at ``len(tokens) - 1``; generation needs the final prompt
  token's logits, so a full-prompt hit deliberately under-reports by
  one (the admission path sizes its scatter from this).
* **The trie never mutates pages** — it hands out ids read-only;
  write protection is entirely the cache's refcount/COW discipline
  (a donated page's refcount includes the trie's reference, which is
  what makes the donor's own next write fork).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["PrefixCache"]


class _Node:
    __slots__ = ("key", "page", "n_tokens", "children", "parent",
                 "last_used")

    def __init__(self, key, page, n_tokens, parent):
        self.key: Tuple[int, ...] = key
        self.page: int = page
        self.n_tokens: int = n_tokens
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent: Optional["_Node"] = parent
        self.last_used: int = 0


def _common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class PrefixCache:
    def __init__(self, page_size: int):
        self.ps = page_size
        self.root = _Node((), -1, 0, None)
        self._clock = 0
        self.n_nodes = 0

    @property
    def min_partial_hit(self) -> int:
        """Smallest partial-page overlap worth serving: a partial hit
        forces a copy-on-write page copy at the attach site, so tiny
        accidental overlaps between unrelated prompts cost more than
        they save.  Single source of truth for ``_descend`` and for
        predictors of future hits (``servable_after_insert``)."""
        return max(1, self.ps // 2)

    def servable_after_insert(self, lcp: int) -> int:
        """Leading tokens a ``lookup`` could serve once a prompt whose
        token-level common prefix with the queried one is ``lcp`` has
        been inserted: full pages descend exactly, and the partial
        remainder hits only at the ``min_partial_hit`` threshold.  The
        scheduler's admission deferral (serve/scheduler.py
        ``_defers_for_sharing``) uses this to predict whether waiting
        for an in-flight prompt's registration buys anything."""
        rem = lcp % self.ps
        return lcp - rem + (rem if rem >= self.min_partial_hit else 0)

    # ---------------------------------------------------------- queries
    def _descend(self, toks) -> Tuple[List[Tuple["_Node", int]], int]:
        """Shared traversal behind ``lookup`` and ``probe``: the
        longest resident run of ``toks`` as [(node, n_tokens)],
        uncapped and side-effect-free.  Full-page children descend
        exactly; otherwise the longest common prefix against any child
        yields one final partial hit — if it covers at least half a
        page (a partial hit forces a copy-on-write page copy at the
        attach site; tiny accidental overlaps between unrelated
        prompts cost more than they save)."""
        node, out, shared = self.root, [], 0
        while shared < len(toks):
            rem = toks[shared:]
            if len(rem) >= self.ps:
                ch = node.children.get(tuple(rem[:self.ps]))
                if ch is not None and ch.n_tokens == self.ps:
                    out.append((ch, self.ps))
                    shared += self.ps
                    node = ch
                    continue
            best, best_cp = None, 0
            for ch in node.children.values():
                cp = _common_prefix(ch.key[:ch.n_tokens], rem)
                if cp > best_cp:
                    best, best_cp = ch, cp
            if best is not None and best_cp >= self.min_partial_hit:
                out.append((best, best_cp))
                shared += best_cp
            break
        return out, shared

    def probe(self, tokens) -> int:
        """Read-only residency probe: how many leading tokens of
        ``tokens`` the trie could serve right now.  Unlike ``lookup``
        it neither bumps LRU clocks nor caps at ``len(tokens) - 1`` —
        it exists for *observers* (the request router's prefix-affinity
        scoring, serve/router.py), whose curiosity must not protect
        pages from eviction or perturb engine behavior."""
        return self._descend([int(t) for t in tokens])[1]

    def lookup(self, tokens) -> Tuple[List[Tuple[int, int]], int]:
        """Longest shared prefix of ``tokens`` resident in the trie.

        Returns ([(page_id, n_usable_tokens), ...], total_shared) with
        every entry full (``ps`` tokens) except possibly the last.
        ``total_shared`` is capped at ``len(tokens) - 1`` so the caller
        always computes at least the final prompt token (its logits
        seed generation).
        """
        toks = [int(t) for t in tokens]
        if not toks:
            return [], 0
        out, shared = self._descend(toks)
        if shared >= len(toks):            # leave >= 1 token to compute
            over = shared - (len(toks) - 1)
            node_, cnt = out[-1]
            if cnt - over > 0:
                out[-1] = (node_, cnt - over)
            else:
                out.pop()
            shared = len(toks) - 1
        self._clock += 1
        for n, _ in out:
            n.last_used = self._clock
        return [(n.page, c) for n, c in out], shared

    def insert(self, tokens, pages) -> List[int]:
        """Record ``tokens``' KV residency: page ``pages[i]`` holds the
        i-th page-sized run.  Existing nodes are left untouched (first
        writer wins); returns the page ids of *newly created* nodes —
        the caller must take a trie reference on each."""
        toks = [int(t) for t in tokens]
        self._clock += 1
        node, new_pages = self.root, []
        n_full = len(toks) // self.ps
        for i in range(n_full):
            key = tuple(toks[i * self.ps:(i + 1) * self.ps])
            ch = node.children.get(key)
            if ch is None or ch.n_tokens != self.ps:
                ch = _Node(key, int(pages[i]), self.ps, node)
                node.children[key] = ch
                self.n_nodes += 1
                new_pages.append(ch.page)
            ch.last_used = self._clock
            node = ch
        tail = toks[n_full * self.ps:]
        if tail:
            key = tuple(tail)
            if key not in node.children:
                ch = _Node(key, int(pages[n_full]), len(tail), node)
                node.children[key] = ch
                self.n_nodes += 1
                new_pages.append(ch.page)
            node.children[key].last_used = self._clock
        return new_pages

    # --------------------------------------------------------- eviction
    def pop_lru_leaves(self, n: int) -> List[int]:
        """Remove up to ``n`` least-recently-used leaf nodes and return
        their page ids (caller drops the trie references).  One DFS per
        round harvests the whole current leaf set — interior nodes only
        become leaves (and evictable) once their subtree is gone, so a
        fresh walk runs only when a round exhausts the previous set."""
        out: List[int] = []
        while len(out) < n:
            leaves: List[_Node] = []

            def walk(node):
                for ch in node.children.values():
                    if ch.children:
                        walk(ch)
                    else:
                        leaves.append(ch)
            walk(self.root)
            if not leaves:
                break
            leaves.sort(key=lambda x: x.last_used)
            for leaf in leaves[:n - len(out)]:
                del leaf.parent.children[leaf.key]
                self.n_nodes -= 1
                out.append(leaf.page)
        return out

    # ------------------------------------------------------- inspection
    def resident_tokens(self) -> int:
        """Total prompt tokens the trie holds KV for (sum of node
        runs).  An observer-side warmth measure: the elastic
        controller's scale-down victim scoring (serve/elastic.py)
        prefers retiring the replica whose trie would be the smallest
        loss — like ``probe``, reading it must not perturb LRU state."""
        total = 0

        def walk(node):
            nonlocal total
            for ch in node.children.values():
                total += ch.n_tokens
                walk(ch)
        walk(self.root)
        return total

    def pages(self) -> List[int]:
        out = []

        def walk(node):
            for ch in node.children.values():
                out.append(ch.page)
                walk(ch)
        walk(self.root)
        return out

    def __len__(self) -> int:
        return self.n_nodes
