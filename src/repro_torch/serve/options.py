"""The engine's construction surface: ``ServeOptions`` (the engine
subset of ``repro.serve.options``).

    opts = ServeOptions(batch=8, spec_k=4)
    engine = opts.sized_for(reqs).build(model, params)

The CLI registers the engine flags through ``add_cli`` (the reference's
spellings) and parses them back with ``from_args``.  The reference's
fleet options (tensor parallelism, replicas and the router, the elastic
fleet, fault injection, the streaming front-end, a draft model, trace
export) are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence

from .kv_cache import pages_needed
from .scheduler import ServeEngine
from .telemetry import Telemetry

__all__ = ["ServeOptions"]


@dataclasses.dataclass
class ServeOptions:
    batch: int = 4
    page_size: int = 16
    n_pages: int = 0                 # 0 -> size to the trace (sized_for)
    chunk_size: int = 32
    prefill_batch: int = 0           # 0 -> batch
    prefix_sharing: bool = True
    bucket_edges: Optional[List[int]] = None
    spec_k: int = 4
    fused: bool = True               # one dispatch per steady-state step
    max_pages_per_seq: Optional[int] = None
    eos_id: Optional[int] = None

    # ------------------------------------------------------------- CLI
    @staticmethod
    def add_cli(ap) -> None:
        """Register the engine flags on an argparse parser."""
        ap.add_argument("--batch", type=int, default=4)
        ap.add_argument("--page-size", type=int, default=16)
        ap.add_argument("--n-pages", type=int, default=0,
                        help="0 -> sized to the trace")
        ap.add_argument("--chunk-size", type=int, default=32,
                        help="prompt tokens ingested per engine step")
        ap.add_argument("--prefill-batch", type=int, default=0,
                        help="requests co-ingesting one prompt chunk "
                             "each per prefill dispatch (0 -> --batch)")
        ap.add_argument("--no-prefix-sharing", action="store_true",
                        help="disable the prefix cache")
        ap.add_argument("--bucket-edges", type=str, default="",
                        help="comma-separated context buckets in pages "
                             "(default: doubling)")
        ap.add_argument("--spec-k", type=int, default=4,
                        help="draft tokens verified per engine step "
                             "(speculative decode; tokens unchanged)")
        ap.add_argument("--no-spec", action="store_true",
                        help="disable speculative decode")
        ap.add_argument("--fused", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="fuse each steady-state step's prefill "
                             "chunk and decode/verify work into one "
                             "dispatch (tokens unchanged)")

    @classmethod
    def from_args(cls, args) -> "ServeOptions":
        """Build from a parsed namespace of ``add_cli`` flags."""
        edges = ([int(e) for e in args.bucket_edges.split(",")]
                 if args.bucket_edges else None)
        return cls(batch=args.batch, page_size=args.page_size,
                   n_pages=args.n_pages, chunk_size=args.chunk_size,
                   prefill_batch=args.prefill_batch,
                   prefix_sharing=not args.no_prefix_sharing,
                   bucket_edges=edges,
                   spec_k=0 if args.no_spec else args.spec_k,
                   fused=args.fused)

    # ------------------------------------------------------ construction
    def sized_for(self, reqs: Sequence, *,
                  shared_prefix: int = 0) -> "ServeOptions":
        """Resolve ``n_pages == 0`` / ``max_pages_per_seq == None``
        from a request trace: one null page + a (pages + headroom)
        budget per batch slot + the shared prefix's pages once.
        Explicit values pass through unchanged."""
        need = [pages_needed(len(r.prompt) + r.max_new_tokens,
                             self.page_size) for r in reqs]
        mpps = self.max_pages_per_seq or max(need)
        n_pages = self.n_pages or (
            1 + self.batch * (max(need) + 1)
            + pages_needed(max(shared_prefix, 1), self.page_size))
        return dataclasses.replace(self, n_pages=n_pages,
                                   max_pages_per_seq=mpps)

    def build(self, model, params, *, programs=None,
              telemetry: Optional[Telemetry] = None) -> ServeEngine:
        """One ``ServeEngine`` as this value describes it."""
        if self.n_pages <= 0:
            raise ValueError("n_pages unresolved: pass it explicitly or "
                             "call sized_for(reqs) first")
        return ServeEngine(
            model, params, max_batch=self.batch, n_pages=self.n_pages,
            page_size=self.page_size,
            max_pages_per_seq=self.max_pages_per_seq, eos_id=self.eos_id,
            chunk_size=self.chunk_size,
            prefill_batch=self.prefill_batch or self.batch,
            prefix_sharing=self.prefix_sharing,
            bucket_edges=self.bucket_edges, spec_k=self.spec_k,
            fused=self.fused, programs=programs, telemetry=telemetry)
