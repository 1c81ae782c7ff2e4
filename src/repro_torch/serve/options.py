"""One construction surface for the serve stack: ``ServeOptions`` (the
port's copy of ``repro.serve.options``).

The CLI registers its flags through ``add_cli`` (the reference's
spellings), parses them back with ``from_args``, and
``build``/``build_frontend`` construct the whole backend stack —
engine(s), router or elastic controller, fault injectors, drafters,
streaming front-end — from one value.  Programmatic callers construct
it directly and skip argparse entirely:

    opts = ServeOptions(batch=8, spec_k=4, replicas=2)
    backend = opts.sized_for(reqs).build(model, params)

Knob semantics are documented in the reference's docs/serving.md; this
module only owns how they compose into objects.  Tensor parallelism
(``tp > 1``) is not ported: it raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional, Sequence

from .. import configs
from ..models.lm import DecoderLM
from .elastic import ElasticController, ElasticPolicy
from .faults import FaultInjector, parse_fault_spec
from .frontend import ServeFrontend, TenantPolicy
from .kv_cache import pages_needed
from .router import ROUTER_POLICIES, RequestRouter
from .scheduler import ServeEngine
from .spec import DraftModelDrafter
from .step import ServePrograms
from .telemetry import Telemetry

__all__ = ["ServeOptions"]


def _parse_weights(spec: str) -> Dict[str, float]:
    """``"a=3,b=1"`` -> ``{"a": 3.0, "b": 1.0}`` (empty -> {})."""
    out: Dict[str, float] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        name, _, w = part.partition("=")
        out[name] = float(w) if w else 1.0
    return out


@dataclasses.dataclass
class ServeOptions:
    # engine
    batch: int = 4
    page_size: int = 16
    n_pages: int = 0                 # 0 -> size to the trace (sized_for)
    chunk_size: int = 32
    prefill_batch: int = 0           # 0 -> batch
    prefix_sharing: bool = True
    bucket_edges: Optional[List[int]] = None
    spec_k: int = 4
    draft_config: str = ""
    fused: bool = True               # one dispatch per steady-state step
    max_pages_per_seq: Optional[int] = None
    eos_id: Optional[int] = None
    # fleet
    tp: int = 1                      # > 1 is not ported (raises)
    replicas: int = 1
    router_policy: str = "prefix"
    # elastic fleet (max_replicas > 0 enables the controller: the
    # fleet starts at min_replicas and scales with demand; 0 keeps the
    # fixed --replicas fleet)
    min_replicas: int = 1
    max_replicas: int = 0
    scale_interval: int = 8
    # fault tolerance: watchdog deadline for the router's stall
    # detection, repair-loop knobs for the elastic controller, and an
    # optional scripted fault-injection plan
    # ("<replica>:<crash|stall>@<step>[x<rounds>]", comma-separated)
    # that wraps the initial replicas in FaultInjectors
    stall_patience: int = 8
    repair_backoff: int = 2
    repair_budget: int = 8
    fault_spec: str = ""
    # front-end
    stream: bool = False
    tenant_weights: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # telemetry (serve/telemetry.py): trace_out != "" or
    # metrics_interval > 0 turns tracing on; a programmatic caller can
    # hand in a pre-built Telemetry instead (it wins)
    trace_out: str = ""
    metrics_interval: int = 0
    telemetry: Optional[Telemetry] = None

    # ------------------------------------------------------------- CLI
    @staticmethod
    def add_cli(ap) -> None:
        """Register the serve-stack flags (same spellings the CLI has
        always used) on an argparse parser."""
        ap.add_argument("--batch", type=int, default=4)
        ap.add_argument("--page-size", type=int, default=16)
        ap.add_argument("--n-pages", type=int, default=0,
                        help="0 -> sized to the trace")
        ap.add_argument("--chunk-size", type=int, default=32,
                        help="prompt tokens ingested per engine step")
        ap.add_argument("--prefill-batch", type=int, default=0,
                        help="requests co-ingesting one prompt chunk "
                             "each per prefill dispatch (0 -> --batch; "
                             "1 -> serialized path; tokens are "
                             "unchanged, only dispatch count)")
        ap.add_argument("--no-prefix-sharing", action="store_true",
                        help="disable the prefix cache (recompute every "
                             "prompt from scratch)")
        ap.add_argument("--bucket-edges", type=str, default="",
                        help="comma-separated context buckets in pages "
                             "(default: doubling)")
        ap.add_argument("--spec-k", type=int, default=4,
                        help="draft tokens verified per engine step "
                             "(speculative decode; tokens are "
                             "unchanged, only faster)")
        ap.add_argument("--no-spec", action="store_true",
                        help="disable speculative decode (one token per "
                             "decode step)")
        ap.add_argument("--fused", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="fuse each steady-state step's prefill "
                             "chunk + decode/verify work into ONE "
                             "program dispatch (tokens unchanged; "
                             "--no-fused is the debugging escape hatch "
                             "back to the two-dispatch engine)")
        ap.add_argument("--draft-config", type=str, default="",
                        help="arch id of a draft model for speculation "
                             "(default: model-free n-gram prompt "
                             "lookup); resolved at the same --smoke "
                             "size as --arch")
        ap.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree (not ported: only "
                             "1 runs)")
        ap.add_argument("--replicas", type=int, default=1,
                        help="engine replicas behind the request router "
                             "(each gets its own --n-pages pool)")
        ap.add_argument("--min-replicas", type=int, default=1,
                        help="elastic-fleet floor (and initial size); "
                             "only read when --max-replicas > 0")
        ap.add_argument("--max-replicas", type=int, default=0,
                        help="> 0 makes the fleet ELASTIC: a control "
                             "loop scales replicas between "
                             "--min-replicas and this with demand, "
                             "migrating live requests off draining "
                             "replicas (token streams unchanged); 0 "
                             "keeps the fixed --replicas fleet")
        ap.add_argument("--scale-interval", type=int, default=8,
                        help="engine steps between elastic control "
                             "rounds")
        ap.add_argument("--stall-patience", type=int, default=8,
                        help="router watchdog: stepped rounds a "
                             "replica may hold work without a single "
                             "dispatch before it is declared FAILED "
                             "and its requests recovered from the "
                             "journal")
        ap.add_argument("--repair-backoff", type=int, default=2,
                        help="elastic repair loop: base backoff (in "
                             "steps, doubling per consecutive factory "
                             "failure) between attempts to rebuild a "
                             "crash-lost replica")
        ap.add_argument("--repair-budget", type=int, default=8,
                        help="elastic repair loop: consecutive failed "
                             "rebuild attempts tolerated before the "
                             "fleet stays degraded")
        ap.add_argument("--chaos-faults", type=str, default="",
                        help="scripted fault injection, e.g. "
                             "'0:crash@12,1:stall@8x5' — wrap replica "
                             "<i> in a FaultInjector that crashes at "
                             "its step <n> (or stalls for <rounds>); "
                             "recovery keeps streams token-exact")
        ap.add_argument("--router-policy", type=str, default="prefix",
                        choices=list(ROUTER_POLICIES),
                        help="replica selection: prefix affinity "
                             "(default), least outstanding tokens, or "
                             "round-robin")
        ap.add_argument("--stream", action="store_true",
                        help="serve through the async streaming "
                             "front-end (per-request token streams, "
                             "SLO classes, tenant fairness) instead of "
                             "the offline batch driver")
        ap.add_argument("--tenant-weights", type=str, default="",
                        help="comma-separated tenant=weight pairs for "
                             "the --stream front-end (e.g. "
                             "'interactive=3,bulk=1'); requests are "
                             "assigned round-robin across the named "
                             "tenants")
        ap.add_argument("--trace-out", type=str, default="",
                        help="write serve telemetry (request lifecycle "
                             "spans + step timeline + metrics) as JSONL "
                             "to this path; also turns tracing on "
                             "(the reference's scripts/trace_report.py "
                             "reads it)")
        ap.add_argument("--metrics-interval", type=int, default=0,
                        help="> 0 embeds a full metrics-registry "
                             "snapshot into the trace every N engine "
                             "step records (implies tracing)")

    @classmethod
    def from_args(cls, args) -> "ServeOptions":
        """Build from a parsed argparse namespace (``add_cli`` flags)."""
        edges = ([int(e) for e in args.bucket_edges.split(",")]
                 if args.bucket_edges else None)
        return cls(
            batch=args.batch,
            page_size=args.page_size,
            n_pages=args.n_pages,
            chunk_size=args.chunk_size,
            prefill_batch=args.prefill_batch,
            prefix_sharing=not args.no_prefix_sharing,
            bucket_edges=edges,
            spec_k=0 if args.no_spec else args.spec_k,
            draft_config=args.draft_config,
            fused=getattr(args, "fused", True),
            tp=args.tp,
            replicas=args.replicas,
            router_policy=args.router_policy,
            min_replicas=getattr(args, "min_replicas", 1),
            max_replicas=getattr(args, "max_replicas", 0),
            scale_interval=getattr(args, "scale_interval", 8),
            stall_patience=getattr(args, "stall_patience", 8),
            repair_backoff=getattr(args, "repair_backoff", 2),
            repair_budget=getattr(args, "repair_budget", 8),
            fault_spec=getattr(args, "chaos_faults", ""),
            stream=getattr(args, "stream", False),
            tenant_weights=_parse_weights(
                getattr(args, "tenant_weights", "")),
            trace_out=getattr(args, "trace_out", ""),
            metrics_interval=getattr(args, "metrics_interval", 0),
        )

    # ------------------------------------------------------ construction
    def sized_for(self, reqs: Sequence, *,
                  shared_prefix: int = 0) -> "ServeOptions":
        """Resolve ``n_pages == 0`` / ``max_pages_per_seq == None``
        from a request trace: per-replica pool = one null page + a
        (pages + headroom) budget per batch slot + the shared prefix's
        pages once.  Explicit values pass through unchanged."""
        need = [pages_needed(len(r.prompt) + r.max_new_tokens,
                             self.page_size) for r in reqs]
        mpps = self.max_pages_per_seq or max(need)
        n_pages = self.n_pages or (
            1 + self.batch * (max(need) + 1)
            + pages_needed(max(shared_prefix, 1), self.page_size))
        return dataclasses.replace(self, n_pages=n_pages,
                                   max_pages_per_seq=mpps)

    def make_drafter_factory(self, cfg_target, *, smoke: bool = False,
                             device=None):
        """Per-replica drafter constructor for ``draft_config`` (None
        when the default n-gram prompt-lookup drafter applies).  The
        draft model (seed 1) lives on ``device`` (default: the GPU) and
        its weights are made once, shared by every drafter.  Drafter
        state is keyed by batch slot, so replicas must not share one
        instance."""
        if not (self.spec_k and self.draft_config):
            return None
        dcfg = (configs.get_smoke if smoke
                else configs.get)(self.draft_config)
        dmodel = DecoderLM(dcfg, device=device)
        dparams = ServePrograms(dmodel).prepare_params(dmodel.init(seed=1))

        def factory():
            return DraftModelDrafter(dmodel, dparams,
                                     cfg_target=cfg_target)
        return factory

    def build(self, model, params, *, smoke: bool = False,
              programs=None):
        """Construct the backend this options value describes: one
        ``ServeEngine``, a ``RequestRouter`` over ``replicas`` engines,
        or — when ``max_replicas > 0`` — an ``ElasticController`` whose
        fleet tracks demand; ``FaultInjector`` wraps the replicas
        ``fault_spec`` names.  All replicas, including ones the
        controller adds later, share ONE program bundle.  ``smoke``
        sizes the draft model (``draft_config``) like the target."""
        if self.n_pages <= 0:
            raise ValueError("n_pages unresolved: pass it explicitly or "
                             "call sized_for(reqs) first")
        if self.tp > 1:
            raise NotImplementedError(
                "tensor-parallel serving is not ported yet (tp=1 only)")
        if programs is None:
            programs = ServePrograms(model)
        drafter_factory = self.make_drafter_factory(
            model.cfg, smoke=smoke, device=model.device)
        # ONE Telemetry per stack: every engine (including ones the
        # elastic controller adds later), the router, the controller
        # and the front-end share it, so spans survive migration and
        # the registry sees the whole fleet (backend.tel reaches it)
        tel = self.telemetry
        if tel is None:
            tel = Telemetry(
                trace=bool(self.trace_out or self.metrics_interval),
                metrics_interval=self.metrics_interval)

        def mk():
            return ServeEngine(
                model, params, max_batch=self.batch,
                n_pages=self.n_pages, page_size=self.page_size,
                max_pages_per_seq=self.max_pages_per_seq,
                eos_id=self.eos_id, chunk_size=self.chunk_size,
                prefill_batch=self.prefill_batch or self.batch,
                prefix_sharing=self.prefix_sharing,
                bucket_edges=self.bucket_edges, spec_k=self.spec_k,
                drafter=(drafter_factory() if drafter_factory
                         else None),
                fused=self.fused,
                programs=programs,
                telemetry=tel)

        def wrap_faults(engines):
            # scripted chaos: wrap the targeted initial replicas in
            # FaultInjectors (replicas joined later by the elastic
            # controller are always healthy builds)
            if not self.fault_spec:
                return engines
            engines = list(engines)
            for idx, kw in parse_fault_spec(self.fault_spec):
                if not 0 <= idx < len(engines):
                    raise ValueError(
                        f"--chaos-faults targets replica {idx}; fleet "
                        f"starts with {len(engines)}")
                engines[idx] = FaultInjector(engines[idx], **kw)
            return engines

        if self.max_replicas > 0:
            # elastic fleet: start at the floor, let demand grow it.
            # Every replica the controller ever builds comes from the
            # same mk() closure, so joins share the program bundle.
            lo = max(1, self.min_replicas)
            policy = ElasticPolicy(
                min_replicas=lo,
                max_replicas=max(lo, self.max_replicas),
                scale_interval=self.scale_interval,
                repair_backoff=self.repair_backoff,
                repair_budget=self.repair_budget)
            router = RequestRouter(
                wrap_faults([mk() for _ in range(lo)]),
                policy=self.router_policy,
                stall_patience=self.stall_patience,
                telemetry=tel)
            return ElasticController(router, mk, policy=policy)
        if self.replicas > 1:
            return RequestRouter(
                wrap_faults([mk() for _ in range(self.replicas)]),
                policy=self.router_policy,
                stall_patience=self.stall_patience,
                telemetry=tel)
        return wrap_faults([mk()])[0]

    def build_frontend(self, model, params, *, smoke: bool = False,
                       programs=None, slo_aware: bool = True,
                       realtime: bool = False):
        """Streaming front-end over the built backend, with
        ``tenant_weights`` materialized as tenant policies."""
        tenants = {name: TenantPolicy(weight=w)
                   for name, w in self.tenant_weights.items()} or None
        return ServeFrontend(
            self.build(model, params, smoke=smoke, programs=programs),
            tenants=tenants, slo_aware=slo_aware, realtime=realtime)
