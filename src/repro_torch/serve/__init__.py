"""Serving of the port: the continuous-batching engine over the paged
KV cache, its greedy oracle, and the fleet above it (router, elastic
controller, fault injection and recovery, streaming front-end, drafters)
— ``repro.serve`` without tensor parallelism."""
from .backend import ServeBackend, StreamEvent  # noqa: F401
from .elastic import ElasticController, ElasticPolicy  # noqa: F401
from .faults import (  # noqa: F401
    FaultInjector, ReplicaFailure, parse_fault_spec,
)
from .frontend import (  # noqa: F401
    ServeFrontend, ShedRejection, TenantPolicy, TokenStream,
)
from .kv_cache import PagedKVCache, pages_needed  # noqa: F401
from .options import ServeOptions  # noqa: F401
from .prefix import PrefixCache  # noqa: F401
from .recovery import RequestJournal  # noqa: F401
from .router import RequestRouter  # noqa: F401
from .scheduler import (  # noqa: F401
    SLO_CLASSES, Request, ServeEngine, default_bucket_edges,
)
from .spec import DraftModelDrafter, PromptLookupDrafter  # noqa: F401
from .telemetry import (  # noqa: F401
    MetricsRegistry, SpanEvent, Telemetry, check_spans, chrome_trace,
    merge_stats,
)
from .step import ServePrograms, greedy_generate  # noqa: F401
