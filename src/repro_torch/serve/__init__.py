"""Serving of the port: the continuous-batching engine over the paged
KV cache and its greedy oracle (the engine subset of ``repro.serve``)."""
from .kv_cache import PagedKVCache, pages_needed  # noqa: F401
from .options import ServeOptions  # noqa: F401
from .scheduler import Request, ServeEngine  # noqa: F401
from .spec import PromptLookupDrafter  # noqa: F401
from .step import ServePrograms, greedy_generate  # noqa: F401
