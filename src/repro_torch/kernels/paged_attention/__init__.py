from .ops import paged_attention, paged_attention_plain  # noqa: F401
