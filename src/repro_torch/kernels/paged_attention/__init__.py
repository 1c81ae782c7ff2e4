from .ops import SPLIT, paged_attention, paged_attention_plain  # noqa: F401
