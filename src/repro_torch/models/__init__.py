"""Models of the port (the stacks the serving path pages: dense GQA and
the single-device mixture of experts)."""
from .lm import DecoderLM  # noqa: F401
