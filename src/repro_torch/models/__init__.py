"""Models of the port (the dense GQA family of the serving path)."""
from .lm import DecoderLM  # noqa: F401
