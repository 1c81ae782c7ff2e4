"""Data of the port: the reference's synthetic, stateless-resumable
pipeline."""
from .pipeline import SyntheticPipeline  # noqa: F401
