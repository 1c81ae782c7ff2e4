"""The elasticity policy lives in ``serve/elastic.py`` beside the
serving fleet's (the reference's layout); re-exported here."""
from __future__ import annotations

from ..serve.elastic import plan_elastic_mesh

__all__ = ["plan_elastic_mesh"]
