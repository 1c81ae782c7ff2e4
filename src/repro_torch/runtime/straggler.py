"""The straggler monitor lives in ``serve/elastic.py`` (the reference's
layout); re-exported here."""
from __future__ import annotations

from ..serve.elastic import StragglerEvent, StragglerMonitor

__all__ = ["StragglerMonitor", "StragglerEvent"]
