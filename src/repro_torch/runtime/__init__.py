"""Fault-tolerant training runtime of the port: the reference's
``repro.runtime`` (driver, straggler monitor, elastic mesh planner)."""
from .driver import DriverConfig, StepEvent, TrainDriver  # noqa: F401
from .elastic import plan_elastic_mesh  # noqa: F401
from .straggler import StragglerEvent, StragglerMonitor  # noqa: F401
