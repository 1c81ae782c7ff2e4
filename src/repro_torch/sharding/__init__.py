"""Logical-axis sharding of the port (``repro.sharding``): the rules
that place every leaf on a mesh, and the collectives of the explicit
SPMD that computes over it."""
from .rules import (  # noqa: F401
    DEFAULT_RULES, RULE_VARIANTS, SP_RULES, UNCONSTRAINED, ShardingRules,
    active_rules, logical_spec, set_active_rules, tree_shardings,
)
