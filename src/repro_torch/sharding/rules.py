"""Logical-axis sharding rules: the reference's ``repro.sharding.rules``
without jax types.

Every parameter, cache leaf and activation is annotated with *logical*
dimension names ("batch", "embed", "q_heads", ...).  A
:class:`ShardingRules` table maps each logical name to an ordered tuple
of mesh axes.  :func:`logical_spec` resolves annotations against a mesh
(anything with ``axis_names`` and a shape: the port's
``launch.mesh.Mesh``, or a duck-typed one whose ``devices`` is an array
of the mesh's shape) with the reference's two safety rules:

* **divisibility** - a mesh axis (or axis product) is used only if it
  divides the dimension size; otherwise the dim falls back to fewer
  axes and ultimately to replication;
* **exclusivity** - a mesh axis appears at most once in one spec; the
  first dim that claims it wins (annotation order).

A spec is a tuple with one entry a dim, trailing replicated dims
dropped, as the reference's ``PartitionSpec``: ``None`` (replicated),
an axis name, or a tuple of axis names (sharded over their product,
the first axis major).  ``tree_shardings`` maps a tree of specs-with-
axes (``ParamSpec``) to a tree of such tuples; ``launch/mesh.py`` cuts
a rank's shard of a full array by one.

The reference's ``constrain`` (``with_sharding_constraint`` on an
activation) has no counterpart: the port's SPMD is explicit (each
collective is written where the reference's GSPMD would insert one,
``sharding/collectives.py``), so an activation's layout is whatever the
code that makes it computes.  The one activation layout the rules
choose is the residual stream's under the active rules
(``set_active_rules``): the models ask ``logical_spec`` where
``("batch", "seq", "act_embed")`` goes (``models/meshed.py``), and lay
it out on sequence shards where ``seq`` lands on ``model``
(``SP_RULES``).  ``soft=True`` is kept for the rules' own semantics.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

__all__ = ["ShardingRules", "DEFAULT_RULES", "SP_RULES", "RULE_VARIANTS",
           "set_active_rules", "active_rules", "logical_spec",
           "tree_shardings", "UNCONSTRAINED", "axis_sizes", "spec_axes"]


class _Unconstrained:
    """The soft mode's entry for a dim whose candidates do not divide
    (the reference's ``PartitionSpec.UNCONSTRAINED``)."""

    def __repr__(self) -> str:
        return "UNCONSTRAINED"


UNCONSTRAINED = _Unconstrained()


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical dim name -> ordered mesh-axis candidates.

    ``()`` means "never shard this dim"; ``("pod", "data")`` means
    "shard over the product of both if divisible, else over a prefix,
    else replicate"."""
    # -- activations ------------------------------------------------------
    batch: tuple = ("pod", "data")       # DP over pods x data
    seq: tuple = ()                      # ("model",) for SP
    act_embed: tuple = ()                # residual-stream feature dim
    act_heads: tuple = ("model",)        # attention-internal head dim
    act_ff: tuple = ("model",)           # MLP-internal hidden dim
    act_vocab: tuple = ("model",)        # logits vocab dim
    act_expert: tuple = ("model",)       # MoE expert-parallel dim
    kv_seq: tuple = ("model",)           # decode KV-cache sequence dim
    # -- parameters -------------------------------------------------------
    embed: tuple = ("data",)             # FSDP: feature dim over data
    vocab: tuple = ("model",)
    q_heads: tuple = ("model",)
    kv_heads: tuple = ("model",)
    head_dim: tuple = ()
    ff: tuple = ("model",)
    expert: tuple = ("model",)           # expert parallelism
    expert_ff: tuple = ()
    layers: tuple = ()                   # stacked layer dim: never sharded
    conv: tuple = ()
    stats: tuple = ()                    # norms / small vectors

    def get(self, name: Optional[str]) -> tuple:
        if name is None:
            return ()
        try:
            return getattr(self, name)
        except AttributeError:
            raise KeyError(f"unknown logical dim {name!r}") from None


DEFAULT_RULES = ShardingRules()

#: Megatron-style sequence parallelism: the residual stream
#: (``("batch", "seq", "act_embed")``) sharded over ``model`` along seq,
#: so the layer inputs remat keeps for the backward are S / m long;
#: each block gathers the sequence for its split work and
#: reduce-scatters its sums (``sharding/spmd.py``).  A rules variant,
#: not a model change: select it with ``set_active_rules`` (under
#: ``with mesh:``) or ``dryrun --rules sp``.  Where ``model`` does not
#: divide the sequence length the stream stays whole.
SP_RULES = dataclasses.replace(DEFAULT_RULES, seq=("model",))

RULE_VARIANTS = {"default": DEFAULT_RULES, "sp": SP_RULES}

_ACTIVE_RULES = DEFAULT_RULES


def set_active_rules(rules: ShardingRules) -> None:
    global _ACTIVE_RULES
    _ACTIVE_RULES = rules


def active_rules() -> ShardingRules:
    return _ACTIVE_RULES


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh: the port's ``Mesh`` (``shape``) or
    a duck-typed one whose ``devices`` has the mesh's shape."""
    shape = getattr(mesh, "shape", None)
    if not isinstance(shape, tuple):
        shape = tuple(mesh.devices.shape)
    return dict(zip(mesh.axis_names, shape))


def logical_spec(axes: Sequence[Optional[str]], shape: Sequence[int],
                 mesh, rules: ShardingRules = DEFAULT_RULES,
                 soft: bool = False) -> tuple:
    """Resolve logical dim names to a legal spec for ``mesh`` (see the
    module docstring).  ``soft=True``: dims whose candidates do not
    divide become ``UNCONSTRAINED`` instead of replicated."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} rank != shape {shape} rank")
    sizes = axis_sizes(mesh)
    used: set = set()
    entries: list = []
    for name, dim in zip(axes, shape):
        cands = [a for a in rules.get(name) if a in sizes and a not in used]
        # the longest prefix whose size product divides the dim
        picked: tuple = ()
        for k in range(len(cands), 0, -1):
            prod = math.prod(sizes[a] for a in cands[:k])
            if prod > 1 and dim % prod == 0:
                picked = tuple(cands[:k])
                break
        used.update(picked)
        if not picked:
            fell_back = any(sizes[a] > 1 for a in rules.get(name)
                            if a in sizes)
            entries.append(UNCONSTRAINED if (soft and fell_back) else None)
        elif len(picked) == 1:
            entries.append(picked[0])
        else:
            entries.append(picked)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry, as a tuple (empty when the dim
    is replicated)."""
    if entry is None or entry is UNCONSTRAINED:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _is_spec(x) -> bool:
    return hasattr(x, "axes") and hasattr(x, "shape")


def tree_shardings(spec_tree: Any, mesh,
                   rules: ShardingRules = DEFAULT_RULES) -> Any:
    """A tree of specs (``.shape`` + ``.axes``) -> the same tree of
    ``logical_spec`` tuples; dicts, lists and tuples are walked."""
    if _is_spec(spec_tree):
        return logical_spec(spec_tree.axes, spec_tree.shape, mesh, rules)
    if isinstance(spec_tree, dict):
        return {k: tree_shardings(v, mesh, rules)
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(tree_shardings(v, mesh, rules)
                               for v in spec_tree)
    raise TypeError(f"not a spec tree node: {type(spec_tree)}")
