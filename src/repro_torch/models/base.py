"""Parameter specs and seeded initialization.

A model's parameters are declared once as a nested dict of
:class:`ParamSpec` (shape + logical axes + initializer), laid out exactly like
the reference's parameter tree so the weight bridge
(``checkpoint/bridge.py``) is a key-for-key copy.  The initializers
draw from the reference's *distributions* (``fan_in`` normal,
``normal(0.02)`` embeddings, zero RMSNorm scales, one LayerNorm
scales, zero biases, uniform gates and mixes), not its bits:
``jax.random`` and ``torch.Generator`` give different numbers from one
seed.  Every leaf is drawn in f32 and stored in its spec's ``dtype``:
f32, or ``cfg.param_dtype`` where ``with_param_dtype`` retagged it.
The logical axes (one name a dim, the reference's) place a leaf on a
mesh (``sharding.tree_shardings``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, Optional, Sequence, Tuple

import torch

__all__ = ["ParamSpec", "normal", "fan_in", "zeros", "ones", "uniform",
           "linspace_first_axis", "flatten_specs", "map_specs",
           "with_param_dtype",
           "init_params"]

InitFn = Callable[[torch.Generator, tuple, torch.device], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                       # logical dim names, shape's rank
    init: Optional[InitFn] = None     # None -> fan_in(shape)
    #: a weight that enters its product in f32 (a router, RG-LRU's
    #: gates, RWKV6's decay projection): never cast to the compute
    #: dtype; stored in ``dtype`` all the same, upcast at use
    f32: bool = False
    #: storage dtype (``with_param_dtype``)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"rank mismatch: {self.shape} vs {self.axes}")

    @property
    def init_shape(self) -> tuple:
        """The shape of the tensor the initializer makes: ``shape``,
        except for ``linspace_first_axis``, which makes its first axis
        only (as the reference's does)."""
        if getattr(self.init, "first_axis_only", False):
            return tuple(self.shape[:1])
        return tuple(self.shape)


def normal(stddev: float) -> InitFn:
    def f(gen, shape, device):
        # scaled in place: no second tensor of the leaf's size
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(stddev)
    return f


def fan_in(shape: Sequence[int]) -> InitFn:
    """Normal with 1/sqrt(fan_in) scale, fan_in = every dim but the
    last (for layer-stacked weights that includes the layer axis,
    exactly as the reference's ``models/base.py:fan_in`` counts it)."""
    fi = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
    return normal(1.0 / math.sqrt(max(fi, 1)))


def uniform(lo: float = 0.0, hi: float = 1.0) -> InitFn:
    def f(gen, shape, device):
        return torch.rand(shape, generator=gen, dtype=torch.float32,
                          device=device).mul_(hi - lo).add_(lo)
    return f


def linspace_first_axis(lo: float, hi: float) -> InitFn:
    """``linspace(lo, hi, shape[0])`` of shape ``(shape[0],)`` only: the
    reference draws RWKV6's decay offset ``w0`` so, and when the leaf is
    stacked over layers that gives one offset per layer (a scalar each,
    broadcast over the channels), not one per channel."""
    def f(gen, shape, device):
        return torch.linspace(lo, hi, shape[0], dtype=torch.float32,
                              device=device)
    f.first_axis_only = True
    return f


def zeros(gen, shape, device):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def ones(gen, shape, device):
    return torch.ones(shape, dtype=torch.float32, device=device)


def flatten_specs(tree, prefix: Tuple[str, ...] = ()
                  ) -> Iterator[Tuple[Tuple[str, ...], ParamSpec]]:
    """(path, spec) pairs in sorted-key order (the reference's pytree
    flattening order)."""
    if isinstance(tree, ParamSpec):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from flatten_specs(tree[k], prefix + (k,))


def map_specs(fn, tree):
    """``fn`` over every ``ParamSpec`` of a nested dict, as a tree of
    the same keys."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    return {k: map_specs(fn, v) for k, v in tree.items()}


def with_param_dtype(spec_tree, dtype: str):
    """The reference's ``with_param_dtype``: every f32 leaf of 2 or more
    dimensions *as specified* (a stacked norm scale or bias included)
    retagged to ``dtype`` ("bfloat16": bf16 storage); the 1-D leaves
    stay f32.  ``f32`` leaves are retagged too, as the reference's are:
    their products read an upcast of the stored bits."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    if dt == torch.float32:
        return spec_tree

    def retag(ps):
        if ps.dtype == torch.float32 and len(ps.shape) >= 2:
            return dataclasses.replace(ps, dtype=dt)
        return ps
    return map_specs(retag, spec_tree)


def init_params(spec_tree, seed: int, device: torch.device,
                cast: Optional[Callable] = None) -> dict:
    """Initialize a ParamSpec tree from one seeded generator on
    ``device``, leaves drawn in sorted-path order.  ``cast(path, spec,
    tensor)``, when given, maps each leaf as soon as it is drawn (the
    serving programs' bf16 projections, so that a large model never
    holds all of its f32 weights at once); the draws do not change.
    Each leaf is drawn in f32 and stored in its spec's ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out: dict = {}
    for path, ps in flatten_specs(spec_tree):
        init = ps.init if ps.init is not None else fan_in(ps.shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        leaf = init(gen, tuple(ps.shape), device).to(ps.dtype)
        node[path[-1]] = leaf if cast is None else cast(path, ps, leaf)
    return out
