"""The named collectives of the port's explicit SPMD, over the axes of a
``launch.mesh.Mesh``, and their ``autograd.Function``s.

The reference gets its collectives from GSPMD (and writes a few in
``shard_map`` bodies).  The port's products are custom autograd
Functions (``LinearFn``, ``FlashAttentionFn``) that no tensor-
propagation layer can see through, so each collective is written where
the sharded layout needs it:

* ``Gather`` - forward an all-gather along a dim; backward a reduce-
  scatter (the gathered tensor fed work that is *split* over the axes:
  FSDP storage gathered over ``data``, a KV projection gathered over
  ``model`` before its heads are split) or this rank's slice of the
  gradient (``split=False``: the work was *duplicated* on every rank of
  the axes, so each holds the whole gradient already).
* ``Reduce`` - forward a sum (the row-parallel partial products, in
  f32), backward the identity: the Megatron "g".
* ``Fanout`` - forward the identity, backward a sum: an input that
  enters work split over the axes (the Megatron "f").
* ``Scatter`` - forward a reduce-scatter (partial products summed, this
  rank's piece of the output kept), backward an all-gather: the dual of
  ``Gather``, for a product whose input dim is split over the axes but
  whose consumer reads only this rank's slice of the output.
* ``Split`` - forward this rank's piece of a tensor every rank of the
  axes holds whole (no communication), backward an all-gather: the dual
  of ``Gather(split=False)``, where work duplicated over the axes hands
  each rank its own rows (sequence parallelism's exit from a block whose
  work does not split).

Every collective over axes of one rank is the identity and moves
nothing, so a ``(1, 1)`` mesh runs exactly the single-device arithmetic.
Sums are taken in f32 (bf16 inputs upcast, the result cast back).

**gloo on a card.**  NCCL refuses two ranks on one device, so ranks
co-located on a card talk over gloo.  gloo's CUDA paths differ from op
to op, so every gloo collective on a CUDA tensor is staged: the buffer
is copied into pinned host memory, the collective runs there, and the
result is copied back to the card.  This is the transport, not a
fallback: the arithmetic before and after stays on the card.  gloo
moves bf16 as f32 (a widening that every value survives exactly).
NCCL collectives run on the device buffers as they are.

**A dry mesh** (``launch/mesh.py``: ``backend="dry"``, device
``meta``) runs no collective: each function takes the NCCL path's
buffers (a sum in f32, a gather in the tensor's own dtype, a
reduce-scatter as one) and returns meta tensors of the result's shape
and dtype, and reports to the dry run's counter
(``cost.py``) the bytes each device puts on the wire, with
the reference's ring factors (``repro.launch.hlo_cost``): an
all-reduce 2 size (n - 1) / n, an all-gather its result (n - 1) / n, a
reduce-scatter its result (n - 1).
"""
from __future__ import annotations

import time
from typing import Sequence

import torch
import torch.distributed as dist

from .. import cost as op_cost

__all__ = ["all_gather", "all_reduce", "reduce_scatter", "Gather", "Reduce",
           "Fanout", "Scatter", "Split", "gather", "reduce", "fanout",
           "scatter", "split", "stats", "reset_stats"]

#: bytes each kind of collective took from this rank (its input
#: buffer) since ``reset_stats``; with ``TIMING`` also the seconds
#: spent in it (the device drained before and after each one, which
#: costs the overlap a timed run would otherwise get)
_STATS = {}
TIMING = False


def reset_stats() -> None:
    _STATS.clear()


def stats() -> dict:
    """{kind: {"calls", "bytes", "s"}} since the last ``reset_stats``."""
    return {k: dict(v) for k, v in _STATS.items()}


def _tally(kind: str, t: torch.Tensor, seconds: float) -> None:
    rec = _STATS.setdefault(kind, {"calls": 0, "bytes": 0, "s": 0.0})
    rec["calls"] += 1
    rec["bytes"] += t.numel() * t.element_size()
    rec["s"] += seconds


def _timed(kind: str, t: torch.Tensor, run):
    """``run()``, its bytes (and with ``TIMING`` its wall time) tallied
    under ``kind``."""
    if not TIMING:
        out = run()
        _tally(kind, t, 0.0)
        return out
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = run()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    _tally(kind, t, time.perf_counter() - t0)
    return out


def _run(kind: str, t: torch.Tensor, run, mesh, moved: float) -> None:
    """``run()`` (through ``_timed``); on a dry mesh nothing runs, and
    ``moved``, the bytes this rank puts on the wire, goes to the dry
    run's counter."""
    if mesh.backend == "dry":
        _tally(kind, t, 0.0)
        op_cost.collective(kind.replace("_", "-"), moved)
        return
    _timed(kind, t, run)


def _to_wire(t: torch.Tensor, mesh) -> torch.Tensor:
    """The buffer the backend moves: for gloo a host f32 / integer copy
    (pinned when staged from a card), for NCCL ``t`` itself."""
    if mesh.backend != "gloo":
        return t.contiguous()
    dt = torch.float32 if t.dtype in (torch.bfloat16,
                                      torch.float16) else t.dtype
    if t.is_cuda:
        host = torch.empty(t.shape, dtype=dt, pin_memory=True)
        host.copy_(t)
        return host
    return t.to(dt).contiguous()


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return w.to(device=like.device, dtype=like.dtype)


def all_gather(t: torch.Tensor, mesh, axes: Sequence[str],
               dim: int) -> torch.Tensor:
    """The shards of every rank over ``axes``, concatenated along
    ``dim`` in group order."""
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    w = _to_wire(t, mesh)
    parts = [torch.empty_like(w) for _ in range(n)]

    def run():
        dist.all_gather(parts, w, group=mesh.group(axes))
    _run("all_gather", t, run, mesh,
         w.numel() * w.element_size() * (n - 1))
    return torch.cat([_from_wire(p, t) for p in parts], dim)


def all_reduce(t: torch.Tensor, mesh, axes: Sequence[str],
               op=dist.ReduceOp.SUM, kind: str = "all_reduce") -> torch.Tensor:
    """``op`` over every rank of ``axes`` (a sum in f32 for a bf16
    tensor), on a copy; every rank gets the same bits.  ``kind``: the
    collective it is tallied as (gloo's reduce-scatter runs as one)."""
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    dt = t.dtype
    x = t.float() if dt in (torch.bfloat16, torch.float16) else t.clone()
    w = _to_wire(x, mesh)

    def run():
        dist.all_reduce(w, op=op, group=mesh.group(axes))
    _run(kind, x, run, mesh,
         2 * w.numel() * w.element_size() * (n - 1) / n)
    return _from_wire(w, x).to(dt)


def reduce_scatter(t: torch.Tensor, mesh, axes: Sequence[str],
                   dim: int) -> torch.Tensor:
    """The sum over ``axes`` of ``t``, of which this rank keeps its
    piece along ``dim`` (in f32 for bf16).  NCCL runs a reduce-scatter;
    gloo an all-reduce and a slice (the same sums), tallied as a
    reduce-scatter."""
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    step = t.shape[dim] // n
    i = mesh.axis_index(axes)
    if mesh.backend == "gloo":
        return _piece(all_reduce(t, mesh, axes, kind="reduce_scatter"),
                      dim, i, step)
    dt = t.dtype
    x = t.float() if dt in (torch.bfloat16, torch.float16) else t
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((step,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)

    def run():
        dist.reduce_scatter_tensor(out, x, group=mesh.group(axes))
    _run("reduce_scatter", x, run, mesh,
         out.numel() * out.element_size() * (n - 1))
    return out.movedim(0, dim).to(dt).contiguous()


def _piece(t: torch.Tensor, dim: int, i: int, step: int) -> torch.Tensor:
    """Piece ``i`` of ``step`` along ``dim`` in storage of its own (a
    view returned by an autograd Function could not be written in
    place)."""
    return t.narrow(dim, i * step, step).clone(
        memory_format=torch.contiguous_format)


class Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``axes``; backward a reduce-scatter
    (``split``: the consumer's work is split over the axes) or this
    rank's slice (the consumer's work is duplicated)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, split):
        ctx.mesh, ctx.axes, ctx.dim, ctx.split = mesh, axes, dim, split
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.mesh, ctx.axes, ctx.dim
        if ctx.split:
            return reduce_scatter(g, mesh, axes, dim), None, None, None, None
        step = g.shape[dim] // mesh.axis_size(axes)
        return (g.narrow(dim, mesh.axis_index(axes) * step, step),
                None, None, None, None)


class Reduce(torch.autograd.Function):
    """Sum over ``axes`` (f32 for bf16); backward the identity."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class Fanout(torch.autograd.Function):
    """The identity; backward a sum over ``axes``."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class Scatter(torch.autograd.Function):
    """Sum over ``axes`` keeping this rank's piece along ``dim`` (f32
    for bf16); backward an all-gather along ``dim``."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return reduce_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim),
                None, None, None)


class Split(torch.autograd.Function):
    """This rank's piece along ``dim`` of a tensor every rank of ``axes``
    holds whole; backward an all-gather along ``dim``."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        n = mesh.axis_size(axes)
        step = x.shape[dim] // n
        return _piece(x, dim, mesh.axis_index(axes), step)

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim),
                None, None, None)


def gather(x, mesh, axes, dim: int, split: bool = True):
    axes = tuple(axes)
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return Gather.apply(x, mesh, axes, dim, split)


def reduce(x, mesh, axes):
    axes = tuple(axes)
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return Reduce.apply(x, mesh, axes)


def fanout(x, mesh, axes):
    axes = tuple(axes)
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return Fanout.apply(x, mesh, axes)


def scatter(x, mesh, axes, dim: int):
    axes = tuple(axes)
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return Scatter.apply(x, mesh, axes, dim % x.dim())


def split(x, mesh, axes, dim: int):
    axes = tuple(axes)
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return Split.apply(x, mesh, axes, dim % x.dim())
