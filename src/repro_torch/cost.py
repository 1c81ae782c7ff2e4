"""The dry run's cost counter and the card's datasheet numbers: the
counterpart of the reference's ``launch/hlo_cost.py`` and
``hlo_stats.py``, over the ops a step dispatches instead of over
compiled HLO, and of its ``launch/mesh.py:Hardware``.  A leaf module:
it imports nothing of the package, so the kernel wrappers and the
collectives report to it without pulling in the launchers.

``OpCounter`` is a ``TorchDispatchMode``.  Entered around a step whose
tensors live on ``meta`` (``launch/dryrun.py``), it sees every aten op
the step runs eagerly and fills an ``OpCost`` with the reference's
``HloCost`` fields:

* **flops** - matmuls and convolutions by ``torch.utils.flop_counter``'s
  formulas (the cuBLAS unembedding, the MoE's expert einsums); an
  elementwise op 1 a output element (``hlo_cost._ELEMENTWISE``); a
  reduction 1 an input element; a scatter 1 an update element.
* **transcendentals** - exp, log, tanh, sigmoid, rsqrt, sqrt, erf, sin,
  cos and pow (and the activations and softmaxes built on them), one an
  output element; each also counts 1 flop, as in ``hlo_cost``.
* **bytes** - every op's tensor inputs and outputs on the device: in
  eager every op is a kernel that reads and writes device memory.
  Views and metadata ops count zero; an in-place op counts what it
  reads and its update (a scatter three times its update, a gather
  twice its output, plus the indices, as ``hlo_cost`` counts them).
* **coll_bytes / coll_ops** by kind - the bytes each device puts on the
  wire, from the dry mesh's collectives (``sharding/collectives.py``,
  ``collective``).
* **kernels** - the hand-written kernels' launches, flops and bytes,
  reported by their wrappers' shape-only branch (``kernel``); the ops
  of a wrapper's plain path never run there, so nothing is counted
  twice.

It also tracks the device bytes alive at once and their **peak**: a
storage counts from the op that creates it until it is freed (a view
shares its base's storage, counted once).  Meta storages all report
``data_ptr() == 0``, so storages are keyed by identity: torch keeps a
storage's Python object for as long as the storage lives, and a
``weakref.finalize`` on it says when it is freed.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Iterable

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

__all__ = ["OpCost", "OpCounter", "COLL_KINDS", "kernel", "collective",
           "Hardware", "HW"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One NVIDIA H100 SXM5 80 GB, from NVIDIA's datasheet (dense rates,
    no sparsity, at the 700 W limit): the roofline constants of the
    dry run, in the fields of the reference's TPU ``Hardware`` (none of
    whose values is kept).

    ``peak_flops_bf16`` and ``hbm_bw`` are the bounds the kernel table
    of PERF.md uses.  ``ici_link_bw`` is the bandwidth one GPU puts on
    the wire for a collective of the production mesh: one 400 Gb/s NDR
    InfiniBand port a GPU, since both 16-wide axes of (16, 16) span
    more than one 8-GPU NVLink node; ``nvlink_bw`` (NVLink 4, per
    direction) is kept beside it for collectives inside a node.
    ``n_sm`` is what the f32 GEMM's plan is made for on ``meta``."""
    peak_flops_bf16: float = 989e12       # FLOP/s, dense bf16
    hbm_bw: float = 3.35e12               # B/s
    ici_link_bw: float = 50e9             # B/s, one NDR port a GPU
    hbm_bytes: float = 80e9               # capacity per card
    n_sm: int = 132
    nvlink_bw: float = 450e9              # B/s per direction


HW = Hardware()

COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute")

#: ops whose every output element costs one transcendental (and 1 flop)
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "sigmoid", "rsqrt", "sqrt", "erf", "erfc", "erfinv", "sin", "cos",
    "pow", "silu", "gelu", "softplus", "_softmax", "_log_softmax",
    "silu_backward", "gelu_backward", "softplus_backward", "logsumexp",
}
#: reductions: 1 flop an input element
_REDUCTION = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all",
    "argmax", "argmin", "norm", "linalg_vector_norm", "cumsum", "cumprod",
    "var", "std", "var_mean", "std_mean", "logsumexp", "_softmax",
    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
}
#: reads of indexed rows: twice the output and the indices
_GATHER = {"index", "index_select", "gather", "embedding",
           "take_along_dim"}
#: indexed writes: three times the update and the indices
_SCATTER = {"index_put", "index_put_", "_index_put_impl_", "scatter",
            "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
            "scatter_reduce_", "index_add", "index_add_", "index_copy",
            "index_copy_", "embedding_dense_backward"}
#: allocations that write nothing
_UNWRITTEN = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "empty_permuted"}


@dataclasses.dataclass
class OpCost:
    """Per-device work of one traced step: ``hlo_cost.HloCost``'s fields
    and the hand-written kernels' share (``kernels``: name ->
    {"launches", "flops", "bytes"})."""
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLL_KINDS})
    coll_ops: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLL_KINDS})
    kernels: Dict[str, dict] = dataclasses.field(default_factory=dict)

    @property
    def coll_total(self) -> float:
        return sum(self.coll_bytes.values())


def _nbytes(t: torch.Tensor) -> int:
    """Bytes a kernel reads or writes for ``t``: its elements, a
    broadcast (stride 0) dim counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


class OpCounter(TorchDispatchMode):
    """Counts the ops run on ``meta`` tensors under ``with OpCounter()
    as c:`` into ``c.cost``, and the live meta bytes into ``c.live`` /
    ``c.peak``.  ``track(tensors)`` counts tensors made before the mode
    was entered (a step's arguments) as live."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}
        # the memo of ``_run``: the results' (shape, stride, dtype) of
        # the fresh-writing ops this counter has run, by op and the
        # metadata of their arguments, and the ops seen to return a
        # tensor that shares an argument's storage
        self._shapes: Dict[tuple, object] = {}
        self._aliasing: set = set()

    # ------------------------------------------------------------ memory
    def _storage(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._seen:
            return
        n = s.nbytes()
        self._seen[key] = n
        self.live += n
        weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def track(self, tensors: Iterable[torch.Tensor]) -> None:
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.is_meta:
                self._storage(t)
        self.peak = max(self.peak, self.live)

    # --------------------------------------------------------- reporting
    def add_kernel(self, name: str, flops: float, n_bytes: float,
                   also: tuple = ()) -> None:
        self.cost.flops += flops
        self.cost.bytes += n_bytes
        for k in (name,) + tuple(also):
            rec = self.cost.kernels.setdefault(
                k, {"launches": 0, "flops": 0.0, "bytes": 0.0})
            rec["launches"] += 1
            rec["flops"] += flops
            rec["bytes"] += n_bytes

    def add_collective(self, kind: str, moved: float) -> None:
        self.cost.coll_bytes[kind] += moved
        self.cost.coll_ops[kind] += 1

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _kind(func)
        ins = _meta_tensors(args) + _meta_tensors(kwargs.values())
        out, fresh = self._run(func, kind, args, kwargs, ins)
        outs = _meta_tensors(out if isinstance(out, (list, tuple))
                             else (out,))
        if not ins and not outs:
            return out
        for t in ins:
            self._storage(t)
        for t in outs:
            self._storage(t)
        if self.live > self.peak:
            self.peak = self.live
        self._count(func, kind, args, kwargs, out, ins, outs, fresh)
        return out

    def _run(self, func, kind, args, kwargs, ins):
        """``func(*args, **kwargs)`` on meta tensors.  The meta kernels
        of most ops are Python (``torch._refs``) and cost 0.1-0.7 ms a
        call, many times a whole step's shape logic; an op that writes
        fresh tensors gives results whose shapes, strides and dtypes
        are a function of its arguments' metadata, so a repeat (the
        next layer, the next microbatch) allocates them directly.  That
        holds on ``meta``, where no values exist, for an op whose
        arguments are meta tensors and plain values (``_key`` refuses a
        generator or a tensor elsewhere); the memo lives as long as
        this counter, one traced step.  Views, in-place ops and ops
        that ever returned an argument's storage always run.  Returns
        (the results, whether they are known to be fresh)."""
        if kind[1] or kind[2] == "view" or func in self._aliasing:
            return func(*args, **kwargs), False
        try:
            key = (func, _key(args), _key(kwargs.values()), tuple(kwargs))
        except TypeError:
            return func(*args, **kwargs), False
        got = self._shapes.get(key)
        if got is not None:
            if isinstance(got, list):
                return [_empty(g) for g in got], True
            if isinstance(got[0], list):
                return tuple(_empty(g) for g in got[0]), True
            return _empty(got), True
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else (out,)
        if not all(isinstance(t, torch.Tensor) and t.is_meta
                   and t.storage_offset() == 0 for t in outs):
            return out, False
        srcs = {id(t.untyped_storage()) for t in ins}
        if any(id(t.untyped_storage()) in srcs for t in outs):
            self._aliasing.add(func)
            return out, False
        specs = [(t.shape, t.stride(), t.dtype) for t in outs]
        self._shapes[key] = (specs if isinstance(out, list) else
                             (specs,) if isinstance(out, tuple)
                             else specs[0])
        return out, True

    def _count(self, func, kind, args, kwargs, out, ins, outs,
               fresh) -> None:
        name, written, work = kind
        mutates = bool(written)
        if work == "view" or (not (mutates or fresh)
                              and _all_alias(ins, outs)):
            return                                   # views, metadata
        c = self.cost
        if work == "matmul":
            c.flops += flop_counter.flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        elif work == "transcendental":
            n = sum(t.numel() for t in outs)
            c.transcendentals += n
            c.flops += n
        elif work in ("reduction", "softmax"):
            n = _numel(args[0]) if args else 0
            c.flops += n
            if work == "softmax":                    # an exp an element
                c.transcendentals += n
        elif work == "scatter":
            c.flops += _numel(_update_arg(name, args, kwargs))
        elif work == "pointwise":
            c.flops += sum(t.numel() for t in outs)
        # bytes
        if name in _UNWRITTEN:
            return
        if work == "gather":
            idx = sum(_nbytes(t) for t in ins[1:]
                      if not t.is_floating_point())
            c.bytes += 2 * sum(_nbytes(t) for t in outs) + idx
        elif work == "scatter":
            upd = _update_arg(name, args, kwargs)
            idx = sum(_nbytes(t) for t in ins
                      if not t.is_floating_point() and t.dim() and
                      t is not args[0])
            c.bytes += 3 * (_nbytes(upd) if upd is not None else 0) + idx
        elif name in _FILLS:
            c.bytes += sum(_nbytes(t) for t in outs)
        elif name == "copy_":
            c.bytes += _nbytes(args[1]) + _nbytes(args[0])
        elif mutates:
            outs_kw = [kwargs[n] for n in written if n in kwargs]
            if outs_kw:                     # out=: its inputs, then out
                c.bytes += sum(_nbytes(t) for t in ins
                               if all(t is not o for o in outs_kw))
                c.bytes += sum(_nbytes(t) for t in outs_kw)
            else:                           # in place: read, write self
                c.bytes += sum(_nbytes(t) for t in ins) + _nbytes(ins[0])
        else:
            c.bytes += (sum(_nbytes(t) for t in ins)
                        + sum(_nbytes(t) for t in outs))


#: writes of a value: their output only
_FILLS = {"fill_", "zero_", "fill", "zeros", "ones", "full", "zeros_like",
          "ones_like", "full_like", "arange", "scalar_tensor", "rand",
          "randn", "rand_like", "randn_like", "linspace"}

_KINDS: Dict[object, tuple] = {}


def _kind(func) -> tuple:
    """(name, the arguments it writes, what its work is) of an aten op,
    worked out once per op."""
    got = _KINDS.get(func)
    if got is None:
        schema = func._schema
        name = schema.name.split("::")[-1]
        written = tuple(a.name for a in schema.arguments
                        if a.alias_info is not None
                        and a.alias_info.is_write)
        if not written and (func.is_view or any(
                r.alias_info is not None for r in schema.returns)):
            work = "view"
        elif func._overloadpacket in flop_counter.flop_registry:
            work = "matmul"
        elif name in _REDUCTION:
            work = "softmax" if name in _TRANSCENDENTAL else "reduction"
        elif name in _TRANSCENDENTAL:
            work = "transcendental"
        elif name in _SCATTER:
            work = "scatter"
        elif name in _GATHER:
            work = "gather"
        elif torch.Tag.pointwise in func.tags:
            work = "pointwise"
        else:
            work = "other"
        got = _KINDS[func] = (name, written, work)
    return got


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


def _key(xs) -> tuple:
    """A hashable key of the metadata of an op's arguments, or raise
    TypeError for one it cannot key (a generator, a non-meta
    tensor)."""
    key = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            if not x.is_meta:
                raise TypeError
            key.append((x.shape, x.stride(), x.dtype, x.storage_offset()))
        elif isinstance(x, (list, tuple)):
            key.append(_key(x))
        elif isinstance(x, _PLAIN):
            key.append((type(x), x))
        else:
            raise TypeError
    return tuple(key)


def _empty(spec) -> torch.Tensor:
    shape, stride, dtype = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _meta_tensors(xs) -> list:
    """The meta tensors among ``xs`` and the lists in it (an aten op's
    arguments or results)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            if x.is_meta:
                out.append(x)
        elif isinstance(x, (list, tuple)):
            out += [t for t in x if isinstance(t, torch.Tensor) and t.is_meta]
    return out


def _all_alias(ins, outs) -> bool:
    """Every output shares an input's storage (a view the schema does
    not mark, as ``split``'s pieces)."""
    if not outs:
        return False
    srcs = {id(t.untyped_storage()) for t in ins}
    return all(id(t.untyped_storage()) in srcs for t in outs)


def _update_arg(name: str, args, kwargs):
    """The tensor an indexed write writes: ``values`` / ``src`` /
    ``source`` (the gradient of an embedding)."""
    if name.startswith(("index_put", "_index_put")):
        return args[2] if len(args) > 2 else kwargs.get("values")
    if name == "embedding_dense_backward":
        return args[0]
    for t in args[2:]:
        if isinstance(t, torch.Tensor):
            return t
    return kwargs.get("src", kwargs.get("source"))


def _counters():
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, OpCounter)]


def kernel(name: str, flops: float, n_bytes: float,
           also: tuple = ()) -> None:
    """One launch of the hand-written kernel ``name`` doing ``flops``
    and moving ``n_bytes``, reported by its wrapper's shape-only branch
    to every active counter; ``also`` names counters the launch counts
    in besides (``gemm_dataflow_f32``, as the wrappers' counters count
    an f32 launch in both)."""
    for m in _counters():
        m.add_kernel(name, flops, n_bytes, also)


def collective(kind: str, moved: float) -> None:
    """One collective of ``kind`` (``COLL_KINDS``) putting ``moved``
    bytes of this device on the wire."""
    if kind not in COLL_KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    for m in _counters():
        m.add_collective(kind, moved)

