"""Training meshes over ``torch.distributed``: the reference's
``repro.launch.mesh`` (``make_mesh``, ``make_production_mesh``,
``make_local_mesh``) and the counterpart of its ``with mesh:``.

One process a rank.  A :class:`Mesh` is this rank's view of a named
grid of ranks (``("data", "model")``, or ``("pod", "data", "model")``
for the multi-pod mesh), laid out row-major over the global ranks as
``jax.make_mesh`` lays out devices: the last axis varies fastest.  It
holds one process group for every set of axes (the ranks that share
every other coordinate), so a collective "over ``model``" or "over
``("pod", "data")``" runs in the group of this rank's row; a group's
ranks are ordered by global rank, so a tuple of axes indexes its
shards first-axis-major, as a ``PartitionSpec`` entry does.

``with mesh:`` makes it the current mesh (``current_mesh()``), which the
models and the train step read, as the reference's components read
``_current_mesh``.  Parameters, optimizer state, caches and batches are
the rank's shards: ``mesh.shard(full, spec)`` cuts one by a
``sharding.logical_spec`` tuple, ``mesh.unshard(shard, spec)`` gathers
it back.

**Transport.**  Each rank computes on its own device: ``cuda:{LOCAL_RANK}``
as ``torchrun`` sets it, or the device of its index in a list handed to
``make_mesh``.  The backend is chosen up front from that list: NCCL when
every rank has a card of its own, gloo when ranks share a device (NCCL
refuses two ranks on one card) or compute on the CPU.  A gloo
collective on CUDA tensors is staged through pinned host memory (see
``sharding/collectives.py``); the arithmetic stays on the card.
``device_plan(n)`` lays out ``n`` ranks (or tensor-parallel shards) on
the visible cards: one card each where there are enough, else all on
``cuda:0``.

A one-rank mesh needs no process group: every collective over it is
the identity, so a ``(1, 1)`` mesh computes what no mesh computes.

**The dry mesh** (``make_dry_mesh``, ``backend="dry"``) is one rank's
view of a mesh of any shape, the production ones included, with no
world behind it: its device is ``meta``, it joins no process group,
and its collectives (``sharding/collectives.py``) return meta tensors
of the right shape and count the bytes the NCCL path would move.  The
dry run (``launch/dryrun.py``) traces a step on it.
"""
from __future__ import annotations

import datetime
import math
import os
from itertools import combinations, product
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..sharding.collectives import all_gather
from ..sharding.rules import spec_axes

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "make_local_mesh",
           "make_dry_mesh", "current_mesh", "init_distributed",
           "choose_backend", "device_plan"]

#: the reference's production meshes: (data, model), and 2 pods of them
PRODUCTION_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)

_STACK: List["Mesh"] = []


def current_mesh() -> Optional["Mesh"]:
    """The innermost ``with mesh:``, or None."""
    return _STACK[-1] if _STACK else None


def choose_backend(devices: Sequence) -> str:
    """NCCL when every rank computes on a card of its own; gloo when
    ranks share a device or compute on the CPU."""
    devs = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devs):
        return "gloo"
    return "nccl" if len(set(map(str, devs))) == len(devs) else "gloo"


def device_plan(n: int) -> tuple:
    """(devices, backend) of ``n`` ranks or shards: ``cuda:r`` for the
    r-th where at least ``n`` cards are visible (NCCL), else every one
    on ``cuda:0`` (gloo; the ranks time-share the card).  Never a mix:
    with too few cards for one each, none gets a card of its own."""
    if torch.cuda.device_count() >= n:
        devices = [torch.device("cuda", r) for r in range(n)]
    else:
        devices = [torch.device("cuda", 0)] * n
    return devices, choose_backend(devices)


def _env_rank() -> int:
    return int(os.environ.get("RANK", "0"))


def init_distributed(backend: str, *, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> None:
    """Join the default process group over ``backend``; ``rank``,
    ``world_size`` and ``init_method`` default to torchrun's
    environment, ``timeout_s`` (a collective's longest wait) to the
    backend's.  A group already joined must run ``backend``."""
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs "
                             f"{dist.get_backend()}; this mesh needs "
                             f"{backend}")
        return
    extra = ({} if timeout_s is None else
             {"timeout": datetime.timedelta(seconds=timeout_s)})
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=_env_rank() if rank is None else rank,
        world_size=(int(os.environ.get("WORLD_SIZE", "1"))
                    if world_size is None else world_size), **extra)


class Mesh:
    """This rank's view of a ``shape`` grid of ranks named
    ``axis_names`` (see the module docstring).  Build it with
    ``make_mesh``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device, rank: int = 0, backend: Optional[str] = None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not name "
                             f"{self.axis_names}")
        self.size = math.prod(self.shape)
        self.rank = rank
        self.device = torch.device(device)
        self.backend = backend
        strides = [math.prod(self.shape[i + 1:])
                   for i in range(len(self.shape))]
        self.coords = {a: rank // st % n for a, st, n in
                       zip(self.axis_names, strides, self.shape)}
        self._groups: Dict[tuple, object] = {}
        if self.size > 1 and backend != "dry":
            self._make_groups(strides)

    def _make_groups(self, strides) -> None:
        """One group for every non-empty set of axes; every rank calls
        ``new_group`` for every group, in one order."""
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for axes in combinations(range(len(names)), k):
                key = tuple(names[i] for i in axes)
                if k == len(names):
                    self._groups[key] = dist.group.WORLD
                    continue
                rest = [i for i in range(len(names)) if i not in axes]
                for fixed in product(*(range(self.shape[i]) for i in rest)):
                    base = sum(c * strides[i] for c, i in zip(fixed, rest))
                    ranks = sorted(
                        base + sum(c * strides[i] for c, i in zip(var, axes))
                        for var in product(*(range(self.shape[i])
                                             for i in axes)))
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[key] = g

    # ------------------------------------------------------------ axes
    def axis_size(self, axes) -> int:
        """The number of ranks over ``axes`` (a name or a tuple of
        names; names the mesh lacks count 1)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[self.axis_names.index(a)]
                         for a in axes if a in self.axis_names)

    def axis_index(self, axes) -> int:
        """This rank's index over ``axes``, the first axis major."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            if a in self.axis_names:
                idx = idx * self.axis_size(a) + self.coords[a]
        return idx

    def group(self, axes):
        """The process group of this rank's row over ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        return self._groups[key]

    def data_axes(self) -> tuple:
        """The batch's axes on this mesh (``("pod", "data")`` where
        present)."""
        return tuple(a for a in ("pod", "data") if a in self.axis_names)

    # ----------------------------------------------------------- shards
    def shard(self, full: torch.Tensor, spec) -> torch.Tensor:
        """This rank's piece of ``full`` under a ``logical_spec`` tuple,
        on the mesh's device.  A leaf stored with fewer dims than its
        spec (RWKV6's stacked ``w0``) is replicated and taken whole."""
        t = full
        for dim, entry in enumerate(spec):
            axes = spec_axes(entry)
            n = self.axis_size(axes)
            if n == 1:
                continue
            size = t.shape[dim]
            if size % n:
                raise ValueError(f"dim {dim} of {tuple(full.shape)} does "
                                 f"not split over {axes}")
            step = size // n
            t = t.narrow(dim, self.axis_index(axes) * step, step)
        return t.to(self.device).contiguous()

    def unshard(self, shard: torch.Tensor, spec) -> torch.Tensor:
        """The full array of a shard under ``spec`` (a gather over every
        sharded dim; every rank of the dim's axes must call it)."""
        t = shard
        for dim, entry in enumerate(spec):
            axes = spec_axes(entry)
            if self.axis_size(axes) > 1:
                t = all_gather(t, self, axes, dim)
        return t

    # ---------------------------------------------------------- context
    def __enter__(self) -> "Mesh":
        _STACK.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _STACK.remove(self)

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in
                         zip(self.axis_names, self.shape))
        return f"Mesh({dims}; rank {self.rank} on {self.device})"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """The mesh ``shape`` x ``axes`` over the world's ranks.

    ``devices`` lists every rank's device (co-located ranks name the
    same card, the tests name ``"cpu"``) and with it the backend
    (``choose_backend``); by default each rank takes
    ``cuda:{LOCAL_RANK}`` over NCCL.  Joins the default process group
    (torchrun's environment) when it has not been joined; the world
    must hold exactly the mesh's ranks.  A one-rank mesh needs no
    group."""
    n = math.prod(shape)
    if devices is not None and len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a mesh of {n} ranks")
    if n == 1 and not dist.is_initialized():
        return Mesh(shape, axes, resolve_device(
            None if devices is None else devices[0]))
    backend = "nccl" if devices is None else choose_backend(devices)
    init_distributed(backend)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the "
                         f"world has {world}")
    rank = dist.get_rank()
    dev = torch.device(
        f"cuda:{os.environ.get('LOCAL_RANK', '0')}" if devices is None
        else devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(shape, axes, dev, rank, backend)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """The reference's production mesh: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``.
    Refuses a world of another size: it never shrinks the mesh."""
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks (torchrun "
                         f"--nproc-per-node x --nnodes); this world has "
                         f"{world}")
    return make_mesh(shape, axes, devices)


def make_dry_mesh(shape: Sequence[int], axes: Sequence[str],
                  rank: int = 0) -> Mesh:
    """Rank ``rank``'s view of a ``shape`` x ``axes`` mesh with no world
    behind it (the module docstring's dry mesh): device ``meta``, no
    process group, collectives that move nothing."""
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} is not in a {tuple(shape)} mesh")
    return Mesh(shape, axes, "meta", rank, backend="dry")


def make_local_mesh(model: int = 1, *,
                    devices: Optional[Sequence] = None) -> Mesh:
    """``(world / model, model)`` over ``("data", "model")``: the world
    is torchrun's (``WORLD_SIZE``), or ``len(devices)``."""
    world = (len(devices) if devices is not None
             else dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world % model:
        raise ValueError(f"model={model} does not divide {world} ranks")
    return make_mesh((world // model, model), ("data", "model"), devices)
