"""The device-buffer (NCCL) branch of ``sharding/collectives.py`` held
bit for bit against its gloo branch, on the CPU.

On a card the port's collectives take one of two branches by the
mesh's backend: gloo stages each buffer through host memory and takes
a reduce-scatter as an all-reduce and a slice; NCCL moves the device
buffers as they are and runs ``dist.reduce_scatter_tensor`` on the
scattered dim moved to the front.  This CPU's gloo runs
``reduce_scatter_tensor`` too, so one gloo group of 4 ranks builds two
(2, 2) meshes over the same ranks, one naming each branch, and runs
every collective and the forward and backward of every autograd
Function through both: f32 inputs of integer values (every sum exact,
whatever its order), every dim of a 3-D tensor, over ``model`` and
over ``("data", "model")``.  The plain collectives are also held
against their results computed from every rank's input.  One spawn.
"""
import math

import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.launch.mesh import Mesh, init_distributed, make_mesh
from repro_torch.sharding import collectives as coll

MESH, AXES = (2, 2), ("data", "model")
SHAPE = (4, 8, 12)                   # every dim splits over 4 ranks
GROUPS = (("model",), ("data", "model"))
CASES = ("all_gather", "all_reduce", "reduce_scatter", "Gather_split",
         "Gather_duplicated", "Reduce", "Fanout", "Scatter", "Split")


def _draw(rank: int, what: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(1000 * what + rank)
    return torch.randint(-64, 64, SHAPE, generator=g).float()


def _group_ranks(mesh, axes) -> list:
    """The global ranks of this rank's group over ``axes``, group
    order."""
    return [r for r in range(mesh.size)
            if all(r // math.prod(mesh.shape[i + 1:]) % n == mesh.coords[a]
                   for i, (a, n) in enumerate(zip(mesh.axis_names,
                                                  mesh.shape))
                   if a not in axes)]


def _run(mesh, case, axes, dim):
    """(forward, backward or None) of ``case`` on this rank's inputs."""
    x = _draw(mesh.rank, 0)
    if case == "all_gather":
        return coll.all_gather(x, mesh, axes, dim), None
    if case == "all_reduce":
        return coll.all_reduce(x, mesh, axes), None
    if case == "reduce_scatter":
        return coll.reduce_scatter(x, mesh, axes, dim), None
    n = mesh.axis_size(axes)
    fn = {"Gather_split": lambda t: coll.gather(t, mesh, axes, dim, True),
          "Gather_duplicated": lambda t: coll.gather(t, mesh, axes, dim,
                                                     False),
          "Reduce": lambda t: coll.reduce(t, mesh, axes),
          "Fanout": lambda t: coll.fanout(t, mesh, axes),
          "Scatter": lambda t: coll.scatter(t, mesh, axes, dim),
          "Split": lambda t: coll.split(t, mesh, axes, dim)}[case]
    x = x.requires_grad_()
    y = fn(x)
    shape = list(SHAPE)
    if case.startswith("Gather"):
        shape[dim] *= n
    elif case in ("Scatter", "Split"):
        shape[dim] //= n
    g = _draw(mesh.rank, 1)
    g = g.repeat(*[n if d == dim else 1 for d in range(3)])[
        tuple(slice(0, s) for s in shape)]
    y.backward(g)
    return y.detach(), x.grad


def _expected(mesh, case, axes, dim) -> torch.Tensor:
    """The plain collective's result from every rank's input."""
    xs = [_draw(r, 0) for r in _group_ranks(mesh, axes)]
    if case == "all_gather":
        return torch.cat(xs, dim)
    total = torch.stack(xs).sum(0)
    if case == "all_reduce":
        return total
    step = SHAPE[dim] // len(xs)
    return total.narrow(dim, mesh.axis_index(axes) * step, step)


def _entry(rank, world, tmp) -> None:
    torch.set_num_threads(1)
    init_distributed("gloo", rank=rank, world_size=world,
                     init_method=f"file://{tmp}/store", timeout_s=120)
    staged = make_mesh(MESH, AXES, devices=["cpu"] * world)
    direct = Mesh(MESH, AXES, "cpu", rank, backend="nccl")
    assert staged.backend == "gloo"
    out = {}
    for case in CASES:
        for axes in GROUPS:
            for dim in range(3):
                a = _run(staged, case, axes, dim)
                b = _run(direct, case, axes, dim)
                ok = all((u is None and v is None) or (
                    u.dtype == v.dtype and u.shape == v.shape
                    and torch.equal(u, v)) for u, v in zip(a, b))
                if case in ("all_gather", "all_reduce", "reduce_scatter"):
                    ok = ok and torch.equal(b[0], _expected(direct, case,
                                                            axes, dim))
                out[case, axes, dim] = ok
    torch.save(out, f"{tmp}/out_{rank}.pt")


@pytest.fixture(scope="module")
def branches(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    world = math.prod(MESH)
    mp.spawn(_entry, args=(world, str(tmp)), nprocs=world, join=True)
    return [torch.load(tmp / f"out_{r}.pt") for r in range(world)]


@pytest.mark.parametrize("case", CASES)
def test_nccl_branch_equals_gloo_branch(branches, case):
    """On every rank, every dim and both groups, the device-buffer
    branch gives the gloo branch's forward (and input gradient) bit for
    bit, and a plain collective gives the sums and pieces of every
    rank's input."""
    for out in branches:
        bad = [k for k, ok in out.items() if k[0] == case and not ok]
        assert not bad and any(k[0] == case for k in out)
