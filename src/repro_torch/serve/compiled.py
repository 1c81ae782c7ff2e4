"""The serving programs captured once as CUDA graphs and replayed — the
port's counterpart of the reference's ``jax.jit`` in ``ServePrograms``
(``repro.serve.step``).

The reference compiles each paged program once per input shape and
context bucket, and every later call runs the compiled program.  Here
the first call of a **key** runs the program eagerly (it is the
dispatch itself, and its warm-up: the kernels' builds, the cuBLAS
handles, the kernels' workspaces, the paged kernel's counter buffer),
then the same program is captured into a CUDA graph over graph-owned
static copies of the dispatch's inputs; each later call with that key
copies its inputs into the static buffers and replays the graph.  A
capture runs nothing on the device, so the page pools are written once
a call.

The key is the program, the shapes and dtypes of the per-dispatch
tensors (tokens, page tables, starts, valid counts, lengths) and the
address, shape and dtype of every tensor the graph reads by address:
the parameter leaves and the page pools.  A replaced parameter leaf or
pool is a new key, so a graph never runs over tensors it was not
captured on.  The scheduler already gives the programs fixed shapes
(prefill at (Bp, C) with a doubling context bucket, decode and verify
at (max_batch, T) with the full masked tables), so the keys are the
same finite set the reference compiles.

Each engine binds its own ``GraphedPrograms`` (``ServePrograms.
for_engine``): its own graphs and one memory pool shared by them.
Engines that share one ``ServePrograms`` share its plain functions,
never a graph: a graph is bound to the pool it was captured on, which
the reference's shared jit cache is not.  Every engine on a device
captures on that device's one capture stream, so what a library caches
by stream (cuBLAS's workspace, 32 MiB on an H100; the paged kernel's
counter buffer) is made once, not once an engine: a stream an engine
held 1.0 GB over a smoke run's ~30 engines.

The kernels' Python launch counters (``kernels/*/ops.py``, named by
each module's ``COUNTERS``) tick while a capture runs the program's
Python and not at all on a replay.  So a capture's rise is taken back
and recorded, and each replay adds it (``GraphStats.capturing`` /
``replayed``): the counters read as if every call had run eagerly.

The same machinery replays the reference's other jitted serving
programs: the lockstep decode step (``step.ServePrograms.lockstep``: a
``CompiledProgram`` whose per-dispatch state is ``pos`` and whose cache
is read by address), and the tensor-parallel programs in pieces
(``parallel.PiecewiseProgram``, through ``CudaGraphs.begin`` / ``end``).

On CUDA a failed capture or replay raises; nothing falls back to eager.
``ServePrograms(model, graphs=False)`` is the one way to run eagerly on
the card.  ``capture=`` takes another backend with ``CudaGraphs``'s
``warm`` / ``capture`` (the CPU tests' stand-in runs the program where
the card would capture or replay it).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import Counter
from typing import Callable, Dict, List, Tuple

import torch

from ..kernels.block_sparse import ops as _block_sparse
from ..kernels.flash_attention import ops as _flash
from ..kernels.gemm_dataflow import ops as _gemm
from ..kernels.lut_activation import ops as _lut
from ..kernels.paged_attention import ops as _paged
from ..tree import tree_leaves

__all__ = ["CudaGraphs", "CompiledProgram", "GraphedPrograms",
           "GraphStats", "launch_counts", "set_launch_counts",
           "split_inputs", "graph_key", "nest_map", "tensors_of",
           "POOL_KEYS"]

#: the state entries a graph reads and writes by address (the page
#: pools, written in place); every other state tensor is a per-dispatch
#: input copied into the graph's static buffer
POOL_KEYS = ("k_pages", "v_pages")

_KERNEL_OPS = (_paged, _flash, _gemm, _block_sparse, _lut)


def launch_counts() -> Dict[Tuple[str, str], int]:
    """Every kernel wrapper's launch counters, by (module, counter)."""
    return {(m.__name__, n): getattr(m, n)
            for m in _KERNEL_OPS for n in m.COUNTERS}


def set_launch_counts(counts: Dict[Tuple[str, str], int]) -> None:
    by_name = {m.__name__: m for m in _KERNEL_OPS}
    for (mod, name), n in counts.items():
        setattr(by_name[mod], name, n)


@dataclasses.dataclass
class GraphStats:
    """What the graphs of a program bundle did, summed over its
    engines: graphs captured and replays by program, the seconds the
    captures took (the warm-up calls not included), and the host's
    seconds in the tensor-parallel replays, split between the segments'
    graph launches (``"segments"``) and the gathers' copies
    (``"gathers"``, ``parallel.PiecewiseProgram``).

    ``capturing`` and ``replayed`` keep the launch counters true: a
    capture's rise is taken back, and each replay adds it."""
    captures: Counter = dataclasses.field(default_factory=Counter)
    replays: Counter = dataclasses.field(default_factory=Counter)
    capture_s: float = 0.0
    host_s: Counter = dataclasses.field(default_factory=Counter)

    def as_dict(self) -> dict:
        return {"captures": dict(self.captures),
                "replays": dict(self.replays),
                "capture_s": self.capture_s,
                "host_s": dict(self.host_s)}

    @contextlib.contextmanager
    def capturing(self, name: str):
        """A capture of program ``name`` (a context): the launch
        counters are set back to what they were before it (the capture
        ran the wrappers' Python, not their kernels) and the capture is
        counted and timed.  Yields a dict that then holds the counters'
        rise, which ``replayed`` adds."""
        rise: Dict[Tuple[str, str], int] = {}
        before = launch_counts()
        t0 = time.perf_counter()
        try:
            yield rise
        finally:
            after = launch_counts()
            set_launch_counts(before)
        self.capture_s += time.perf_counter() - t0
        self.captures[name] += 1
        rise.update({k: after[k] - n for k, n in before.items()
                     if after[k] != n})

    def replayed(self, name: str, rise: Dict[Tuple[str, str], int]) -> None:
        """A replay of program ``name``: the launch counters credited
        with its capture's ``rise``."""
        now = launch_counts()
        set_launch_counts({k: now[k] + n for k, n in rise.items()})
        self.replays[name] += 1


#: device index -> its capture stream, shared by every engine there
_capture_streams: Dict[int, "torch.cuda.Stream"] = {}


class CudaGraphs:
    """The capture backend on the card: one graph memory pool, shared
    by the graphs of one engine, and the device's capture stream."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got "
                             f"{self.device}")
        idx = (self.device.index if self.device.index is not None
               else torch.cuda.current_device())
        if idx not in _capture_streams:
            _capture_streams[idx] = torch.cuda.Stream(idx)
        self.stream = _capture_streams[idx]
        self.pool = torch.cuda.graph_pool_handle()
        self._open: Dict[int, tuple] = {}     # thread -> open capture

    def fork(self) -> None:
        """Order the capture stream after the current stream's work."""
        self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def join(self) -> None:
        """Order the current stream's next work after the capture
        stream's."""
        torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def on_stream(self):
        """The capture stream as the calling thread's current stream on
        this device (a context)."""
        return torch.cuda.stream(self.stream)

    def warm(self, fn: Callable):
        """``fn()`` eagerly on the capture stream, ordered after the
        current stream's work and before its next: whatever it caches
        by stream (the paged kernel's counter buffer, cuBLAS's
        workspace) is then made outside any capture."""
        self.fork()
        with self.on_stream():
            out = fn()
        self.join()
        return out

    def capture(self, fn: Callable):
        """Capture ``fn()`` (nothing runs): returns (replay, the static
        outputs)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device):
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                out = fn()
        return graph.replay, out

    # a capture in pieces (serve/parallel.py's tensor-parallel
    # programs): the calling thread opens one, runs work, closes it
    def begin(self) -> None:
        """Open a capture on the capture stream in the calling thread
        (into this backend's pool); ``end`` closes it."""
        graph = torch.cuda.CUDAGraph()
        ctx = self.on_stream()
        ctx.__enter__()
        try:
            graph.capture_begin(pool=self.pool)
        except BaseException:
            ctx.__exit__(None, None, None)
            raise
        self._open[threading.get_ident()] = (graph, ctx)

    def end(self) -> Callable:
        """Close the calling thread's capture: returns its replay."""
        graph, ctx = self._open.pop(threading.get_ident())
        try:
            graph.capture_end()
        finally:
            ctx.__exit__(None, None, None)
        return graph.replay

    def abandon(self) -> None:
        """Close the calling thread's capture, if one is open, after an
        error (the error is the one raised)."""
        if threading.get_ident() in self._open:
            try:
                self.end()
            except Exception:             # noqa: BLE001 - already failing
                pass


@dataclasses.dataclass
class _Graph:
    replay: Callable
    out: object                       # the graph's static outputs
    inputs: List[torch.Tensor]        # its static per-dispatch inputs
    rise: Dict[Tuple[str, str], int]  # launch counters a replay adds


def split_inputs(state: dict, inputs, names=None
                 ) -> Tuple[List[str], List[torch.Tensor]]:
    """The per-dispatch tensors of a call: the state entries ``names``
    (default: every entry but the pools, sorted by name), then the
    positional inputs."""
    if names is None:
        names = sorted(k for k in state if k not in POOL_KEYS)
    tensors = [state[k] for k in names] + list(inputs)
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"a graphed program takes tensors, got "
                            f"{type(t).__name__}")
    return list(names), tensors


def nest_map(fn: Callable, tree):
    """A nest of dicts (rebuilt in sorted-key order), lists and tuples
    anew, ``fn`` over its tensors; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: nest_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(nest_map(fn, x) for x in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def tensors_of(tree) -> List[torch.Tensor]:
    """The tensors of a nest (``nest_map``'s order): what a graph reads
    by address."""
    out: List[torch.Tensor] = []
    nest_map(out.append, tree)
    return out


def graph_key(by_address, tensors) -> tuple:
    """A graph's key: the address, shape, dtype and device of every
    tensor it reads by address, and the shape, dtype and device of its
    per-dispatch inputs."""
    def sig(t):
        return (tuple(t.shape), t.dtype, t.device)
    return (tuple((t.data_ptr(), *sig(t)) for t in by_address),
            tuple(sig(t) for t in tensors))


class CompiledProgram:
    """One serving program ``fn(params, state, *inputs) -> (out,
    state)`` of one engine, a CUDA graph a key (see the module
    docstring).  A replay returns the graph's static outputs, which are
    valid until the next replay of that key (the engine reads them at
    once, ``scheduler._host``), and the caller's own ``state``.

    ``state_inputs``: the state entries copied into the graph's static
    buffers at each call; every other tensor of the state is read by
    address.  Default: every entry but the page pools (``POOL_KEYS``),
    the paged programs' layout; the lockstep decode passes ``("pos",)``
    (its whole cache is read by address, ``step.make_lockstep_step``)."""

    def __init__(self, name: str, fn: Callable, backend,
                 stats: GraphStats, state_inputs=None):
        self.name = name
        self.fn = fn
        self.backend = backend
        self.stats = stats
        self.state_inputs = state_inputs
        self._graphs: Dict[tuple, _Graph] = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, params, state, *inputs):
        names, tensors = split_inputs(state, inputs, self.state_inputs)
        key = graph_key(tree_leaves(params) + tensors_of(
            {k: v for k, v in state.items() if k not in names}), tensors)
        g = self._graphs.get(key)
        if g is None:
            result = self.backend.warm(
                lambda: self.fn(params, state, *inputs))
            self._graphs[key] = self._capture(params, state, names, tensors)
            return result
        for static, t in zip(g.inputs, tensors):
            static.copy_(t)
        g.replay()
        self.stats.replayed(self.name, g.rise)
        return g.out, state

    def _capture(self, params, state, names, tensors) -> _Graph:
        static = [t.clone() for t in tensors]
        st = {k: v for k, v in state.items() if k not in names}
        st.update(zip(names, static))
        args = static[len(names):]
        with self.stats.capturing(self.name) as rise:
            replay, out = self.backend.capture(
                lambda: self.fn(params, st, *args)[0])
        return _Graph(replay, out, static, rise)


class GraphedPrograms:
    """The paged programs of one engine as ``CompiledProgram``s over
    ``programs``' plain functions, with the engine's own capture
    backend (its memory pool)."""

    def __init__(self, programs, backend):
        stats = programs.graph_stats
        self.decode = CompiledProgram("decode", programs.decode, backend,
                                      stats)
        self.chunk = CompiledProgram("chunk", programs.chunk, backend, stats)
        self.verify = CompiledProgram("verify", programs.verify, backend,
                                      stats)
        self.fused = CompiledProgram("fused", programs.fused, backend, stats)

    def graphs(self) -> Dict[str, int]:
        """Graphs held, by program."""
        return {p.name: len(p) for p in (self.decode, self.chunk,
                                         self.verify, self.fused)}
