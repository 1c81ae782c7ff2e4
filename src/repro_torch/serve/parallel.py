"""Tensor-parallel serving: the paged decode / verify / chunked-prefill /
fused programs sharded over ``tp`` devices — the port's counterpart of
``repro.serve.parallel``.

One engine, its KV memory and its attention arithmetic split across
devices, laid out so that the sharded engine is **bit-identical** to
the single-device one:

* **What is sharded.**  Attention heads: ``wq wk wv`` (and their biases)
  on their last (head output) dimension, so shard i computes heads
  ``[i H/tp, (i+1) H/tp)`` and KV heads ``[i KVH/tp, (i+1) KVH/tp)``;
  the paged KV cache splits the same way, ``(L, P, ps, KVH/tp, Dh)``
  per shard (``ShardedPages``), which is the memory scaling that
  motivates TP serving.  The FFN hidden dim (``wg wu``, GELU's ``w1
  b1``) splits alike.
* **What is replicated.**  Page tables, lengths, tokens, norms, the
  embedding and head, and the projections contracted over a sharded
  dim (``wo``, ``wd`` / ``w2``): every shard holds the whole residual
  stream and computes the logits.  The engine takes its tokens from
  shard 0.
* **Why it is bitwise.**  No cross-shard reduction ever runs.  Each
  shard's operations are the head / hidden slice of the single-device
  ones (the dataflow GEMM forms a column from 128-deep k tiles added in
  ascending k, whatever the columns beside it; attention is computed
  head by head), and the only collective is a gather, a concatenation
  in mesh order placed just before the replicated ``wo`` / ``wd``
  (``components._tp_gather_heads``).

**One controller over a list of shard devices** (the reference's own
model: one process, a ``shard_map`` over a mesh).  Shard i keeps its
parameters and pages on ``devices[i]`` and runs the *unchanged* model
code over a shard-local view (``DecoderLM`` over a config whose
``n_heads``, ``n_kv_heads`` and ``d_ff`` are divided by tp).  A program
call runs each shard's step in its own thread; the threads take turns,
one running at a time in mesh order, and hand the turn on at each
gather, so every shard reaches gather g before any reads it.  Work is
issued to the devices asynchronously, so shards on distinct cards
overlap on the devices while their host code takes turns.  Each thread
runs with its shard's card as the current device (the kernels launch
there); a gather copies the other shards' pieces card to card, ordered
after the work that wrote them on their cards' streams.  Host-side
scheduling (``scheduler.py``, ``kv_cache.py``: allocator, prefix trie,
COW, speculation) is untouched: page ids are device-agnostic, and a
page copy copies in every shard.

On the card an engine replays the programs as CUDA graphs in pieces
cut at the gathers (``TPGraphedPrograms``, ``PiecewiseProgram``): the
port's counterpart of the reference's ``jax.jit`` over its
``shard_map``.  A gather is no collective but peer copies (a
``torch.cat`` of the pieces on the calling shard's device), so a
capture has to leave out the copies, not a collective: each shard's
segment between two gathers is one graph, and the copies run between
the replays from one host thread.

``make_tp_devices(tp)`` takes the first ``tp`` CUDA devices and raises
when there are fewer.  Shards share a device only when the caller names
it: ``TPServePrograms(model, devices=["cuda:0", "cuda:0"])`` (one card,
the shards time-sharing it) or ``["cpu", "cpu"]`` (the tests).

Scope, as the reference's: the paged family with dense FFNs
(``supports_paged_decode`` and no MoE); tp must divide ``n_heads``,
``n_kv_heads`` and ``d_ff``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..models.base import flatten_specs
from ..tree import tree_items, tree_leaves
from .compiled import (POOL_KEYS, CudaGraphs, GraphStats, graph_key,
                       split_inputs)
from .step import (ServePrograms, make_chunk_prefill_step, make_fused_step,
                   make_paged_decode_step, make_verify_step)

__all__ = ["TPServePrograms", "TPGraphedPrograms", "ShardedPages",
           "make_tp_devices",
           "validate_tp", "serve_tp_spec", "SERVE_TP_SHARDED_LEAVES"]

#: parameter leaves the serving layout shards, always on their LAST
#: dim (the projection output): wq / wk / wv and their biases by heads,
#: wg / wu (GELU's w1 / b1) by the FFN hidden dim.  Everything
#: contracted over a sharded dim (wo, wd / w2, the embedding and head,
#: norms) stays whole and reads a gathered activation instead.
SERVE_TP_SHARDED_LEAVES = frozenset(
    {"wq", "wk", "wv", "bq", "bk", "bv", "wg", "wu", "w1", "b1"})

#: the KV-head axis of a page pool (L, P, ps, KVH, Dh)
_HEAD_AXIS = -2


def serve_tp_spec(leaf_name: str, ndim: int) -> Optional[int]:
    """The dim of one parameter leaf that the serving layout shards
    (its last), or None: replicated (``sharding/rules.py:
    serve_tp_spec`` of the reference)."""
    return ndim - 1 if leaf_name in SERVE_TP_SHARDED_LEAVES else None


def make_tp_devices(tp: int) -> List[torch.device]:
    """The first ``tp`` CUDA devices (the reference's ``make_tp_mesh``);
    raises when fewer are visible.  Shards never share a device here:
    name the devices to co-locate them."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if tp > n:
        raise ValueError(f"tp={tp} exceeds {n} visible CUDA devices (to "
                         "put several shards on one device, name the "
                         "devices: TPServePrograms(model, devices=[...]))")
    return [torch.device("cuda", i) for i in range(tp)]


def validate_tp(model, tp: int) -> None:
    """The reference's refusals, message for message."""
    cfg = model.cfg
    if not model.supports_paged_decode():
        raise ValueError(f"{cfg.name}: tensor-parallel serving covers "
                         "the paged-decode family only")
    if cfg.moe is not None:
        raise ValueError(f"{cfg.name}: MoE FFNs run their own "
                         "shard_map (components.moe_block), which "
                         "cannot nest inside the serving TP program")
    for dim, v in (("n_heads", cfg.n_heads),
                   ("n_kv_heads", cfg.n_kv_heads), ("d_ff", cfg.d_ff)):
        if v % tp:
            raise ValueError(f"{cfg.name}: tp={tp} does not divide "
                             f"{dim}={v}")


def _local_model(model, tp: int, device):
    """Shard-local view: the same model class over a config whose
    sharded dims are divided by tp, on the shard's device."""
    cfg = model.cfg
    local = dataclasses.replace(
        cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
        d_ff=cfg.d_ff // tp)
    return type(model)(local, device=device)


class ShardedPages:
    """A page pool split on its KV-head axis, one tensor a shard.
    Indexing indexes every shard; assigning a ``ShardedPages`` assigns
    shard by shard, so ``kv_cache._copy_page`` (``pages[:, dst] =
    pages[:, src]``, a prefix COW) copies the page in every shard."""

    def __init__(self, shards: Sequence[torch.Tensor]):
        self.shards = list(shards)

    def __getitem__(self, idx) -> "ShardedPages":
        return ShardedPages([s[idx] for s in self.shards])

    def __setitem__(self, idx, value: "ShardedPages") -> None:
        for s, v in zip(self.shards, value.shards):
            s[idx] = v


class _Abort(Exception):
    """Another shard of the call raised."""


class _ShardMesh:
    """Runs one callable a shard, each in its own thread, the threads
    taking turns in mesh order; ``hook(i)`` is shard i's gather.  One
    call at a time (a lock), so engines sharing one bundle take turns
    too."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self._lock = threading.Lock()
        self._turns: List[threading.Semaphore] = []
        self._pieces: Dict[int, list] = {}
        self._unread: Dict[int, int] = {}
        self._seq: List[int] = []
        self._errors: List[BaseException] = []

    def _pass(self, i: int) -> None:
        self._turns[(i + 1) % len(self.devices)].release()

    def _wait(self, i: int) -> None:
        self._turns[i].acquire()
        if self._errors:
            raise _Abort

    def exchange(self, i: int, x) -> tuple:
        """Shard i's turn at its next gather: puts its piece ``x``,
        hands the turn on and waits for it to come back, by when every
        shard has put its piece.  Returns (the gather's number in the
        call, every shard's piece in mesh order)."""
        n = len(self.devices)
        key = self._seq[i]
        self._seq[i] += 1
        self._pieces.setdefault(key, [None] * n)[i] = x
        self._pass(i)
        self._wait(i)
        pieces = self._pieces[key]
        self._unread[key] = self._unread.get(key, n) - 1
        if not self._unread[key]:
            del self._pieces[key], self._unread[key]
        return key, pieces

    def hook(self, i: int) -> Callable:
        def gather(x, dim: int):
            _, pieces = self.exchange(i, x)
            return torch.cat([p.to(x.device) for p in pieces], dim)
        return gather

    def run(self, bodies: Sequence[Callable]) -> list:
        n = len(self.devices)
        grad = torch.is_grad_enabled()
        inference = torch.is_inference_mode_enabled()
        out: list = [None] * n

        def shard(i):
            dev = self.devices[i]
            try:
                self._wait(i)
                with torch.inference_mode(inference), \
                        torch.set_grad_enabled(grad), \
                        (torch.cuda.device(dev) if dev.type == "cuda"
                         else contextlib.nullcontext()):
                    out[i] = bodies[i]()
            except _Abort:
                return
            except BaseException as e:    # noqa: BLE001 - re-raised below
                self._errors.append(e)
                for t in self._turns:
                    t.release()
                return
            self._pass(i)

        with self._lock:
            self._turns = [threading.Semaphore(0) for _ in range(n)]
            self._pieces, self._unread = {}, {}
            self._seq, self._errors = [0] * n, []
            threads = [threading.Thread(target=shard, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            self._turns[0].release()
            for t in threads:
                t.join()
            if self._errors:
                raise self._errors[0]
        return out


class TPServePrograms:
    """The sharded counterpart of ``step.ServePrograms``, with its
    surface (``decode``, ``chunk``, ``verify``, ``fused`` with the same
    signatures, ``prepare_params`` / ``prepare_pages``, ``graphs`` /
    ``for_engine``), so ``ServeEngine`` takes either, and N router
    replicas share one.

    ``devices``: one device a shard, by name (a device may be named
    more than once); default ``make_tp_devices(tp)``.  ``graphs``:
    whether engines replay the programs as CUDA graphs in pieces
    (``for_engine``, ``TPGraphedPrograms``); by default where every
    shard is on a CUDA device, never on the CPU.  ``graphs=False``
    runs them eagerly on the card.  ``capture``: the graphs' backend,
    made once an engine a distinct device (default
    ``compiled.CudaGraphs``; the CPU tests pass a stand-in)."""

    def __init__(self, model, *, tp: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 graphs: Optional[bool] = None,
                 capture: Optional[Callable] = None):
        if devices is None:
            if tp is None or tp < 2:
                raise ValueError("TPServePrograms needs tp >= 2 or "
                                 "explicit devices")
            devices = make_tp_devices(tp)
        devices = [torch.device(d) for d in devices]
        if tp is not None and tp != len(devices):
            raise ValueError(f"tp={tp} with {len(devices)} devices")
        self.tp = len(devices)
        validate_tp(model, self.tp)
        self.model = model
        self.devices = devices
        self._locals = [_local_model(model, self.tp, d) for d in devices]
        #: (sharded dim or None, shard shape) of every leaf
        self._layout = {}
        for path, ps in flatten_specs(model.param_specs()):
            dim = serve_tp_spec(path[-1], len(ps.init_shape))
            shape = list(ps.init_shape)
            if dim is not None:
                shape[dim] //= self.tp
            self._layout[path] = (dim, tuple(shape))
        self._mesh = _ShardMesh(devices)
        self.makers = {"decode": make_paged_decode_step,
                       "chunk": make_chunk_prefill_step,
                       "verify": make_verify_step,
                       "fused": make_fused_step}
        for name, maker in self.makers.items():
            setattr(self, name, self._program(maker))
        self._params_cache: Dict[int, tuple] = {}
        on_card = all(d.type == "cuda" for d in devices)
        if graphs is None:
            graphs = on_card or capture is not None
        if graphs and capture is None:
            if not on_card:
                raise ValueError(f"CUDA graphs need CUDA devices; the "
                                 f"shards are on {devices}")
            capture = CudaGraphs
        self.graphs = bool(graphs)
        self._capture = capture
        self.graph_stats = GraphStats()

    def for_engine(self):
        """The programs one engine dispatches: with ``graphs``, a
        ``TPGraphedPrograms`` of the engine's own (graphs, one memory
        pool a device) over these programs; else this bundle."""
        if not self.graphs:
            return self
        return TPGraphedPrograms(self, {
            d: self._capture(d) for d in dict.fromkeys(self.devices)})

    def shard_bodies(self, fn: Callable, params, state, args,
                     hooks: Callable) -> list:
        """One body a shard: ``fn(local_model, hooks(i), shard_params,
        shard_state, *shard_args)``, its inputs placed on its device
        (the copies are issued here, on the calling thread)."""
        bodies = []
        for i, (m, dev) in enumerate(zip(self._locals, self.devices)):
            st = {k: (v.shards[i] if isinstance(v, ShardedPages)
                      else v.to(dev)) for k, v in state.items()}
            a = [x.to(dev) for x in args]
            bodies.append(lambda m=m, i=i, st=st, a=a: fn(
                m, hooks(i), params[i], st, *a))
        return bodies

    def map_shards(self, fn: Callable, params, state, *args) -> list:
        """``fn(local_model, gather, shard_params, shard_state,
        *shard_args)`` run on every shard as one program call; returns
        each shard's result in mesh order.  ``params`` is
        ``prepare_params``'s output; ``state`` a page state whose pools
        are ``ShardedPages`` (its other entries and ``args`` are
        replicated onto each shard's device)."""
        return self._mesh.run(self.shard_bodies(fn, params, state, args,
                                                self._mesh.hook))

    def _program(self, maker) -> Callable:
        def program(params, state, *args):
            outs = self.map_shards(
                lambda m, gather, p, st, *a: maker(m, gather)(p, st, *a),
                params, state, *args)
            return outs[0][0], state
        return program

    def prepare_params(self, params) -> list:
        """The parameters split by ``serve_tp_spec``, one tree a shard on
        its device, the projections cast to the compute dtype first
        (``ServePrograms.prepare_params``); cached by object identity,
        so replicas sharing one params tree share one split (the
        original is kept referenced, so a recycled id never aliases a
        dead tree)."""
        key = id(params)
        if key not in self._params_cache:
            whole = ServePrograms(self.model).prepare_params(params)
            shards: List[dict] = [{} for _ in self.devices]
            for path, leaf in tree_items(whole):
                dim, shape = self._layout[path]
                pieces = (leaf.chunk(self.tp, dim) if dim is not None
                          else [leaf] * self.tp)
                for tree, piece, dev in zip(shards, pieces, self.devices):
                    node = tree
                    for k in path[:-1]:
                        node = node.setdefault(k, {})
                    node[path[-1]] = piece.to(dev).contiguous()
                if tuple(pieces[0].shape) != shape:
                    raise ValueError(f"{'/'.join(path)}: shape "
                                     f"{tuple(leaf.shape)} does not split "
                                     f"into {self.tp} shards of {shape}")
            del whole
            self._params_cache[key] = (params, shards)
        return self._params_cache[key][1]

    def prepare_pages(self, pages) -> ShardedPages:
        """A page pool (L, P, ps, KVH, Dh) as one (L, P, ps, KVH/tp, Dh)
        tensor a shard, on its device."""
        return ShardedPages(
            piece.to(dev).contiguous() for piece, dev in zip(
                pages.chunk(self.tp, _HEAD_AXIS), self.devices))


# ------------------------------------------------------- CUDA graphs
@dataclasses.dataclass
class _Gather:
    """Gather g of a graphed call: each shard's piece (an output of its
    segment g), the dim, and one buffer a device holding the pieces
    concatenated, which that device's shards' segment g + 1 read."""
    pieces: list
    dim: int
    bufs: Dict[torch.device, torch.Tensor]

    def fill(self) -> None:
        """The buffers from the pieces (on the devices' current
        streams; torch orders a copy between two cards after the work
        on both)."""
        for dev, buf in self.bufs.items():
            if all(p.device == dev for p in self.pieces):
                torch.cat(self.pieces, self.dim, out=buf)
                continue
            at = 0
            for p in self.pieces:
                n = p.shape[self.dim]
                buf.narrow(self.dim, at, n).copy_(p)
                at += n


@dataclasses.dataclass
class _TPGraph:
    segments: List[List[Callable]]    # [shard][segment] -> its replay
    gathers: List[_Gather]
    inputs: Dict[torch.device, List[torch.Tensor]]  # static, a device
    out: object                       # shard 0's static output
    rise: Dict                        # launch counters a replay adds

    @property
    def n_segments(self) -> int:
        return len(self.segments[0])


class PiecewiseProgram:
    """One tensor-parallel program of one engine as CUDA graphs cut at
    its gathers: a key's call is, for each shard, ``gathers + 1``
    graphs (segments), the port's counterpart of the reference's
    ``jax.jit`` of its ``shard_map``.

    The first call of a key runs the program eagerly (the warm-up, on
    each device's capture stream) and then captures it: the shards'
    threads take turns as in an eager call, and at each gather a shard
    closes its open capture (the piece it gathers is an output of that
    segment), waits for the other shards' pieces, takes a static
    buffer of its device for the gathered tensor and opens the next
    segment's capture, which reads that buffer.  Only the shard that
    holds the turn captures, so one capture is open at a time (shards
    on one card share its capture stream).  A replay runs from the
    calling thread with no shard threads: the per-dispatch inputs are
    copied into each device's static buffers, then for each segment
    every shard's graph replays and the segment's gather fills the
    buffers from the pieces, on each device's current stream (the copy
    from another card ordered after the work on both, as ``copy_``
    orders it).  The key is ``compiled.graph_key`` over every shard's
    parameter leaves and pool shards.  The launch counters are kept as
    ``CompiledProgram`` keeps them (``GraphStats.capturing`` /
    ``replayed``).  On CUDA a failed capture or replay raises."""

    def __init__(self, name: str, programs: TPServePrograms, backends,
                 stats: GraphStats):
        self.name = name
        self.programs = programs
        self.maker = programs.makers[name]
        self.backends = backends          # device -> capture backend
        self.stats = stats
        self._graphs: Dict[tuple, _TPGraph] = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, params, state, *inputs):
        names, tensors = split_inputs(state, inputs)
        key = graph_key([t for p in params for t in tree_leaves(p)] + [
            s for k in POOL_KEYS if k in state for s in state[k].shards],
            tensors)
        g = self._graphs.get(key)
        if g is None:
            out = self._warm(params, state, inputs)
            self._graphs[key] = self._capture(params, state, names, tensors)
            return out, state
        for static in g.inputs.values():
            for s, t in zip(static, tensors):
                s.copy_(t)
        # the host's seconds in the segments' launches and in the
        # gathers' copies (GraphStats.host_s)
        launch_s = fill_s = 0.0
        t0 = time.perf_counter()
        for seg in range(g.n_segments):
            for shard in g.segments:
                shard[seg]()
            t1 = time.perf_counter()
            launch_s += t1 - t0
            if seg < len(g.gathers):
                g.gathers[seg].fill()
            t0 = time.perf_counter()
            fill_s += t0 - t1
        self.stats.host_s["segments"] += launch_s
        self.stats.host_s["gathers"] += fill_s
        self.stats.replayed(self.name, g.rise)
        return g.out, state

    def _warm(self, params, state, inputs):
        """The eager call, each shard's thread with every device's
        capture stream current (whatever a kernel caches by stream is
        made outside any capture)."""
        bes = list(self.backends.values())
        maker = self.maker
        bodies = self.programs.shard_bodies(
            lambda m, gather, p, st, *a: maker(m, gather)(p, st, *a)[0],
            params, state, inputs, self.programs._mesh.hook)
        for be in bes:
            be.fork()

        def streamed(body, dev):
            def run():
                with contextlib.ExitStack() as on:
                    for be in bes:
                        on.enter_context(be.on_stream())
                    if dev.type == "cuda":
                        # a stream's context makes its card current
                        on.enter_context(torch.cuda.device(dev))
                    return body()
            return run
        try:
            outs = self.programs._mesh.run([
                streamed(b, d) for b, d in zip(bodies, self.programs.devices)])
        finally:
            for be in bes:
                be.join()
        return outs[0]

    def _capture(self, params, state, names, tensors) -> _TPGraph:
        progs = self.programs
        devs = progs.devices
        static = {d: [t.to(d, copy=True) for t in tensors]
                  for d in dict.fromkeys(devs)}
        for d in static:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        segments: List[List[Callable]] = [[] for _ in devs]
        gathers: List[_Gather] = []

        def body(i):
            be, dev = self.backends[devs[i]], devs[i]
            st = {k: state[k].shards[i] for k in POOL_KEYS if k in state}
            st.update(zip(names, static[dev]))
            args = static[dev][len(names):]

            def gather(x, dim: int):
                segments[i].append(be.end())
                key, pieces = progs._mesh.exchange(i, x)
                if key == len(gathers):
                    gathers.append(_Gather(list(pieces), dim, {}))
                gt = gathers[key]
                if dev not in gt.bufs:
                    shape = list(x.shape)
                    shape[dim] = sum(p.shape[dim] for p in pieces)
                    gt.bufs[dev] = torch.zeros(shape, dtype=x.dtype,
                                               device=dev)
                be.begin()
                return gt.bufs[dev]

            def run():
                be.begin()
                try:
                    out = self.maker(progs._locals[i], gather)(
                        params[i], st, *args)[0]
                except BaseException:
                    be.abandon()
                    raise
                segments[i].append(be.end())
                return out
            return run
        with self.stats.capturing(self.name) as rise:
            outs = progs._mesh.run([body(i) for i in range(len(devs))])
        if any(len(s) != len(gathers) + 1 for s in segments):
            raise RuntimeError(f"{self.name}: the shards captured "
                               f"{[len(s) for s in segments]} segments "
                               f"for {len(gathers)} gathers")
        return _TPGraph(segments, gathers, static, outs[0], rise)


class TPGraphedPrograms:
    """The tensor-parallel programs of one engine as
    ``PiecewiseProgram``s, with the engine's own capture backend a
    device (its memory pool)."""

    def __init__(self, programs: TPServePrograms, backends):
        stats = programs.graph_stats
        for name in programs.makers:
            setattr(self, name, PiecewiseProgram(name, programs, backends,
                                                 stats))

    def graphs(self) -> Dict[str, int]:
        """Graphs held (keys), by program."""
        return {n: len(getattr(self, n))
                for n in ("decode", "chunk", "verify", "fused")}
