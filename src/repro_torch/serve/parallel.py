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
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..models.base import flatten_specs
from ..tree import tree_items
from .step import (ServePrograms, make_chunk_prefill_step, make_fused_step,
                   make_paged_decode_step, make_verify_step)

__all__ = ["TPServePrograms", "ShardedPages", "make_tp_devices",
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

    def hook(self, i: int) -> Callable:
        def gather(x, dim: int):
            n = len(self.devices)
            key = self._seq[i]
            self._seq[i] += 1
            self._pieces.setdefault(key, [None] * n)[i] = x
            self._pass(i)
            self._wait(i)
            # every shard has put its piece of gather ``key`` by now
            pieces = self._pieces[key]
            self._unread[key] = self._unread.get(key, n) - 1
            if not self._unread[key]:
                del self._pieces[key], self._unread[key]
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
    signatures, ``prepare_params`` / ``prepare_pages``), so
    ``ServeEngine`` takes either, and N router replicas share one.

    ``devices``: one device a shard, by name (a device may be named
    more than once); default ``make_tp_devices(tp)``."""

    def __init__(self, model, *, tp: Optional[int] = None,
                 devices: Optional[Sequence] = None):
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
        self.decode = self._program(make_paged_decode_step)
        self.chunk = self._program(make_chunk_prefill_step)
        self.verify = self._program(make_verify_step)
        self.fused = self._program(make_fused_step)
        self._params_cache: Dict[int, tuple] = {}

    #: the sharded programs run eagerly: a graph would have to capture
    #: the shards' threads and their gathers (ROADMAP Queue 1, 11b)
    graphs = False

    def for_engine(self):
        """The programs one engine dispatches: this bundle, eager."""
        return self

    def map_shards(self, fn: Callable, params, state, *args) -> list:
        """``fn(local_model, gather, shard_params, shard_state,
        *shard_args)`` run on every shard as one program call; returns
        each shard's result in mesh order.  ``params`` is
        ``prepare_params``'s output; ``state`` a page state whose pools
        are ``ShardedPages`` (its other entries and ``args`` are
        replicated onto each shard's device)."""
        bodies = []
        for i, (m, dev) in enumerate(zip(self._locals, self.devices)):
            st = {k: (v.shards[i] if isinstance(v, ShardedPages)
                      else v.to(dev)) for k, v in state.items()}
            a = [x.to(dev) for x in args]
            bodies.append(lambda m=m, i=i, st=st, a=a: fn(
                m, self._mesh.hook(i), params[i], st, *a))
        return self._mesh.run(bodies)

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
