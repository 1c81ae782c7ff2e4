"""Serving programs: prefill, decode against a contiguous cache, and the
paged programs the engine dispatches (decode, chunked prefill,
speculative verify, fused), each ending in a greedy argmax over f32
logits — the counterpart of ``repro.serve.step``.

A "program" here is a plain function.  ``ServePrograms`` keeps the
reference's shape (one bundle per model, shared by engines) and its
``prepare_params`` / ``prepare_pages`` hooks, through which
``serve/parallel.TPServePrograms`` shards an engine.  Where the
reference jits the paged programs, an engine on the card replays them
as CUDA graphs (``for_engine``, ``serve/compiled.py``): captured once a
key, its own graphs an engine.  The paged makers take ``gather``, the
tensor-parallel hook (the reference's ``tp_axis``): None on one device.

``greedy_generate`` is the parity oracle: lockstep greedy decoding
through the contiguous-cache path (``DecoderLM.prefill`` +
``decode_step``).  Its decode attention runs the same paged kernel as
the engine (the contiguous cache viewed as one page per row), so the
engine and the oracle share one kernel and one summation order.  Where
the reference jits that decode step, the card replays it as a CUDA
graph (``ServePrograms.lockstep``: the cache read and written by
address, ``pos`` a device scalar): ``greedy_generate``, the launcher's
``--naive`` loop and the draft model's decode
(``spec.DraftModelDrafter``).  Their prefill stays eager: it runs once
a generation, so its graph would never replay.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.base import flatten_specs
from .compiled import (CompiledProgram, CudaGraphs, GraphedPrograms,
                       GraphStats, nest_map, tensors_of)

__all__ = ["greedy", "make_decode_step", "make_lockstep_step",
           "LockstepDecode", "make_paged_decode_step",
           "make_chunk_prefill_step", "make_verify_step",
           "make_fused_step", "greedy_generate", "ServePrograms",
           "projection_cast"]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Greedy token ids (int32) over the last axis of f32 logits; ties
    go to the lowest id, as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_decode_step(model) -> Callable:
    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        return greedy(logits)[:, None], cache
    return serve_step


def make_lockstep_step(step: Callable) -> Callable:
    """A lockstep decode step ``step(params, cache, tokens) -> (out,
    cache)`` (``make_decode_step``'s program, or a model's
    ``decode_step`` for its logits) as a CUDA graph takes it:
    ``(params, cache, tokens) -> ((out, pos'), cache)``.  The step runs
    over new containers of the cache's tensors; each state a recurrent
    layer replaces is then copied into the cache's own tensor (the
    attention caches are written in place already), so a graph reads
    and writes the whole cache by address.  The caller's cache is left
    as it was but for those writes; the advanced ``pos`` is an output
    (``LockstepDecode`` puts it in the cache)."""

    def lockstep(params, cache, tokens):
        work = nest_map(lambda t: t, cache)
        tok, work = step(params, work, tokens)
        held = {k: v for k, v in cache.items() if k != "pos"}
        olds = tensors_of(held)
        news = tensors_of({k: work[k] for k in held})
        if [(t.shape, t.dtype) for t in olds] != [(t.shape, t.dtype)
                                                   for t in news]:
            # e.g. an f32-compute RG-LRU's bf16 conv state of init_cache
            raise ValueError("the decode step changed a cache leaf's shape "
                             "or dtype: a graph reads the cache by address")
        for old, new in zip(olds, news):
            if new is not old:
                old.copy_(new)
        return (tok, work["pos"]), cache
    return lockstep


class LockstepDecode:
    """The lockstep decode step, ``(params, cache, tokens) -> (tokens',
    cache)`` as ``make_decode_step``'s, through a CUDA graph a cache
    (``CompiledProgram`` over ``make_lockstep_step``; its per-dispatch
    inputs are ``pos`` and the tokens, the rest of the cache is read by
    address): the first call with a cache runs eagerly and captures,
    each later one replays.  The tokens returned are the graph's static
    output, valid until the next call."""

    def __init__(self, program: CompiledProgram):
        self.program = program

    def __call__(self, params, cache, tokens):
        (tok, pos), _ = self.program(params, cache, tokens)
        cache["pos"] = pos
        return tok, cache


def make_paged_decode_step(model, gather=None) -> Callable:
    def paged_step(params, state, tokens):
        logits, state = model.decode_step_paged(params, state, tokens,
                                                gather)
        return greedy(logits)[:, None], state
    return paged_step


def make_verify_step(model, gather=None) -> Callable:
    """Row b's ``nxt[b, t]`` is the model's own greedy prediction after
    consuming tokens 0..t of the row."""
    def verify_step(params, state, tokens):
        logits, state = model.verify_step_paged(params, state, tokens,
                                                gather)
        return greedy(logits), state
    return verify_step


def make_chunk_prefill_step(model, gather=None) -> Callable:
    def chunk_step(params, state, tokens, table_rows, starts, n_valid):
        logits, state = model.prefill_chunk_paged(
            params, state, tokens, table_rows, starts, n_valid, gather)
        return greedy(logits)[:, None], state
    return chunk_step


def make_fused_step(model, gather=None) -> Callable:
    def fused_step(params, state, tokens, p_tokens, p_table_rows,
                   p_starts, p_n_valid):
        (d_logits, p_logits), state = model.fused_step_paged(
            params, state, tokens, p_tokens, p_table_rows, p_starts,
            p_n_valid, gather)
        return (greedy(d_logits), greedy(p_logits)[:, None]), state
    return fused_step


#: weights that enter ``x @ W`` in the compute dtype: attention, dense
#: MLPs (SwiGLU, GELU), an MoE block's stacked experts and its shared
#: expert, RG-LRU's and RWKV6's projections.  A weight whose spec says
#: ``f32`` (a router, RG-LRU's gates, RWKV6's decay) stays f32, and so
#: does the embedding and head (``components.unembed``).
_MATMUL_WEIGHTS = frozenset({"wq", "wk", "wv", "wo", "wg", "wu", "wd",
                             "w1", "w2", "w_gate", "w_in", "w_out", "wr",
                             "wi", "tm_w1", "tm_w2"})


def projection_cast(dtype):
    """``cast(path, spec, leaf)``: the leaf in ``dtype`` if it enters
    its products in the compute dtype, else as it is.  Given to
    ``init(cast=...)`` it stores each projection so as soon as it is
    drawn: the parameters ``prepare_params`` makes, without holding
    every f32 original at once."""
    def cast(path, spec, leaf):
        proj = (path[0] != "embed" and path[-1] in _MATMUL_WEIGHTS
                and not spec.f32)
        return leaf.to(dtype) if proj else leaf
    return cast


class ServePrograms:
    """The serving programs of one model, shared by every engine built
    on it.

    ``graphs``: whether engines replay the paged programs as CUDA
    graphs (``for_engine``); by default on a CUDA model, never on the
    CPU.  ``graphs=False`` runs them eagerly on the card, and asking for
    graphs on the CPU raises.  ``capture``: the graphs' backend, made
    once an engine from the model's device (default
    ``compiled.CudaGraphs``; the CPU tests pass a stand-in)."""

    tp = 1

    def __init__(self, model, graphs: Optional[bool] = None,
                 capture: Optional[Callable] = None):
        self.model = model
        self.decode = make_paged_decode_step(model)
        self.chunk = make_chunk_prefill_step(model)
        self.verify = make_verify_step(model)
        self.fused = make_fused_step(model)
        on_card = torch.device(model.device).type == "cuda"
        if graphs is None:
            graphs = on_card or capture is not None
        if graphs and capture is None:
            if not on_card:
                raise ValueError(f"CUDA graphs need a CUDA model; this one "
                                 f"is on {model.device}")
            capture = CudaGraphs
        self.graphs = bool(graphs)
        self._capture = capture
        self.graph_stats = GraphStats()

    def for_engine(self):
        """The programs one engine dispatches: with ``graphs``, a
        ``GraphedPrograms`` of the engine's own (graphs, memory pool)
        over these functions; else this bundle."""
        if not self.graphs:
            return self
        return GraphedPrograms(self, self._capture(self.model.device))

    def lockstep(self) -> Callable:
        """The lockstep decode step of one user (a generation, a
        drafter): with ``graphs`` a ``LockstepDecode`` with its own
        graphs and memory pool, one graph a cache; else
        ``make_decode_step``'s plain program."""
        if not self.graphs:
            return make_decode_step(self.model)
        return LockstepDecode(CompiledProgram(
            "lockstep", make_lockstep_step(make_decode_step(self.model)),
            self._capture(self.model.device), self.graph_stats,
            state_inputs=("pos",)))

    def prepare_params(self, params):
        """Cast the projection weights to the compute dtype once, where
        every call would otherwise cast them again (the cast is exact
        and the same either way; norms, biases, the f32 products and
        the f32 embedding and head are left as they are)."""
        cast = projection_cast(self.model.dtype)
        out: dict = {}
        for path, spec in flatten_specs(self.model.param_specs()):
            leaf = params
            for k in path:
                leaf = leaf[k]
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = cast(path, spec, leaf)
        return out

    def prepare_pages(self, pages):
        """The page pool as the programs take it: as it is on one
        device."""
        return pages


def greedy_generate(model, params, batch, n_steps: int,
                    cache_len: int, programs=None) -> torch.Tensor:
    """Lockstep greedy decoding of a prompt batch for ``n_steps``
    tokens: a (B, S) token array, or the reference's batch dict
    (``tokens`` and, for the families that take them, ``frames``,
    ``patch_embeds``, ``mrope_positions``).  Returns (B, n_steps) int32
    on the model's device.  The decode steps run ``programs.lockstep()``
    (default ``ServePrograms(model)``: on the card one CUDA graph,
    captured at the first step and replayed ``n_steps - 2`` times;
    ``ServePrograms(model, graphs=False)`` runs them eagerly); the
    prefill runs eagerly."""
    if not isinstance(batch, dict):
        batch = {"tokens": torch.as_tensor(batch, device=model.device)}
    max_len = max(cache_len, batch["tokens"].shape[1] + n_steps)
    last, cache = model.prefill(params, batch, max_len=max_len)
    step = (programs or ServePrograms(model)).lockstep()
    tok = greedy(last)[:, None]
    out = [tok]
    for _ in range(n_steps - 1):
        tok, cache = step(params, cache, tok)
        out.append(tok.clone())
    return torch.cat(out, dim=1)
